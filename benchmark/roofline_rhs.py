"""The yardstick of a multi-RHS SpMM: the least bytes of Y = A·X for a CSR
A and R right-hand sides, in float32, against ``benchmark/roofline.py``'s
peak.

The bytes depend on the matrix and R alone, whatever kernel serves the
call: 4 B per value and 4 B per column index for each nonzero, 4 B per row
pointer (nrows + 1), X (ncols × R) read once and Y (nrows × R) written
once.
"""

from __future__ import annotations

__all__ = ["least_csr_spmm_bytes"]


def least_csr_spmm_bytes(nrows: int, ncols: int, nnz: int, R: int) -> int:
    """float32 values, X and Y, int32 columns and row pointers."""
    return nnz * 8 + (nrows + 1) * 4 + R * (ncols + nrows) * 4

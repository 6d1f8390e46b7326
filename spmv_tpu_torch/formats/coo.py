"""COO — coordinate format.

Counterpart of ``spmv_tpu/formats/coo.py`` (reference: ``coo.c`` +
``kernels/Coo.cl``). The reference kernel scatter-adds one lane per
nonzero with a hand-rolled CAS ``atomic_add`` (``Coo.cl:4-22``), whose
summation order changes from run to run. Here the triplets are sorted by
``(row, col)`` (a stable lexsort) into the CSR tile plan, and the
deterministic kernels of ``kernels.engines`` sum them. Duplicate
``(row, col)`` entries stay separate nonzeros and so sum, as in raw
MatrixMarket semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, X_to_device, x_to_device
from spmv_tpu_torch.formats.base import CsrPlan, build_csr_plan, csr_ptr
from spmv_tpu_torch.kernels.engines import (segmented_spmv,
                                            segmented_spmv_multi)

__all__ = ["COOMatrix"]


@dataclass
class COOMatrix:
    """Host triplets in their original order + the device plan."""

    nrows: int
    ncols: int
    rows: np.ndarray  # original order, 0-based
    cols: np.ndarray
    vals: np.ndarray
    dev: DevCsr = field(repr=False)
    plan: CsrPlan = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 device) -> "COOMatrix":
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        plan = build_csr_plan(nrows, ncols, csr_ptr(rows[order], nrows),
                              cols[order], vals[order])
        return cls(nrows=nrows, ncols=ncols, rows=rows, cols=cols, vals=vals,
                   dev=DevCsr.from_plan(plan, device), plan=plan)

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plan on the device."""
        return self.dev.stream_bytes

    @property
    def nnz(self) -> int:
        return self.rows.size

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` in the original input order (duplicates
        kept), as fresh copies."""
        return (np.array(self.rows, np.int64, copy=True),
                np.array(self.cols, np.int64, copy=True),
                np.array(self.vals, copy=True))

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the plan's device."""
        return segmented_spmv(self.dev, x_to_device(x, self.ncols, self.dev.device))

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``, in
        one multi-RHS pass over the plan (``api.spmm`` takes any R)."""
        return segmented_spmv_multi(self.dev, X_to_device(X, self.ncols, self.dev.device))

    __matmul__ = matvec

"""Symmetric storage: y = A·x with A kept as its lower triangle.

Counterpart of ``spmv_tpu/sym.py``. The container keeps the stored
triangle (MatrixMarket symmetric semantics: each off-diagonal entry
stands for both (r, c) and (c, r); entries given in the upper triangle are
folded onto the lower) and computes

    y = (L + D)·x  +  Lᵀ·x

as two passes of the segmented engine over two CSR plans: L + D, and the
strict triangle with rows and columns swapped (Lᵀ), then one add. Each
pass only gathers x and writes its own y, so no float atomics are needed;
a single pass that also scattered each entry's transpose would need them.
The device streams both plans, as many nonzeros as the expanded matrix
(2m + d); what the triangle saves is host work: triplets, parse,
conversion and the plan cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, X_to_device, x_to_device
from spmv_tpu_torch.formats.base import CsrPlan, build_csr_plan, csr_ptr
from spmv_tpu_torch.kernels.engines import segmented_spmv, segmented_spmv_multi

__all__ = ["SymmetricMatrix"]


def _csr_plan(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> CsrPlan:
    """CSR plan of triplets, sorted as ``CSRMatrix.from_coo`` sorts them."""
    order = np.lexsort((cols, rows))
    return build_csr_plan(n, n, csr_ptr(rows[order], n), cols[order], vals[order])


@dataclass
class SymmetricMatrix:
    """Symmetric operator from triangle storage: two segmented passes."""

    nrows: int
    ncols: int
    tri_rows: np.ndarray  # stored (lower-triangle) triplets, 0-based
    tri_cols: np.ndarray
    tri_vals: np.ndarray
    spill_nnz: int  # strict-triangle count: the Lᵀ pass runs where it is > 0
    dev: DevCsr = field(repr=False)  # L + D
    dev_spill: DevCsr = field(repr=False)  # Lᵀ
    plan: CsrPlan = field(repr=False)
    spill_plan: CsrPlan = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 device) -> "SymmetricMatrix":
        if nrows != ncols:
            raise ValueError("symmetric storage requires a square matrix")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        up = rows < cols
        r = np.where(up, cols, rows)
        c = np.where(up, rows, cols)
        strict = r > c
        plan = _csr_plan(nrows, r, c, vals)
        spill_plan = _csr_plan(nrows, c[strict], r[strict], vals[strict])
        return cls(nrows=nrows, ncols=ncols, tri_rows=r, tri_cols=c,
                   tri_vals=vals, spill_nnz=int(strict.sum()),
                   dev=DevCsr.from_plan(plan, device),
                   dev_spill=DevCsr.from_plan(spill_plan, device),
                   plan=plan, spill_plan=spill_plan)

    @property
    def nnz(self) -> int:
        """Nonzeros of the operator (the expanded form): the work done."""
        return self.tri_rows.size + self.spill_nnz

    @property
    def stored_nnz(self) -> int:
        return self.tri_rows.size

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of both plans on the device."""
        return self.dev.stream_bytes + self.dev_spill.stream_bytes

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Expanded (general-form) triplets, as fresh copies."""
        strict = self.tri_rows > self.tri_cols
        return (np.concatenate([self.tri_rows, self.tri_cols[strict]]),
                np.concatenate([self.tri_cols, self.tri_rows[strict]]),
                np.concatenate([self.tri_vals, self.tri_vals[strict]]))

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the plans' device: the engine on
        L + D, then on Lᵀ unless the triangle is diagonal only, then one
        add."""
        xt = x_to_device(x, self.ncols, self.dev.device)
        y = segmented_spmv(self.dev, xt)
        if self.spill_nnz == 0:
            return y
        return y + segmented_spmv(self.dev_spill, xt)

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``: one
        multi-RHS pass (K8 + K9) over each plan, then one add."""
        Xt = X_to_device(X, self.ncols, self.dev.device)
        Y = segmented_spmv_multi(self.dev, Xt)
        if self.spill_nnz == 0:
            return Y
        return Y + segmented_spmv_multi(self.dev_spill, Xt)

    __matmul__ = matvec

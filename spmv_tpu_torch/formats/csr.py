"""CSR — compressed sparse row.

Counterpart of ``spmv_tpu/formats/csr.py`` (reference: ``csr.c`` +
``kernels/Csr.cl``). ptr is built with bincount + cumsum, so empty rows
and any input order are correct by construction; the device plan is
``formats.base``'s tile schedule over the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, x_to_device
from spmv_tpu_torch.formats.base import CsrPlan, build_csr_plan, csr_ptr
from spmv_tpu_torch.kernels.engines import segmented_spmv

__all__ = ["CSRMatrix"]


@dataclass
class CSRMatrix:
    nrows: int
    ncols: int
    ptr: np.ndarray  # (nrows+1,) int64
    cols: np.ndarray  # (nnz,) int32, row-major
    vals: np.ndarray  # (nnz,)
    dev: DevCsr = field(repr=False)
    plan: CsrPlan = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 device) -> "CSRMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols)
        order = np.lexsort((cols, rows))
        return cls.from_csr(nrows, ncols, csr_ptr(rows[order], nrows),
                            cols[order], np.asarray(vals)[order], device=device)

    @classmethod
    def from_csr(cls, nrows: int, ncols: int, ptr, cols, vals, *,
                 device) -> "CSRMatrix":
        plan = build_csr_plan(nrows, ncols, ptr, cols, vals)
        return cls(nrows=nrows, ncols=ncols,
                   ptr=np.asarray(ptr, dtype=np.int64),
                   cols=np.asarray(cols, dtype=np.int32),
                   vals=np.asarray(vals),
                   dev=DevCsr.from_plan(plan, device), plan=plan)

    @property
    def nnz(self) -> int:
        return self.cols.size

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` triplets in CSR (row-major) order, as
        fresh copies."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         np.diff(self.ptr))
        return (rows, np.array(self.cols, np.int64, copy=True),
                np.array(self.vals, copy=True))

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the plan's device."""
        return segmented_spmv(self.dev, x_to_device(x, self.ncols, self.dev.device))

    __matmul__ = matvec

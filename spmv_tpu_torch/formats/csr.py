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

from spmv_tpu_torch.device import DevCsr, X_to_device, x_to_device
from spmv_tpu_torch.formats.base import (CsrPlan, build_csr_plan, csr_ptr,
                                         is_row_major)
from spmv_tpu_torch.kernels.engines import (segmented_spmv,
                                            segmented_spmv_multi)

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
        """Triplets in (row, col) order are taken as they are (no sort, no
        copy: the order a stable sort would give, so the same plan); any
        other order is sorted first. Taken as they are, int32 columns and
        the values stay the caller's arrays (as ``from_csr``'s do): the
        container's host ``cols``/``vals`` and its plan share their memory
        (on the CPU its tensors too), so a caller that changes them
        afterwards changes the container. A card's tensors are copies."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if not is_row_major(rows, cols):
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        return cls.from_csr(nrows, ncols, csr_ptr(rows, nrows), cols, vals,
                            device=device)

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
    def stream_bytes(self) -> int:
        """Exact bytes of the plan on the device."""
        return self.dev.stream_bytes

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

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``, in
        one multi-RHS pass over the plan (``api.spmm`` takes any R)."""
        return segmented_spmv_multi(self.dev, X_to_device(X, self.ncols, self.dev.device))

    __matmul__ = matvec

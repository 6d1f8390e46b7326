"""CMRS — compressed multi-row storage (Koza et al., arXiv:1203.2946).

Counterpart of ``spmv_tpu/formats/cmrs.py`` (reference: ``cmrs.c`` +
``kernels/Cmrs.cl``). Strips of ``height`` consecutive rows (height 8,
``cmrs.c:46``); nonzeros stay in CSR order, with per-strip ranges in
``strip_ptr`` and a per-nonzero ``row_in_strip`` id. The reference kernel
accumulates into uninitialized local memory (``Cmrs.cl:18``) and writes
out of bounds when ``rows % height != 0`` (``Cmrs.cl:38-41``); here the
global rows ``strip·height + row_in_strip`` feed the same CSR tile plan
and kernels as CSR, which have neither fault.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, X_to_device, x_to_device
from spmv_tpu_torch.formats.base import CsrPlan, build_csr_plan, cdiv, csr_ptr
from spmv_tpu_torch.kernels.engines import (segmented_spmv,
                                            segmented_spmv_multi)

__all__ = ["CMRSMatrix", "DEFAULT_HEIGHT"]

DEFAULT_HEIGHT = 8  # cmrs.c:46


@dataclass
class CMRSMatrix:
    nrows: int
    ncols: int
    height: int
    strip_ptr: np.ndarray  # (nstrips+1,) int64 — nnz offset per strip
    row_in_strip: np.ndarray  # (nnz,) int8 — row id within strip
    cols: np.ndarray  # (nnz,) int32, CSR order
    vals: np.ndarray  # (nnz,)
    dev: DevCsr = field(repr=False)
    plan: CsrPlan = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 height: int = DEFAULT_HEIGHT, device) -> "CMRSMatrix":
        _check_height(height)
        rows = np.asarray(rows, dtype=np.int64)
        order = np.lexsort((np.asarray(cols), rows))
        rows_s = rows[order]
        strip_ptr = csr_ptr(rows_s // height, cdiv(max(nrows, 1), height))
        return cls.from_cmrs(
            nrows, ncols, strip_ptr, (rows_s % height).astype(np.int8),
            np.asarray(cols)[order], np.asarray(vals)[order], height=height,
            device=device)

    @classmethod
    def from_cmrs(cls, nrows: int, ncols: int, strip_ptr, row_in_strip, cols,
                  vals, *, height: int = DEFAULT_HEIGHT,
                  device) -> "CMRSMatrix":
        """Build from the format's own arrays: global rows are
        ``strip·height + row_in_strip``, re-sorted within strips so the
        plan sees rows in order."""
        _check_height(height)
        strip_ptr = np.asarray(strip_ptr, dtype=np.int64)
        ris = np.asarray(row_in_strip, dtype=np.int64)
        strip_of = np.repeat(np.arange(strip_ptr.size - 1, dtype=np.int64),
                             np.diff(strip_ptr))
        rows = strip_of * height + ris
        order = np.lexsort((np.asarray(cols), rows))  # CSR order within strips
        plan = build_csr_plan(nrows, ncols, csr_ptr(rows[order], nrows),
                              np.asarray(cols)[order], np.asarray(vals)[order])
        return cls(nrows=nrows, ncols=ncols, height=height,
                   strip_ptr=strip_ptr,
                   row_in_strip=np.asarray(row_in_strip, dtype=np.int8),
                   cols=np.asarray(cols, dtype=np.int32), vals=np.asarray(vals),
                   dev=DevCsr.from_plan(plan, device), plan=plan)

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plan on the device."""
        return self.dev.stream_bytes

    @property
    def nnz(self) -> int:
        return self.cols.size

    @property
    def nstrips(self) -> int:
        return self.strip_ptr.size - 1

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` with global rows reconstructed from the
        strip arrays (``rows = strip·height + row_in_strip``)."""
        strip_of = np.repeat(np.arange(self.nstrips, dtype=np.int64),
                             np.diff(self.strip_ptr))
        rows = strip_of * self.height + self.row_in_strip.astype(np.int64)
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


def _check_height(height: int) -> None:
    # row_in_strip is int8
    if not 1 <= height <= 128:
        raise ValueError(f"height must be in [1, 128], got {height}")

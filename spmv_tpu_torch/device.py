"""Device-resident plans and the x/y helpers.

Counterparts of ``spmv_tpu/device.py:DevSeg`` and ``DevPanel``. The JAX
containers split each stream into several arrays, pack u8 index planes and
compute y window targets, all for the TPU's DMA and VMEM limits; on Hopper
a plan is the CSR arrays or the sliced-ELLPACK panel of ``formats.base``
with its tile schedule, held as int32 tensors and float32 values (float64
for the fp64-grade mode, ``x2.X2Matrix``) on an explicit ``torch.device``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from spmv_tpu_torch import trace
from spmv_tpu_torch.formats.base import CsrPlan, PanelPlan

__all__ = ["DevCsr", "DevPanel", "FUSED_STREAM_BYTES_MAX", "x_to_device",
           "y_to_numpy", "X_to_device", "Y_to_numpy"]

# Plans of at most this many bytes run the one-dispatch kernel (K3
# ``csr_spmv_fused``, K6 ``panel_spmv_fused``); larger plans run the
# two-dispatch shape (K1 + K2, K4 + K7). The JAX package's threshold
# (``spmv_tpu/device.py:68``, for both engines) was the starting point;
# PERF.md records the H100 times at the shapes ``chip_smoke.py`` runs.
FUSED_STREAM_BYTES_MAX = 4 * 1024 * 1024


def _put(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _tensor_bytes(plan) -> int:
    """Exact bytes of a device plan's tensors."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(plan, f.name) for f in fields(plan))
               if isinstance(t, torch.Tensor))


@dataclass(frozen=True)
class DevCsr:
    ptr: torch.Tensor  # (nrows+1,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,) float32, or float64 (the plan's dtype)
    tile_row0: torch.Tensor  # (ntiles+1,) int32
    carry_rows: torch.Tensor  # (ncarry,) int32
    nrows: int
    ncols: int
    tile: int
    max_row_nnz: int

    def __post_init__(self):
        # K3's published partials (``kernels.engines.segmented_spmv_fused``):
        # one int64 word per tile on a float32 CUDA plan, zeroed once here,
        # outside any CUDA-graph capture, and left 0 by every launch. Not a
        # field, so ``stream_bytes`` does not count it.
        if self.vals.device.type == "cuda" and self.vals.dtype == torch.float32:
            object.__setattr__(self, "fused_words", torch.zeros(
                self.ntiles, dtype=torch.int64, device=self.vals.device))

    @classmethod
    @trace.traced("plan.upload")
    def from_plan(cls, plan: CsrPlan, device) -> "DevCsr":
        device = torch.device(device)
        return cls(ptr=_put(plan.ptr, device), cols=_put(plan.cols, device),
                   vals=_put(plan.vals, device),
                   tile_row0=_put(plan.tile_row0, device),
                   carry_rows=_put(plan.carry_rows, device),
                   nrows=plan.nrows, ncols=plan.ncols, tile=plan.tile,
                   max_row_nnz=plan.max_row_nnz)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return self.cols.numel()

    @property
    def ntiles(self) -> int:
        return self.tile_row0.numel() - 1

    @property
    def ncarry(self) -> int:
        return self.carry_rows.numel()

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plan's tensors on the device."""
        return _tensor_bytes(self)

    @property
    def fused(self) -> bool:
        """Small plans take the one-dispatch kernel K3."""
        return self.stream_bytes <= FUSED_STREAM_BYTES_MAX


@dataclass(frozen=True)
class DevPanel:
    slice_ptr: torch.Tensor  # (nslices+1,) int32, multiples of 32
    vals: torch.Tensor  # (nslots,) float32 or float64, column-major per slice
    cols: torch.Tensor  # (nslots,) int32
    tile_slice0: torch.Tensor  # (ntiles+1,) int32
    tile_own0: torch.Tensor  # (ntiles+1,) int32: the slices each K4 tile owns
    split_slices: torch.Tensor  # (nsplit,) int32
    nrows: int
    ncols: int
    tile: int  # slice columns per K4 tile
    max_width: int

    def __post_init__(self):
        # K6's tile mode (``kernels.panel.panel_spmv_fused``): the words its
        # split slices' pieces are published in, K4's partial slots as int64
        # (2·ntiles, 32), on a float32 CUDA plan, zeroed once here, outside
        # any CUDA-graph capture, and left 0 by every launch. Not a field,
        # so ``stream_bytes`` does not count it.
        if self.vals.device.type == "cuda" and self.vals.dtype == torch.float32:
            object.__setattr__(self, "fused_words", torch.zeros(
                (2 * self.ntiles, 32), dtype=torch.int64, device=self.vals.device))

    @classmethod
    @trace.traced("plan.upload")
    def from_plan(cls, plan: PanelPlan, device) -> "DevPanel":
        device = torch.device(device)
        return cls(slice_ptr=_put(plan.slice_ptr, device, np.int32),
                   vals=_put(plan.vals, device), cols=_put(plan.cols, device),
                   tile_slice0=_put(plan.tile_slice0, device),
                   tile_own0=_put(plan.tile_own0, device),
                   split_slices=_put(plan.split_slices, device),
                   nrows=plan.nrows, ncols=plan.ncols, tile=plan.tile,
                   max_width=plan.max_width)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nslices(self) -> int:
        return self.slice_ptr.numel() - 1

    @property
    def nslots(self) -> int:
        return self.vals.numel()

    @property
    def ntiles(self) -> int:
        return self.tile_slice0.numel() - 1

    @property
    def nsplit(self) -> int:
        return self.split_slices.numel()

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plan's tensors on the device."""
        return _tensor_bytes(self)

    @property
    def fused(self) -> bool:
        """Small plans take the one-dispatch kernel K6 (the predicate of
        ``DevCsr.fused``, as the JAX engines share theirs; K6 picks its own
        mode, ``kernels.panel.fused_mode``)."""
        return self.stream_bytes <= FUSED_STREAM_BYTES_MAX


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def x_to_device(x, ncols: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (numpy, list or tensor, any real dtype) → contiguous ``dtype``
    tensor of length ``ncols`` on ``device`` (the counterpart of
    ``spmv_tpu/device.py:x_to_table``, without the TPU table padding).
    float64 is the fp64-grade mode's x, which replaces JAX's hi∥lo table
    (``x_to_table_x2``): the kernels read it whole."""
    if isinstance(x, torch.Tensor):
        xt = x.to(device=device, dtype=dtype)
    else:
        xt = torch.from_numpy(np.asarray(x, dtype=_np_dtype(dtype))).to(device)
    xt = xt.reshape(-1).contiguous()
    if xt.numel() != ncols:
        raise ValueError(f"x has {xt.numel()} entries, matrix has {ncols} columns")
    return xt


def X_to_device(X, ncols: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """X (numpy or tensor, any real dtype, any strides) → contiguous
    row-major ``dtype`` tensor of shape (ncols, R) on ``device``: the layout
    the multi-RHS kernels read, one row of R floats per column index. A
    transposed or sliced X is copied here, not refused by a kernel."""
    if isinstance(X, torch.Tensor):
        Xt = X.to(device=device, dtype=dtype)
    else:
        Xt = torch.from_numpy(np.ascontiguousarray(X, dtype=_np_dtype(dtype))).to(device)
    if Xt.dim() != 2 or Xt.shape[0] != ncols:
        raise ValueError(f"X must be ({ncols}, R), got {tuple(Xt.shape)}")
    return Xt.contiguous()


def y_to_numpy(y: torch.Tensor, nrows: int,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Device y → host array, checking its length and dtype."""
    if y.dtype != dtype or y.shape != (nrows,):
        raise ValueError(f"y must be {dtype} of shape ({nrows},), got "
                         f"{y.dtype} {tuple(y.shape)}")
    return y.cpu().numpy()


def Y_to_numpy(Y: torch.Tensor, nrows: int, R: int,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Device Y → host (nrows, R) array, checking shape and dtype."""
    if Y.dtype != dtype or Y.shape != (nrows, R):
        raise ValueError(f"Y must be {dtype} of shape ({nrows}, {R}), got "
                         f"{Y.dtype} {tuple(Y.shape)}")
    return Y.cpu().numpy()

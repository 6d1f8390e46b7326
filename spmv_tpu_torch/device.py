"""Device-resident plan and the x/y helpers.

Counterpart of ``spmv_tpu/device.py:DevSeg``. The JAX container splits
each stream into several arrays, packs u8 index planes and computes y
window targets, all for the TPU's DMA and VMEM limits; on Hopper the plan
is the CSR arrays and the tile schedule of ``formats.base``, held as int32
and float32 tensors on an explicit ``torch.device``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from spmv_tpu_torch.formats.base import CsrPlan

__all__ = ["DevCsr", "FUSED_STREAM_BYTES_MAX", "x_to_device", "y_to_numpy"]

# Plans of at most this many bytes run the one-dispatch kernel K3
# (``csr_spmv_fused``); larger plans run K1 + K2. The JAX package's
# threshold (``spmv_tpu/device.py:68``) was the starting point; PERF.md
# records the H100 times at the shapes ``chip_smoke.py`` runs.
FUSED_STREAM_BYTES_MAX = 4 * 1024 * 1024


@dataclass(frozen=True)
class DevCsr:
    ptr: torch.Tensor  # (nrows+1,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,) float32
    tile_row0: torch.Tensor  # (ntiles+1,) int32
    carry_rows: torch.Tensor  # (ncarry,) int32
    nrows: int
    ncols: int
    tile: int
    max_row_nnz: int

    @classmethod
    def from_plan(cls, plan: CsrPlan, device) -> "DevCsr":
        device = torch.device(device)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(ptr=put(plan.ptr), cols=put(plan.cols), vals=put(plan.vals),
                   tile_row0=put(plan.tile_row0),
                   carry_rows=put(plan.carry_rows),
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
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, f.name) for f in fields(self))
                   if isinstance(t, torch.Tensor))

    @property
    def fused(self) -> bool:
        """Small plans take the one-dispatch kernel K3."""
        return self.stream_bytes <= FUSED_STREAM_BYTES_MAX


def x_to_device(x, ncols: int, device) -> torch.Tensor:
    """x (numpy, list or tensor, any real dtype) → contiguous float32
    tensor of length ``ncols`` on ``device`` (the counterpart of
    ``spmv_tpu/device.py:x_to_table``, without the TPU table padding)."""
    if isinstance(x, torch.Tensor):
        xt = x.to(device=device, dtype=torch.float32)
    else:
        xt = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)
    xt = xt.reshape(-1).contiguous()
    if xt.numel() != ncols:
        raise ValueError(f"x has {xt.numel()} entries, matrix has {ncols} columns")
    return xt


def y_to_numpy(y: torch.Tensor, nrows: int) -> np.ndarray:
    """Device y → host float32 array, checking its length and dtype."""
    if y.dtype != torch.float32 or y.shape != (nrows,):
        raise ValueError(f"y must be float32 of shape ({nrows},), got "
                         f"{y.dtype} {tuple(y.shape)}")
    return y.cpu().numpy()

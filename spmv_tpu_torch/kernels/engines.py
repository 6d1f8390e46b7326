"""The segmented SpMV engine: wrappers of the three CUDA kernels, each with
its plain PyTorch version beside it.

Counterpart of ``spmv_tpu/kernels/engines.py:464-531``.

=====================  ==================  =================================
wrapper                kernel (csrc/)      replaces (spmv_tpu/kernels/)
=====================  ==================  =================================
segmented_spmv_partials  K1 seg_spmv_tiles  engines.py:414 ``_seg_kernel``
carry_fixup              K2 carry_fixup     engines.py:171 ``_scatter_kernel``
segmented_spmv_fused     K3 csr_spmv_fused  engines.py:430 ``_seg_kernel_fused``
=====================  ==================  =================================

``segmented_spmv`` picks K3 for plans of at most
``device.FUSED_STREAM_BYTES_MAX`` bytes and K1 then K2 otherwise — the
JAX engine's fused and two-dispatch shapes.

Routing: a wrapper given CPU tensors runs its plain version (``*_reference``,
which the CPU tests use); given CUDA tensors it launches its kernel or
raises. There is no fallback from one to the other. Each launch adds one
to ``LAUNCHES[kernel]``, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.formats.base import TILE_NNZ

__all__ = ["segmented_spmv", "segmented_spmv_partials", "carry_fixup",
           "segmented_spmv_fused", "segmented_spmv_partials_reference",
           "carry_fixup_reference", "segmented_spmv_fused_reference",
           "LAUNCHES", "reset_launches", "fused_lanes", "KernelError"]

# Launch counts per kernel; the plain versions never touch them.
LAUNCHES = {"seg_spmv_tiles": 0, "carry_fixup": 0, "csr_spmv_fused": 0}


class KernelError(RuntimeError):
    """A launcher returned a CUDA error code."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(dev: DevCsr, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for anything else."""
    for t in tensors:
        if t.device != dev.device:
            raise ValueError(f"tensor on {t.device}, plan on {dev.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32, got {t.dtype}")
    kind = dev.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev.device}")
    return kind == "cuda"


def _check_x(dev: DevCsr, x: torch.Tensor) -> None:
    if x.shape != (dev.ncols,):
        raise ValueError(f"x must have shape ({dev.ncols},), got {tuple(x.shape)}")


def _launch(name: str, dev: DevCsr, *args) -> None:
    """Call launcher ``name`` on the current stream of the plan's device;
    tensors pass as their data pointers."""
    from spmv_tpu_torch.kernels import _build

    lib = _build.library().lib
    with torch.cuda.device(dev.device):
        stream = torch.cuda.current_stream(dev.device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(lib, name)(*cargs, stream)
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------- K1 + K2


def segmented_spmv_partials(dev: DevCsr, x: torch.Tensor):
    """K1: ``(y, carry)``. y holds every row that lies wholly inside one
    tile (and 0 for empty rows); ``carry`` (2 slots per tile, see
    ``formats.base``) holds the partials of the rows that cross a tile
    boundary, for ``carry_fixup``."""
    _check_x(dev, x)
    if not _on_cuda(dev, x):
        return segmented_spmv_partials_reference(dev, x)
    if dev.tile != TILE_NNZ:
        raise ValueError(f"the CUDA kernel takes tile={TILE_NNZ}, plan has {dev.tile}")
    for t in (dev.cols, dev.vals):  # K1 reads 4 nonzeros per 16-byte load
        if t.data_ptr() % 16:
            raise ValueError("plan tensors must be 16-byte aligned")
    y = torch.zeros(dev.nrows, dtype=torch.float32, device=dev.device)
    carry = torch.zeros(2 * dev.ntiles, dtype=torch.float32, device=dev.device)
    if dev.nnz:  # a zero-sized grid is refused: nothing to launch
        _launch("seg_spmv_tiles", dev, dev.ptr, dev.cols, dev.vals,
                dev.tile_row0, x, y, carry, dev.nnz, dev.ntiles, dev.tile)
    return y, carry


def carry_fixup(dev: DevCsr, y: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """K2: adds each split row's partials, in tile order, into ``y``.
    Updates ``y`` in place (no second y buffer) and returns it."""
    if y.shape != (dev.nrows,) or carry.shape != (2 * dev.ntiles,):
        raise ValueError("y or carry does not match the plan")
    if not _on_cuda(dev, y, carry):
        return carry_fixup_reference(dev, y, carry)
    if dev.tile != TILE_NNZ:
        raise ValueError(f"the CUDA kernel takes tile={TILE_NNZ}, plan has {dev.tile}")
    if dev.ncarry:  # no row crosses a tile boundary: nothing to launch
        _launch("carry_fixup", dev, dev.ptr, dev.carry_rows, carry, y,
                dev.ncarry, dev.tile)
    return y


def segmented_spmv_partials_reference(dev: DevCsr, x: torch.Tensor):
    """Plain K1 on the same tile schedule: a segment per (tile, row) pair,
    summed with ``index_add_``; whole rows go to y, the head and tail
    partials to their carry slots."""
    dv = dev.device
    y = torch.zeros(dev.nrows, dtype=torch.float32, device=dv)
    carry = torch.zeros(2 * dev.ntiles, dtype=torch.float32, device=dv)
    if dev.nnz == 0:
        return y, carry
    ptr = dev.ptr.long()
    e = torch.arange(dev.nnz, device=dv)
    row = torch.searchsorted(ptr, e, right=True) - 1
    tile = e // dev.tile
    head = torch.ones(dev.nnz, dtype=torch.bool, device=dv)
    head[1:] = (row[1:] != row[:-1]) | (tile[1:] != tile[:-1])
    seg = torch.cumsum(head, 0) - 1
    prod = dev.vals * x[dev.cols.long()]
    sums = torch.zeros(int(head.sum()), dtype=torch.float32, device=dv)
    sums.index_add_(0, seg, prod)
    srow, stile = row[head], tile[head]
    rs, re = ptr[srow], ptr[srow + 1]
    ts = stile * dev.tile
    te = torch.clamp(ts + dev.tile, max=dev.nnz)
    whole = (rs >= ts) & (re <= te)
    y[srow[whole]] = sums[whole]
    slot = 2 * stile + (rs >= ts).long()  # head slot 2t, tail slot 2t+1
    carry[slot[~whole]] = sums[~whole]
    return y, carry


def carry_fixup_reference(dev: DevCsr, y: torch.Tensor,
                          carry: torch.Tensor) -> torch.Tensor:
    """Plain K2: gathers each split row's carry slots and sums them in tile
    order with ``index_add_``; updates ``y`` in place."""
    if dev.ncarry == 0:
        return y
    dv = dev.device
    r = dev.carry_rows.long()
    ptr = dev.ptr.long()
    ta = ptr[r] // dev.tile
    tb = (ptr[r + 1] - 1) // dev.tile
    counts = tb - ta + 1
    owner = torch.repeat_interleave(torch.arange(dev.ncarry, device=dv), counts)
    first = torch.cumsum(counts, 0) - counts
    t = ta[owner] + torch.arange(owner.numel(), device=dv) - first[owner]
    slot = 2 * t + (t == ta[owner]).long()
    s = torch.zeros(dev.ncarry, dtype=torch.float32, device=dv)
    s.index_add_(0, owner, carry[slot])
    y[r] = s
    return y


# ---------------------------------------------------------------- K3


def fused_lanes(dev: DevCsr) -> int:
    """K3's lanes per row: the smallest of 4, 8, 16, 32 that covers the
    mean row length (32 for anything longer)."""
    mean = dev.nnz / max(dev.nrows, 1)
    for vec in (4, 8, 16):
        if mean <= vec:
            return vec
    return 32


def segmented_spmv_fused(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """K3: y = A·x in one dispatch."""
    _check_x(dev, x)
    if not _on_cuda(dev, x):
        return segmented_spmv_fused_reference(dev, x)
    if dev.nnz == 0 or dev.nrows == 0:  # nothing to launch: y is all zeros
        return torch.zeros(dev.nrows, dtype=torch.float32, device=dev.device)
    y = torch.empty(dev.nrows, dtype=torch.float32, device=dev.device)
    _launch("csr_spmv_fused", dev, dev.ptr, dev.cols, dev.vals, x, y,
            dev.nrows, fused_lanes(dev))
    return y


def segmented_spmv_fused_reference(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """Plain K3: a row-wise segment sum of the products."""
    if dev.nnz == 0:
        return torch.zeros(dev.nrows, dtype=torch.float32, device=dev.device)
    prod = dev.vals * x[dev.cols.long()]
    return torch.segment_reduce(prod, "sum", offsets=dev.ptr, initial=0.0)


# ---------------------------------------------------------------- dispatch


def segmented_spmv(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x: K3 for small plans (``dev.fused``), else K1 then K2."""
    if dev.fused:
        return segmented_spmv_fused(dev, x)
    y, carry = segmented_spmv_partials(dev, x)
    return carry_fixup(dev, y, carry)

"""The probes' kernels: K1 and K12 with one stage changed or cut, and K1
and K2 at other tiles; each wrapper with its plain PyTorch version beside
it. ``spmv_tpu_torch.probes`` times them against the production kernels.

Counterpart of the JAX package's on-chip probes (``scripts/probe_*.py``),
which time Pallas variants of the TPU kernels on synthetic streams and are
correctness-invalid by design. These run on the real plans, and each
computes a defined function that its plain version reproduces.

==============================  ==========================  ==================================
wrapper                         kernel (csrc/probe_spmv.cu)  replaces
==============================  ==========================  ==================================
segmented_spmv_partials_u16     seg_spmv_tiles_u16(_x2)     scripts/probe_pack.py:147
segmented_spmv_partials_at      seg_spmv_tiles_at           scripts/probe_accum.py:168
carry_fixup_at                  carry_fixup_at              scripts/probe_accum.py:168
ablate_nogather                 seg_ablate(_x2), mode 0     scripts/probe_ablate.py:152 (nowin)
ablate_noseg                    seg_ablate(_x2), mode 1     scripts/probe_ablate.py:152 (noseg)
ablate_dma                      seg_ablate(_x2), mode 2     scripts/probe_ablate.py:152 (dma)
ablate_x32                      seg_ablate_x2, mode 3       scripts/probe_x2.py:241
panel_ablate_nogather           panel_ablate(_x2)_nogather  scripts/probe_ablate.py:152 (nowin),
                                                            on K4 and K14
segmented_spmv_fold             seg_spmv_tiles_fold         scripts/probe_ablate3.py:211
                                                            (the scatter epilogue's cost)
launch_floor                    launch_floor                no TPU kernel: the floor under
                                                            a separate launch (no plain
                                                            version: it computes nothing)
==============================  ==========================  ==================================

Routing, as in ``kernels.engines``: CPU tensors run the plain version,
CUDA tensors launch the kernel or raise, and each launch adds one to
``engines.LAUNCHES`` under its own key (``LAUNCH_KEYS``: one per tile and
per stage cut), which this module adds to that table.

On a relabelled plan (``DevCsr.col_order``) the wrappers that read x at
the plan's columns gather it first (``engines.plan_x``), as K1's does;
the stage cuts that compute x̃ from the loaded column (``nogather``,
``dma``) and ``cols16`` work in the plan's labels; callers of ``noseg``
pass ``plan_x(dev, x)`` with ``dev.cols``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, DevPanel
from spmv_tpu_torch.formats.base import TILE_NNZ, build_csr_plan, cdiv
from spmv_tpu_torch.kernels.engines import (LAUNCHES, _check_x, _launch, _on_cuda,
                                            segmented_spmv_partials_reference,
                                            carry_fixup_reference, plan_x, tile_outputs)
from spmv_tpu_torch.kernels.panel import (_launch_panel_tiles,
                                          panel_spmv_partials_reference)

__all__ = ["U16_COLS_MAX", "PROBE_TILES", "LAUNCH_KEYS", "cols16", "retile", "xtilde",
           "segmented_spmv_partials_u16", "segmented_spmv_partials_u16_reference",
           "segmented_spmv_partials_at", "carry_fixup_at",
           "segmented_spmv_partials_at_reference", "carry_fixup_at_reference",
           "ablate_nogather", "ablate_nogather_reference", "ablate_noseg",
           "ablate_noseg_reference", "ablate_dma", "ablate_dma_reference",
           "ablate_x32", "ablate_x32_reference", "tile_sums",
           "panel_ablate_nogather", "panel_ablate_nogather_reference",
           "segmented_spmv_fold", "segmented_spmv_fold_reference", "launch_floor"]

# The widest matrix a 16-bit column index addresses.
U16_COLS_MAX = 65536
# The tiles of seg_spmv_tiles_at and carry_fixup_at (1024 is K1's own).
PROBE_TILES = (128, 512, 2048)
_MODES = {"nogather": 0, "noseg": 1, "dma": 2, "x32": 3}
_FLOATS = (torch.float32, torch.float64)
# The launch counters of the probe kernels, in ``engines.LAUNCHES``.
LAUNCH_KEYS = ("seg_spmv_tiles_u16", "seg_spmv_tiles_u16_x2",
               *(f"seg_spmv_tiles_t{t}" for t in PROBE_TILES),
               *(f"carry_fixup_t{t}" for t in PROBE_TILES),
               "seg_ablate_nogather", "seg_ablate_noseg", "seg_ablate_dma",
               "seg_ablate_x2_nogather", "seg_ablate_x2_noseg", "seg_ablate_x2_dma",
               "seg_ablate_x2_x32", "panel_ablate_nogather", "panel_ablate_x2_nogather",
               "seg_spmv_tiles_fold", "launch_floor")
for _key in LAUNCH_KEYS:
    LAUNCHES.setdefault(_key, 0)


def _plan_dtype(dev) -> torch.dtype:
    dtype = dev.vals.dtype
    if dtype not in _FLOATS:
        raise ValueError(f"the probe kernels take float32 or float64 values, got {dtype}")
    return dtype


def _suffix(dtype: torch.dtype) -> str:
    return "_x2" if dtype == torch.float64 else ""


def _check_tile(dev, tiles) -> None:
    if dev.tile not in tiles:
        raise ValueError(f"the CUDA kernel takes tile {' or '.join(map(str, tiles))}, "
                         f"plan has {dev.tile}")


def _aligned(*pairs) -> None:
    for t, n in pairs:
        if t.data_ptr() % n:
            raise ValueError(f"the kernel reads {t.dtype} in {n}-byte loads: "
                             f"the tensor must be {n}-byte aligned")


# ---------------------------------------------------------------- u16 columns


def _check_u16_width(dev: DevCsr) -> None:
    if dev.ncols > U16_COLS_MAX:
        raise ValueError(f"{dev.ncols} columns do not fit 16-bit indices "
                         f"(at most {U16_COLS_MAX})")


def cols16(dev: DevCsr) -> torch.Tensor:
    """The plan's columns as 16-bit unsigned indices, held in an int16
    tensor (the same bits) on the plan's device. Raises for a matrix wider
    than ``U16_COLS_MAX`` columns."""
    _check_u16_width(dev)
    c = dev.cols
    return torch.where(c >= 32768, c - 65536, c).to(torch.int16)


def _widen(c16: torch.Tensor) -> torch.Tensor:
    return c16.to(torch.int32) & 0xFFFF


def _check_cols16(dev: DevCsr, c16: torch.Tensor) -> None:
    _check_u16_width(dev)
    if (c16.dtype != torch.int16 or c16.shape != (dev.nnz,)
            or not c16.is_contiguous() or c16.device != dev.device):
        raise ValueError(f"cols16 must be a contiguous int16 ({dev.nnz},) tensor "
                         f"on {dev.device}, got {c16.dtype} {tuple(c16.shape)} "
                         f"on {c16.device}")


def segmented_spmv_partials_u16(dev: DevCsr, c16: torch.Tensor, x: torch.Tensor):
    """K1 (float32 plan) or K12 (float64 plan) reading ``c16`` (from
    ``cols16``) for the columns: 2 B per nonzero fewer. ``(y, carry)`` as
    K1 gives them, with the same bits."""
    dtype = _plan_dtype(dev)
    _check_x(dev, x)
    _check_cols16(dev, c16)
    if not _on_cuda(dev, x, dtype=dtype):
        return segmented_spmv_partials_u16_reference(dev, c16, x)
    _check_tile(dev, (TILE_NNZ,))
    _aligned((dev.vals, 16), (c16, 8))
    y, carry = tile_outputs(dev, dtype)
    if dev.nnz:
        name = "seg_spmv_tiles_u16" + _suffix(dtype)
        _launch(name, dev, dev.ptr, c16, dev.vals, dev.tile_row0, plan_x(dev, x), y,
                carry, dev.nnz, dev.ntiles, dev.tile)
    return y, carry


def segmented_spmv_partials_u16_reference(dev: DevCsr, c16: torch.Tensor,
                                          x: torch.Tensor):
    """Plain K1 on the widened 16-bit columns."""
    return segmented_spmv_partials_reference(
        dataclasses.replace(dev, cols=_widen(c16)), x)


# ---------------------------------------------------------------- other tiles


def retile(dev: DevCsr, tile: int) -> DevCsr:
    """The same matrix's plan at ``tile`` nonzeros per tile
    (``build_csr_plan(tile=...)``, from the matrix's own column labels), on
    the plan's device."""
    vals = dev.vals.cpu().numpy()
    plan = build_csr_plan(dev.nrows, dev.ncols, dev.ptr.cpu().numpy(),
                          dev.source_cols().cpu().numpy(), vals, tile=tile,
                          dtype=vals.dtype)
    return DevCsr.from_plan(plan, dev.device)


def segmented_spmv_partials_at(dev: DevCsr, x: torch.Tensor):
    """K1 (float32) on a plan of tile 128, 512 or 2048 (``retile``):
    ``(y, carry)`` on that plan's tiles and carry slots."""
    _check_x(dev, x)
    if not _on_cuda(dev, x):
        return segmented_spmv_partials_at_reference(dev, x)
    _check_tile(dev, PROBE_TILES)
    _aligned((dev.vals, 16), (dev.cols, 16))
    y, carry = tile_outputs(dev, torch.float32)
    if dev.nnz:
        _launch("seg_spmv_tiles_at", dev, dev.ptr, dev.cols, dev.vals,
                dev.tile_row0, plan_x(dev, x), y, carry, dev.nnz, dev.ntiles, dev.tile,
                key=f"seg_spmv_tiles_t{dev.tile}")
    return y, carry


def carry_fixup_at(dev: DevCsr, y: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """K2 (float32) on a plan of tile 128, 512 or 2048: adds each split
    row's partials into ``y`` in place and returns it."""
    if y.shape != (dev.nrows,) or carry.shape != (2 * dev.ntiles,):
        raise ValueError("y or carry does not match the plan")
    if not _on_cuda(dev, y, carry):
        return carry_fixup_at_reference(dev, y, carry)
    _check_tile(dev, PROBE_TILES)
    if dev.ncarry:
        _launch("carry_fixup_at", dev, dev.ptr, dev.carry_rows, carry, y,
                dev.ncarry, dev.tile, key=f"carry_fixup_t{dev.tile}")
    return y


# Plain K1 and K2 take any tile.
segmented_spmv_partials_at_reference = segmented_spmv_partials_reference
carry_fixup_at_reference = carry_fixup_reference


# ---------------------------------------------------------------- stage cuts


def _xt(cols: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x̃(c) = (c & 1023)·2⁻¹⁰ for each column, exact in float32 and
    float64."""
    return (cols & 1023).to(dtype) * 2.0 ** -10


def xtilde(ncols: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The x that ``ablate_nogather`` computes in registers: x̃(c) for
    every column c."""
    return _xt(torch.arange(ncols, device=device), dtype)


def ablate_nogather(dev: DevCsr):
    """K1 (float32 plan) or K12 (float64 plan) without the x gather: each
    product is ``v·x̃(c)`` with x̃ computed from the loaded column.
    ``(y, carry)``, bit for bit K1's on ``xtilde`` (on a relabelled plan,
    plain K1's on the x̃ of its labels)."""
    dtype = _plan_dtype(dev)
    if not _on_cuda(dev, dtype=dtype):
        return ablate_nogather_reference(dev)
    _check_tile(dev, (TILE_NNZ,))
    _aligned((dev.vals, 16), (dev.cols, 16))
    y, carry = tile_outputs(dev, dtype)
    if dev.nnz:
        name = "seg_ablate" + _suffix(dtype)
        _launch(name, dev, dev.ptr, dev.cols, dev.vals, dev.tile_row0, None, y,
                carry, None, dev.nnz, dev.ntiles, _MODES["nogather"],
                key=f"{name}_nogather")
    return y, carry


def ablate_nogather_reference(dev: DevCsr):
    """Plain K1 on ``xtilde`` of the plan's own column labels."""
    return segmented_spmv_partials_reference(
        dataclasses.replace(dev, col_order=None),
        xtilde(dev.ncols, dev.vals.dtype, dev.device))


def _check_stream(vals: torch.Tensor, cols: torch.Tensor) -> torch.dtype:
    if vals.dtype not in _FLOATS or cols.dtype != torch.int32:
        raise ValueError(f"a stream is float32 or float64 values and int32 "
                         f"columns, got {vals.dtype} and {cols.dtype}")
    if vals.dim() != 1 or vals.shape != cols.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols {tuple(cols.shape)} "
                         "must be one vector each, of one length")
    if vals.device != cols.device or not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("vals and cols must be contiguous, on one device")
    if vals.numel() > np.iinfo(np.int32).max - TILE_NNZ:
        raise ValueError(f"{vals.numel()} nonzeros exceed int32 indexing")
    return vals.dtype


def tile_sums(terms: torch.Tensor) -> torch.Tensor:
    """Sums of each 1024 consecutive terms (the last tile may be short):
    the reduction of the plain ``noseg`` and ``dma``."""
    n = terms.numel()
    out = torch.zeros(cdiv(n, TILE_NNZ), dtype=terms.dtype, device=terms.device)
    return out.index_add_(0, torch.arange(n, device=terms.device) // TILE_NNZ, terms)


def _stream_launch(mode: str, vals, cols, x) -> torch.Tensor:
    dtype = vals.dtype
    n = vals.numel()
    out = torch.empty(cdiv(n, TILE_NNZ), dtype=dtype, device=vals.device)
    if n:  # every tile writes its out[t]
        _aligned((vals, 16), (cols, 16))
        name = "seg_ablate" + _suffix(dtype)
        _launch(name, vals, None, cols, vals, None, x, None, None, out, n,
                out.numel(), _MODES[mode], key=f"{name}_{mode}")
    return out


def ablate_noseg(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K1's loads and gather without its row search, scan and emit: per
    tile of 1024 nonzeros of the stream, ``out[t] = Σ v·x[c]``."""
    dtype = _check_stream(vals, cols)
    if x.dim() != 1:
        raise ValueError(f"x must be a vector, got {tuple(x.shape)}")
    if not _on_cuda(vals, x, dtype=dtype):
        return ablate_noseg_reference(vals, cols, x)
    return _stream_launch("noseg", vals, cols, x)


def ablate_noseg_reference(vals, cols, x) -> torch.Tensor:
    return tile_sums(vals * x[cols.long()])


def ablate_dma(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The stream alone: per tile of 1024 nonzeros, ``out[t] = Σ (v +
    x̃(c))`` (x̃ as in ``xtilde``, below 1, so both streams weigh in the
    sum). Over the plan's values and columns it reads what K1 streams;
    over a stream above the L2 it is the HBM read ceiling."""
    dtype = _check_stream(vals, cols)
    if not _on_cuda(vals, dtype=dtype):
        return ablate_dma_reference(vals, cols)
    return _stream_launch("dma", vals, cols, None)


def ablate_dma_reference(vals, cols) -> torch.Tensor:
    return tile_sums(vals + _xt(cols, vals.dtype))


def ablate_x32(dev: DevCsr, x32: torch.Tensor):
    """K12 (float64 plan) with x gathered from a float32 copy: ``(y,
    carry)`` in float64, bit for bit K12's on ``x32`` widened."""
    if dev.vals.dtype != torch.float64:
        raise ValueError(f"the plan holds {dev.vals.dtype} values; x32 takes "
                         "a float64 plan")
    _check_x(dev, x32)
    if x32.dtype != torch.float32 or not x32.is_contiguous() or x32.device != dev.device:
        raise ValueError(f"x32 must be contiguous float32 on {dev.device}, got "
                         f"{x32.dtype} on {x32.device}")
    if not _on_cuda(dev, dtype=torch.float64):
        return ablate_x32_reference(dev, x32)
    _check_tile(dev, (TILE_NNZ,))
    _aligned((dev.vals, 16), (dev.cols, 16))
    y, carry = tile_outputs(dev, torch.float64)
    if dev.nnz:
        _launch("seg_ablate_x2", dev, dev.ptr, dev.cols, dev.vals, dev.tile_row0,
                plan_x(dev, x32), y, carry, None, dev.nnz, dev.ntiles, _MODES["x32"],
                key="seg_ablate_x2_x32")
    return y, carry


def ablate_x32_reference(dev: DevCsr, x32: torch.Tensor):
    """Plain K12 on the float32 x widened to float64."""
    return segmented_spmv_partials_reference(dev, x32.double())


# ---------------------------------------------------------------- the panel


def panel_ablate_nogather(dev: DevPanel):
    """K4 (float32 panel) or K14 (float64 panel) without the x gather: each
    product is ``v·x̃(c)`` with x̃ computed from the loaded column. ``(y,
    part)``, bit for bit K4's on ``xtilde``."""
    dtype = _plan_dtype(dev)
    if not _on_cuda(dev, dtype=dtype):
        return panel_ablate_nogather_reference(dev)
    name = f"panel_ablate{_suffix(dtype)}_nogather"
    return _launch_panel_tiles(name, dtype, dev, None, key=name)


def panel_ablate_nogather_reference(dev: DevPanel):
    """Plain K4 on ``xtilde``."""
    return panel_spmv_partials_reference(dev, xtilde(dev.ncols, dev.vals.dtype, dev.device))


# ---------------------------------------------------------------- K1 + K2 folded

# the fold kernel's arrival counter per device: zeroed once, and left at 0
# by the last block of every launch
_ARRIVED: dict = {}


def segmented_spmv_fold(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """K1 with K2 folded into its last block (float32 plan): y = A·x in one
    launch, bit for bit K1 then K2. The blocks count themselves on one
    integer counter per device, so launches that share a device must not
    overlap (one stream)."""
    _check_x(dev, x)
    if not _on_cuda(dev, x):
        return segmented_spmv_fold_reference(dev, x)
    _check_tile(dev, (TILE_NNZ,))
    _aligned((dev.vals, 16), (dev.cols, 16))
    y, carry = tile_outputs(dev, torch.float32)
    if dev.nnz:
        if dev.device not in _ARRIVED:
            _ARRIVED[dev.device] = torch.zeros(1, dtype=torch.int32, device=dev.device)
        _launch("seg_spmv_tiles_fold", dev, dev.ptr, dev.cols, dev.vals, dev.tile_row0,
                plan_x(dev, x), y, carry, dev.carry_rows, _ARRIVED[dev.device], dev.nnz,
                dev.ntiles, dev.ncarry, dev.tile)
    return y


def segmented_spmv_fold_reference(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """Plain K1 then plain K2."""
    return carry_fixup_reference(dev, *segmented_spmv_partials_reference(dev, x))


# ---------------------------------------------------------------- launch floor


def launch_floor(device) -> None:
    """One launch of a kernel that does nothing, one block of one thread,
    on the current stream of CUDA ``device``. Timed in a CUDA graph
    (``probes.timing.graph_ms``) it is the least time a separate launch
    takes: the floor under a fix-up's launch, beside its byte bound. It
    computes nothing, so it has no plain version, and any other device is
    refused."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the launch floor is a CUDA launch, not one on {device}")
    _launch("launch_floor", SimpleNamespace(device=device))

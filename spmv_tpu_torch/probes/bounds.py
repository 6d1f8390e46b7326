"""The least time a kernel call could take on the card: the larger of the
bytes it must move over the HBM peak and its operations over the peak
rate of their type. Bytes count each input read once and each output
written once, from the plan and this call's shapes (carry slots and split
rows as this plan has them); what a kernel reads twice, or a zero fill of
its output, is not counted.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside
the tensor cores. A card set below 700 W runs slower; the probes and
``chip_smoke.py`` print its limit beside every number.
"""

from __future__ import annotations

import torch

__all__ = ["HBM_PEAK_BPS", "PEAK_FLOPS", "bound_ms", "nbytes", "seg_tiles_bytes",
           "fixup_bytes", "csr_spmv_bytes", "fused_bytes", "panel_tiles_bytes",
           "panel_fixup_bytes", "panel_fused_bytes", "permute_bytes",
           "epilogue_bytes", "stream_bytes"]

HBM_PEAK_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound_ms(nbytes: int, flops: int, dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two bounds."""
    by_bytes = nbytes / HBM_PEAK_BPS * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def seg_tiles_bytes(dev, R: int = 1, cols=None, x_itemsize: int | None = None) -> int:
    """K1 (K8 at R columns, K12 in float64): ptr, columns, values and
    tile_row0 read once, x read, y and both carry slots of every tile
    written. ``cols`` replaces the plan's columns (16-bit ones);
    ``x_itemsize`` the bytes of an x entry (0 when x is not read, 4 for a
    float32 x under float64 values)."""
    es = dev.vals.element_size()
    xs = es if x_itemsize is None else x_itemsize
    cols = dev.cols if cols is None else cols
    return (nbytes(dev.ptr, cols, dev.vals, dev.tile_row0)
            + (dev.ncols * xs + (dev.nrows + 2 * dev.ntiles) * es) * R)


def _spans(starts: torch.Tensor, ends: torch.Tensor, tile: int) -> int:
    """Σ over split runs [start, end) of the tiles each touches."""
    return int(((ends - 1) // tile - starts // tile + 1).sum()) if starts.numel() else 0


def fixup_bytes(dev, R: int = 1) -> int:
    """K2 (K9 at R columns, K13 in float64): each split row's carry slots
    read, its row, two ptr entries and its y written."""
    es = dev.vals.element_size()
    r = dev.carry_rows.long().cpu()
    ptr = dev.ptr.long().cpu()
    slots = _spans(ptr[r], ptr[r + 1], dev.tile)
    return slots * es * R + dev.ncarry * (3 * 4 + es * R)


def csr_spmv_bytes(dev, R: int = 1, x_itemsize: int | None = None) -> int:
    """y = A·x over a CSR plan (K1 + K2, K8 + K9, K12 + K13): the plan's
    tensors read once, x read, y written; the carries stay on the card."""
    es = dev.vals.element_size()
    xs = es if x_itemsize is None else x_itemsize
    return dev.stream_bytes + (dev.ncols * xs + dev.nrows * es) * R


def fused_bytes(dev) -> int:
    """K3: ptr, columns, values and tile_row0 read, x read, y written; the
    words a split row's tiles publish stay on the card."""
    es = dev.vals.element_size()
    return nbytes(dev.ptr, dev.cols, dev.vals, dev.tile_row0) + (dev.ncols + dev.nrows) * es


def panel_tiles_bytes(pdev, R: int = 1, x_itemsize: int | None = None) -> int:
    """K4 (K10 at R columns, K14 in float64): slice_ptr, columns, values,
    tile_slice0 and tile_own0 read, x read, y and the 2 × 32 partials of
    every tile written. ``x_itemsize`` the bytes of an x entry (0 when x
    is not read)."""
    es = pdev.vals.element_size()
    xs = es if x_itemsize is None else x_itemsize
    return (nbytes(pdev.slice_ptr, pdev.cols, pdev.vals, pdev.tile_slice0,
                   pdev.tile_own0)
            + (pdev.ncols * xs + (pdev.nrows + 2 * pdev.ntiles * 32) * es) * R)


def panel_fixup_bytes(pdev, R: int = 1) -> int:
    """K7's identity mode without a spill (``panel_fixup``, at R columns,
    in float64): each split slice's 32-row partials read, its entry, two
    slice_ptr entries and its 32 rows of y written."""
    es = pdev.vals.element_size()
    s = pdev.split_slices.long().cpu()
    scol = pdev.slice_ptr.long().cpu() // 32
    parts = _spans(scol[s], scol[s + 1], pdev.tile)
    return parts * 32 * es * R + pdev.nsplit * (3 * 4 + 32 * es * R)


def panel_fused_bytes(pdev, mode: int | None = None) -> int:
    """K6: slice_ptr, columns and values read, x read, y written; in its
    tile mode (``mode`` 1; None: the mode ``panel.fused_mode`` picks) also
    tile_slice0 and tile_own0 read. The split slices' partials and
    counters stay in the L2, as K3's words do."""
    from spmv_tpu_torch.kernels.panel import fused_mode

    es = pdev.vals.element_size()
    tiles = (pdev.tile_slice0, pdev.tile_own0) if (
        fused_mode(pdev) if mode is None else mode) else ()
    return (nbytes(pdev.slice_ptr, pdev.cols, pdev.vals, *tiles)
            + (pdev.ncols + pdev.nrows) * es)


def permute_bytes(n: int, row_bytes: int) -> int:
    """K7: n int32 indices read, n rows of ``row_bytes`` read and written."""
    return n * (4 + 2 * row_bytes)


def epilogue_bytes(pdev, invperm: torch.Tensor | None, nrows: int, R: int = 1,
                   spill: bool = False) -> int:
    """K7 with the panel's partials, every panel's epilogue, at R columns,
    as this plan's rows need it: ``invperm``'s first ``nrows`` entries and
    ``slice_ptr`` read; per output row, the partial slots of its slice
    where the slice is split (the tail slot of its first tile and a head
    slot per later tile), else its row of y′; the spill's y′ row where it
    adds one; the row of y written. A split slice's rows of y′ are never
    read. ``invperm`` None is the identity (row p = i of y′, ``nrows`` all
    of them, y written in place): no ``invperm`` read, and without a spill
    only the split slices' rows, ``panel_fixup_bytes``. (Without partials
    it is the gather alone, ``permute_bytes``.)"""
    if invperm is None and not spill:
        return panel_fixup_bytes(pdev, R)
    es = pdev.vals.element_size()
    scol = pdev.slice_ptr.long().cpu() // 32
    s = pdev.split_slices.long().cpu()
    spans = torch.zeros(scol.numel() - 1, dtype=torch.long)
    spans[s] = (scol[s + 1] - 1) // pdev.tile - scol[s] // pdev.tile + 1
    src = torch.arange(nrows) if invperm is None else invperm[:nrows].long().cpu()
    reads = spans[src // 32].clamp(min=1)
    return (nbytes(pdev.slice_ptr) + (0 if invperm is None else 4 * nrows)
            + (int(reads.sum()) + nrows * (2 if spill else 1)) * es * R)


def stream_bytes(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor | None = None) -> int:
    """noseg (with x) and dma: values and columns read, x read, one sum per
    tile of 1024 written."""
    ntiles = -(-vals.numel() // 1024)
    return nbytes(vals, cols) + (nbytes(x) if x is not None else 0) + ntiles * vals.element_size()

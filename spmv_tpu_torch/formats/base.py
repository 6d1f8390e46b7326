"""The port's host plans: CSR arrays plus an nnz-balanced tile schedule
(``build_csr_plan``), and the sliced-ELLPACK panel (``build_panel_plan``).

Counterpart of ``spmv_tpu/formats/base.py:build_seg_plan``, but not of its
layout. The JAX plan answers TPU limits (128-lane stripes, depth-8 x
windows, u8 index planes, P-packing, y windows) that a Hopper card does
not have; what stays is the job: y = A·x with each row summed in a fixed
order and without float atomics.

The schedule cuts the row-major nonzero stream into tiles of ``tile``
nonzeros. Kernel K1 (``seg_spmv_tiles``) takes one tile per thread block
and writes every row that lies wholly inside its tile straight to y. A row
that crosses a tile boundary is *split*: each tile it touches leaves one
partial in a carry slot, and kernel K2 (``carry_fixup``) adds those
partials in tile order. Tile ``t`` owns two slots:

* ``carry[2t]``   — the head: the row that began in an earlier tile;
* ``carry[2t+1]`` — the tail: the row that begins in tile ``t`` and runs on
  into later tiles.

A split row ``r`` with ``ta = ptr[r] // tile`` and
``tb = (ptr[r+1] - 1) // tile`` therefore reads
``carry[2ta+1] + carry[2(ta+1)] + … + carry[2tb]`` — a range of tiles, so a
power-law row may span any number of them. Those are exactly the slots K1
writes (``kernels.engines.carry_slot_rows``); K2 reads no other, so the
carries need no clearing.

The panel plan (counterpart of ``build_panel_plan`` there, again not of its
128-column stripes, depth-8 x windows, u8 ``lo``/``hi`` or P-planes) is
sliced ELLPACK. Each slice is ``SLICE_ROWS`` = 32 consecutive rows, one
warp, the reference's own C (``sigma_c.c:48``). Slice ``s`` has width
``K_s``, its longest row, and holds ``32·K_s`` slots stored column-major:
element ``j`` of row ``r`` sits at ``slice_ptr[s] + r % 32 + 32·j``. Pads
hold value 0 and column ``PAD_COL`` (−1): every panel kernel and its plain
version skips them, so a pad reads no x and adds nothing (a non-finite x
entry reaches only the rows that read its column). A *slice column* is 32
consecutive slots, one per row, so a warp reads each as one 128-byte load
of values and one of columns.

Kernel K6 (``panel_spmv_fused``) walks one slice per warp, or on a panel
with a wide slice runs K4's tiles and sums the split slices in the same
launch. For the two-dispatch shape, K4 (``panel_spmv_tiles``) cuts the
stream of slice columns into tiles of ``tile`` columns, as K1 cuts
nonzeros, so a very wide slice spreads over many tiles. A slice that crosses a tile boundary is
*split*: each tile it touches leaves 32 partials (one per row) in the
tile's head slot ``part[2t]`` (the slice began in an earlier tile) or tail
slot ``part[2t+1]`` (it runs on into later tiles), and K7
(``inverse_permute``, the panel's epilogue) adds them in tile order,
exactly as K2 does for rows.

K4 writes all of y and of ``part``, so neither needs clearing. Each slice
has one owning tile, the tile of its first column: tile ``t`` owns slices
``tile_own0[t] .. tile_own0[t+1] - 1``, those whose first column lies in
it, and the last tile also owns the empty slices after the final column.
The owning tile writes the slice's rows of y: the sum of a slice that lies
wholly in the tile, and +0.0 for an empty slice or a split one (whose rows
K7 then writes from the partials). Every tile writes both its partial slots, +0.0 where
no split slice uses one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from spmv_tpu_torch import cache as _cache
from spmv_tpu_torch import trace

__all__ = ["CsrPlan", "TILE_NNZ", "ROW_STAGE", "build_csr_plan", "csr_ptr",
           "check_rows", "cdiv", "row_spans", "PanelPlan", "SLICE_ROWS", "TILE_COLS",
           "PAD_COL", "build_panel_plan", "plan_entry_limit", "check_plan_range",
           "is_row_major"]

# Nonzeros per K1 tile: 256 threads × 4 consecutive nonzeros each. Fixed by
# kernels/csrc/seg_spmv.cu (kTileNnz); the CUDA wrapper refuses other tiles.
TILE_NNZ = 1024

# Row offsets K1 and K12 stage in shared memory per tile (row_stage_cap in
# kernels/csrc/seg_tile.cuh): a tile without empty rows spans at most
# TILE_NNZ + 1 rows, so TILE_NNZ + 2 offsets. A tile whose span (``row_spans``)
# is longer, which only runs of empty rows make, reads them from global memory.
ROW_STAGE = TILE_NNZ + 2

# Rows per panel slice: one warp, one row per lane (panel_spmv.cu kC).
SLICE_ROWS = 32
# Slice columns per K4 tile: 32 columns of 32 slots, the 1024 slots of a
# K1 tile (panel_spmv.cu kTileCols); the CUDA wrapper refuses other tiles.
TILE_COLS = 32
# The column of a panel's pad slots: no x entry, so the kernels skip the
# slot (kPadCol in kernels/csrc/panel_tile.cuh).
PAD_COL = -1

_INT32_MAX = np.iinfo(np.int32).max


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_entry_limit(tile: int, slice_rows: int = 1) -> int:
    """The most entries one device plan may index: nonzeros of a CSR plan
    (``slice_rows`` 1, K1 tiles of ``tile`` nonzeros) or slots of a panel
    (``slice_rows`` ``SLICE_ROWS``, K4 tiles of ``tile`` slice columns).
    Plans index with int32, and the kernels' tile arithmetic stays below
    2^31. The one bound of both builders (``check_plan_range``) and of
    ``big.TiledSpmv``'s slabs, which cut a matrix past it."""
    return _INT32_MAX - slice_rows * tile


def check_plan_range(nrows: int, entries: int, tile: int, what: str,
                     slice_rows: int = 1) -> None:
    """Refuse a plan of ``entries`` ``what`` (nonzeros, panel slots) over
    ``nrows`` rows past ``plan_entry_limit``, or with rows past int32."""
    if (entries > plan_entry_limit(tile, slice_rows)
            or nrows > _INT32_MAX - slice_rows):
        raise ValueError(f"{nrows} rows / {entries} {what} exceed int32 indexing")


def is_row_major(rows, cols=None, chunk: int = 1 << 24) -> bool:
    """True when the triplets are in row order, and given ``cols`` in column
    order within each row: what a stable (row, col) sort leaves as it is.
    Checked ``chunk`` entries at a time, so billions of entries need no
    temporary of their size."""
    rows = np.asarray(rows)
    last = rows.size - 1
    for lo in range(0, max(last, 0), chunk):
        hi = min(lo + chunk, last)
        r0, r1 = rows[lo:hi], rows[lo + 1:hi + 1]
        if (r1 < r0).any():
            return False
        if cols is not None:
            same = r1 == r0
            if (cols[lo + 1:hi + 1][same] < cols[lo:hi][same]).any():
                return False
    return True


@dataclass(frozen=True)
class CsrPlan:
    """Host arrays of one matrix, ready to copy to a device."""

    nrows: int
    ncols: int
    ptr: np.ndarray  # (nrows+1,) int32 — row starts in the nonzero stream
    cols: np.ndarray  # (nnz,) int32, row-major
    vals: np.ndarray  # (nnz,) float32 (float64 for the fp64-grade mode), row-major
    tile_row0: np.ndarray  # (ntiles+1,) int32 — row of each tile's first nonzero
    carry_rows: np.ndarray  # (ncarry,) int32 — rows that cross a tile boundary
    tile: int

    @property
    def nnz(self) -> int:
        return int(self.cols.size)

    @property
    def ntiles(self) -> int:
        return cdiv(self.nnz, self.tile)

    @property
    def max_row_nnz(self) -> int:
        return int(np.diff(self.ptr).max()) if self.nrows else 0


def row_spans(tile_row0) -> np.ndarray:
    """Row offsets each tile of a plan reads: ``ptr[tile_row0[t] ..
    tile_row0[t + 1] + 1]``, so ``tile_row0[t + 1] - tile_row0[t] + 2``; the
    kernel stages them in shared memory where this is at most ``ROW_STAGE``."""
    t0 = np.asarray(tile_row0, dtype=np.int64)
    return np.diff(t0) + 2


def check_rows(rows, nrows: int) -> np.ndarray:
    """``rows`` as int64, refused with ``ValueError("row index out of
    bounds")`` unless every entry lies in ``[0, nrows)``: the check every
    format runs before it counts row lengths."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= nrows):
        raise ValueError("row index out of bounds")
    return rows


def csr_ptr(rows_sorted: np.ndarray, nrows: int) -> np.ndarray:
    """Row pointer (int64) of row-sorted triplets; empty rows get empty
    ranges."""
    rows_sorted = check_rows(rows_sorted, nrows)
    counts = np.bincount(rows_sorted, minlength=nrows)
    ptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr


@trace.traced("plan.host")
def build_csr_plan(nrows: int, ncols: int, ptr, cols, vals, *,
                   tile: int = TILE_NNZ, dtype=np.float32) -> CsrPlan:
    """Plan from CSR arrays (rows already in order; duplicate entries stay
    separate nonzeros and sum in the kernels). Empty rows, ``nnz == 0`` and
    rectangular shapes need no special case.

    ``tile`` is the K1 tile size. The CUDA kernel takes only ``TILE_NNZ``;
    a smaller tile lets the plain versions exercise many tile boundaries
    on a small matrix. ``dtype`` is the values' type: float32, or float64
    for the fp64-grade mode (``x2.X2Matrix``); the pattern arrays do not
    depend on it. While a plan cache is set (``cache.plan_cache``) a plan
    of the same inputs, tile and dtype is read back instead of built.
    """
    nrows, ncols, tile = int(nrows), int(ncols), int(tile)
    ptr = np.asarray(ptr, dtype=np.int64)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    nnz = int(cols.size)
    if nrows < 0 or ncols < 0:
        raise ValueError(f"negative shape {nrows}x{ncols}")
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    if ptr.shape != (nrows + 1,) or ptr[0] != 0 or ptr[-1] != nnz:
        raise ValueError("ptr must have nrows+1 entries from 0 to nnz")
    if (np.diff(ptr) < 0).any():
        raise ValueError("ptr must be nondecreasing")
    if vals.shape != cols.shape or cols.ndim != 1:
        raise ValueError(f"cols {cols.shape} and vals {vals.shape} differ")
    if nnz and (cols.min() < 0 or cols.max() >= ncols):
        raise ValueError("column index out of bounds")
    check_plan_range(nrows, nnz, tile, "nonzeros")

    key = ("csr", (ptr, cols, vals), nrows, ncols,
           {"tile": tile, "dtype": np.dtype(dtype).name})
    hit = _cache.plan_lookup(*key, CsrPlan)
    if hit is not None:
        return hit
    ntiles = cdiv(nnz, tile)
    if nnz:
        first = np.minimum(np.arange(ntiles + 1, dtype=np.int64) * tile,
                           nnz - 1)
        # the row holding each tile's first nonzero (the last tile's entry
        # is the row of the final nonzero): the largest r with ptr[r] <= e
        tile_row0 = np.searchsorted(ptr, first, side="right") - 1
    else:
        tile_row0 = np.zeros(1, dtype=np.int64)
    starts, ends = ptr[:-1], ptr[1:]
    split = (ends > starts) & (starts // tile != (ends - 1) // tile)
    plan = CsrPlan(
        nrows=nrows, ncols=ncols,
        ptr=ptr.astype(np.int32),
        cols=np.ascontiguousarray(cols, dtype=np.int32),
        vals=np.ascontiguousarray(vals, dtype=dtype),
        tile_row0=tile_row0.astype(np.int32),
        carry_rows=np.flatnonzero(split).astype(np.int32),
        tile=tile,
    )
    _cache.plan_store(*key, plan)
    return plan


@dataclass(frozen=True)
class PanelPlan:
    """Host arrays of one sliced-ELLPACK panel, ready to copy to a device."""

    nrows: int
    ncols: int
    nnz: int  # stored elements (duplicates count); the other slots are pads
    slice_ptr: np.ndarray  # (nslices+1,) int64 — first slot of each slice
    widths: np.ndarray  # (nslices,) int64 — K_s, the longest row of the slice
    vals: np.ndarray  # (nslots,) float32 (or float64), column-major within each slice
    cols: np.ndarray  # (nslots,) int32, PAD_COL (-1) in pad slots
    tile_slice0: np.ndarray  # (ntiles+1,) int32 — slice of each tile's first column
    # (ntiles+1,) int32 — the first slice a tile owns (first column at or past
    # the tile's first); the last entry is nslices
    tile_own0: np.ndarray
    split_slices: np.ndarray  # (nsplit,) int32 — slices that cross a tile boundary
    tile: int  # slice columns per K4 tile

    @property
    def nslices(self) -> int:
        return int(self.widths.size)

    @property
    def nslots(self) -> int:
        return int(self.vals.size)

    @property
    def ncolumns(self) -> int:
        return self.nslots // SLICE_ROWS

    @property
    def ntiles(self) -> int:
        return cdiv(self.ncolumns, self.tile)

    @property
    def max_width(self) -> int:
        return int(self.widths.max()) if self.widths.size else 0


@trace.traced("plan.host")
def build_panel_plan(nrows: int, ncols: int, rows, cols, vals, *,
                     tile: int = TILE_COLS, dtype=np.float32) -> PanelPlan:
    """Sliced-ELLPACK plan from triplets already in row order (duplicates
    stay separate slots, as JAX counts them in ``K``). A row's elements
    keep their input order along its slots. Rows past ``nrows`` in the
    last slice, empty rows and ``nnz == 0`` are all-pad.

    ``tile`` is the K4 tile in slice columns. The CUDA kernel takes only
    ``TILE_COLS``; a smaller tile lets the plain versions exercise many
    tile boundaries on a small matrix. ``dtype`` is the values' type, as
    in ``build_csr_plan``, and so is the plan cache.
    """
    nrows, ncols, tile = int(nrows), int(ncols), int(tile)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if nrows < 0 or ncols < 0:
        raise ValueError(f"negative shape {nrows}x{ncols}")
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    if rows.ndim != 1 or not rows.shape == cols.shape == vals.shape:
        raise ValueError(f"rows {rows.shape}, cols {cols.shape} and vals "
                         f"{vals.shape} differ")
    nnz = int(rows.size)
    if nnz and (np.diff(rows) < 0).any():
        raise ValueError("triplets must be in row order")
    ptr = csr_ptr(rows, nrows)  # refuses rows out of bounds
    if nnz and (cols.min() < 0 or cols.max() >= ncols):
        raise ValueError("column index out of bounds")

    key = ("panel", (rows, cols, vals), nrows, ncols,
           {"tile": tile, "dtype": np.dtype(dtype).name})
    hit = _cache.plan_lookup(*key, PanelPlan)
    if hit is not None:
        return hit
    c = SLICE_ROWS
    nslices = cdiv(nrows, c)
    lengths = np.zeros(nslices * c, dtype=np.int64)
    lengths[:nrows] = np.diff(ptr)
    widths = lengths.reshape(nslices, c).max(axis=1)
    slice_ptr = np.zeros(nslices + 1, dtype=np.int64)
    np.cumsum(c * widths, out=slice_ptr[1:])
    nslots = int(slice_ptr[-1])
    check_plan_range(nrows, nslots, tile, "panel slots", c)

    k = np.arange(nnz, dtype=np.int64) - ptr[rows]  # rank within the row
    pos = slice_ptr[rows // c] + rows % c + c * k
    vals_p = np.zeros(nslots, dtype=dtype)
    cols_p = np.full(nslots, PAD_COL, dtype=np.int32)
    vals_p[pos] = vals
    cols_p[pos] = cols

    ncolumns = nslots // c
    ntiles = cdiv(ncolumns, tile)
    scol = slice_ptr // c  # first slice column of each slice
    if ncolumns:
        first = np.minimum(np.arange(ntiles + 1, dtype=np.int64) * tile,
                           ncolumns - 1)
        # the slice holding each tile's first column (the last entry: the
        # slice of the final column), past any empty slices
        tile_slice0 = np.searchsorted(scol, first, side="right") - 1
    else:
        tile_slice0 = np.zeros(1, dtype=np.int64)
    cs, ce = scol[:-1], scol[1:]
    # the slices each tile owns begin at the first whose first column is at
    # or past the tile's first; the last tile takes every slice after it
    tile_own0 = np.append(np.searchsorted(cs, np.arange(ntiles) * tile, side="left"),
                          nslices)
    split = (ce > cs) & (cs // tile != (ce - 1) // tile)
    plan = PanelPlan(
        nrows=nrows, ncols=ncols, nnz=nnz, slice_ptr=slice_ptr,
        widths=widths, vals=vals_p, cols=cols_p,
        tile_slice0=tile_slice0.astype(np.int32),
        tile_own0=tile_own0.astype(np.int32),
        split_slices=np.flatnonzero(split).astype(np.int32), tile=tile)
    _cache.plan_store(*key, plan)
    return plan

"""The port's host plan: CSR arrays plus an nnz-balanced tile schedule.

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
power-law row may span any number of them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CsrPlan", "TILE_NNZ", "build_csr_plan", "csr_ptr", "cdiv"]

# Nonzeros per K1 tile: 256 threads × 4 consecutive nonzeros each. Fixed by
# kernels/csrc/seg_spmv.cu (kTileNnz); the CUDA wrapper refuses other tiles.
TILE_NNZ = 1024

_INT32_MAX = np.iinfo(np.int32).max


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class CsrPlan:
    """Host arrays of one matrix, ready to copy to a device."""

    nrows: int
    ncols: int
    ptr: np.ndarray  # (nrows+1,) int32 — row starts in the nonzero stream
    cols: np.ndarray  # (nnz,) int32, row-major
    vals: np.ndarray  # (nnz,) float32, row-major
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


def csr_ptr(rows_sorted: np.ndarray, nrows: int) -> np.ndarray:
    """Row pointer (int64) of row-sorted triplets; empty rows get empty
    ranges."""
    rows_sorted = np.asarray(rows_sorted, dtype=np.int64)
    if rows_sorted.size and (rows_sorted.min() < 0 or rows_sorted.max() >= nrows):
        raise ValueError("row index out of bounds")
    counts = np.bincount(rows_sorted, minlength=nrows)
    ptr = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr


def build_csr_plan(nrows: int, ncols: int, ptr, cols, vals, *,
                   tile: int = TILE_NNZ) -> CsrPlan:
    """Plan from CSR arrays (rows already in order; duplicate entries stay
    separate nonzeros and sum in the kernels). Empty rows, ``nnz == 0`` and
    rectangular shapes need no special case.

    ``tile`` is the K1 tile size. The CUDA kernel takes only ``TILE_NNZ``;
    a smaller tile lets the plain versions exercise many tile boundaries
    on a small matrix.
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
    # int32 device indices, and K1's tile arithmetic stays below 2^31
    if nnz > _INT32_MAX - tile or nrows >= _INT32_MAX:
        raise ValueError(f"{nrows} rows / {nnz} nonzeros exceed int32 "
                         "indexing")

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
    return CsrPlan(
        nrows=nrows, ncols=ncols,
        ptr=ptr.astype(np.int32),
        cols=np.ascontiguousarray(cols, dtype=np.int32),
        vals=np.ascontiguousarray(vals, dtype=np.float32),
        tile_row0=tile_row0.astype(np.int32),
        carry_rows=np.flatnonzero(split).astype(np.int32),
        tile=tile,
    )

"""Tile shapes that reach each branch of the segmented tile kernel (K1, K12:
``spmv_tpu_torch/kernels/csrc/seg_tile.cuh``), and the host-side mirror of
its row-offset stage.

K1 and K12 stage each tile's row offsets ``ptr[tile_row0[t] ..
tile_row0[t + 1] + 1]`` in shared memory when they fit ``ROW_STAGE`` and
read them from global memory otherwise. ``spmv_tpu_torch.probes.common``
builds the extremes of that design from a seed, with numpy only (the
card's machine has no JAX; ``test_torch_gpu.py`` and ``chip_smoke.py`` use
them too); the tests here check that each reaches the branch it is for:

* ``one_nonzero_rows``: a tile of 1024 one-nonzero rows, the most nonempty
  rows a tile can hold, whose span is exactly the stage's cap;
* ``empty_row_gaps``: tiles whose span crosses the cap through thousands of
  empty rows between nonzeros, beside tiles that fit;
* ``hub_row``: a 5,000-nonzero row over six tiles beside short rows;
* ``wide_hub``: a power-law matrix whose 22,000-nonzero hub spans 22 tiles,
  whose last tile K3 finishes from 21 published partials;
* ``empty_row_edges``: runs of empty rows before the first nonzero, at tile
  boundaries, inside a tile and after the last nonzero, which K3 writes
  itself (K1's wrapper zeroes y), and a tile holding no row of its own.

``test_torch_engines.py`` and ``test_torch_x2.py`` hold the plain K1/K2 and
K12/K13 paths on them against the JAX package; ``test_torch_gpu.py`` holds
the kernels against their plain versions on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from spmv_tpu_torch.formats.base import (ROW_STAGE, TILE_NNZ, build_csr_plan,
                                         csr_ptr, row_spans)
from spmv_tpu_torch.probes.common import (TILE_SHAPES, empty_row_edges,
                                          empty_row_gaps, hub_row, one_nonzero_rows,
                                          wide_hub)

CSRC = Path(__file__).resolve().parents[1] / "spmv_tpu_torch" / "kernels" / "csrc"


def plan(trip):
    info, r, c, v = trip
    return build_csr_plan(info.nrows, info.ncols, csr_ptr(r, info.nrows), c, v)


def test_row_stage_matches_the_cuda_source():
    """``ROW_STAGE`` is the kernel's cap at K1's block of 256 threads."""
    tile = (CSRC / "seg_tile.cuh").read_text()
    m = re.search(r"return kBlockThreads \* kTileItems \+ (\d+);", tile)
    threads = re.search(r"constexpr int kTileThreads = (\d+);",
                        (CSRC / "seg_spmv.cu").read_text())
    assert m and threads
    assert ROW_STAGE == int(threads.group(1)) * 4 + int(m.group(1)) == TILE_NNZ + 2


def test_one_nonzero_rows_fill_the_stage_exactly():
    p = plan(one_nonzero_rows())
    spans = row_spans(p.tile_row0)
    lengths = np.diff(p.ptr.astype(np.int64))
    rows_of_tile1 = np.arange(p.tile_row0[1], p.tile_row0[2])
    assert rows_of_tile1.size == TILE_NNZ and (lengths[rows_of_tile1] == 1).all()
    assert spans[1] == ROW_STAGE and (spans <= ROW_STAGE).all()


def test_empty_row_gaps_cross_the_stage_and_leave_tiles_under_it():
    p = plan(empty_row_gaps())
    spans = row_spans(p.tile_row0)
    assert (spans > ROW_STAGE).sum() >= 2 and (spans <= ROW_STAGE).sum() >= 2
    assert spans[0] > 2500  # the run of empty rows sits inside tile 0


def test_hub_row_spans_at_least_four_tiles():
    p = plan(hub_row())
    ptr = p.ptr.astype(np.int64)
    assert (ptr[301] - 1) // TILE_NNZ - ptr[300] // TILE_NNZ + 1 >= 4
    assert 300 in p.carry_rows and (row_spans(p.tile_row0) <= ROW_STAGE).all()


def test_wide_hub_spans_at_least_twenty_tiles():
    p = plan(wide_hub())
    ptr = p.ptr.astype(np.int64)
    lengths = np.diff(ptr)
    hub = int(lengths.argmax())
    assert lengths[hub] == 22_000 and hub in p.carry_rows
    assert (ptr[hub + 1] - 1) // TILE_NNZ - ptr[hub] // TILE_NNZ + 1 >= 20
    assert (lengths[lengths != 22_000] <= 64).all()


def test_empty_row_edges_reach_every_place_of_an_empty_row():
    p = plan(empty_row_edges())
    ptr = p.ptr.astype(np.int64)
    empty = np.flatnonzero(np.diff(ptr) == 0)
    at = ptr[empty]
    assert (at == 0).sum() == 30  # before the first nonzero
    assert (empty > p.tile_row0[-1]).sum() == 50  # after the last
    boundary = at[(at % TILE_NNZ == 0) & (at > 0) & (at < p.nnz)]
    assert {1024, 3072} <= set(boundary.tolist())  # at tile boundaries
    assert ((at % TILE_NNZ != 0) & (at < p.nnz)).sum() == 500  # inside a tile
    assert p.tile_row0[1] == p.tile_row0[2]  # tile 1 holds no row of its own
    spans = row_spans(p.tile_row0)
    assert spans[0] > ROW_STAGE and (spans[1:] <= ROW_STAGE).all()


def test_row_spans_of_an_empty_plan():
    assert row_spans(np.zeros(1, np.int32)).size == 0


@pytest.mark.parametrize("name", sorted(TILE_SHAPES))
def test_shapes_are_seeded(name):
    a, b = TILE_SHAPES[name](3), TILE_SHAPES[name](3)
    assert all(np.array_equal(u, w) for u, w in zip(a[1:], b[1:]))
    assert not np.array_equal(a[3], TILE_SHAPES[name](4)[3])

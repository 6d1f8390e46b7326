"""Panel shapes that reach each case of the panel tile kernel (K4, K14:
``spmv_tpu_torch/kernels/csrc/panel_tile.cuh``), the host-side mirror of
its walk and of the ownership rule that lets its wrapper skip the zero
fill, and the plain K4 + K5 and K14 + K15 paths on those shapes against
the JAX package.

K4 writes every row of y and every partial slot: tile ``t`` owns slices
``tile_own0[t] .. tile_own0[t+1] - 1`` and writes y for each (the sum of a
slice wholly inside it, +0.0 for an empty slice or a split one, whose rows
K5 then writes), and both its partial slots (+0.0 where unused).
``spmv_tpu_torch.probes.common.PANEL_SHAPES`` builds the cases from a seed
with numpy only (the card's machine has no JAX; ``test_torch_gpu.py`` and
``chip_smoke.py`` run the kernels on them):

* ``empty_at_tile_start``: empty slices at a tile's first column (which
  ``tile_slice0`` skips), and 50 inside a tile (one step of the walk
  passes them all);
* ``leading_trailing_empty``: 70 empty slices before the first column, 40
  after the last (no tile's columns reach them);
* ``slice_fills_tile``: slices of exactly one tile;
* ``hub_slice``: a slice over ten tiles;
* ``one_column_slices``: 32 one-column slices in one tile;
* ``cut_last_slice``: a last slice with 7 of its 32 rows.

JAX runs as its own tests run it (Pallas interpret mode on the CPU); port
and JAX agree within the sum of both tolerances (ROADMAP §C).
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

import spmv_tpu
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu.x2 import X2Matrix as JaxX2
from spmv_tpu_torch.device import DevPanel
from spmv_tpu_torch.formats.base import SLICE_ROWS, TILE_COLS, build_panel_plan
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X2
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale, x2_check)
from spmv_tpu_torch.probes import turns
from spmv_tpu_torch.probes.common import (MATRICES, PANEL_SHAPES, PANEL_SPLIT,
                                          panel_triplets)

C = SLICE_ROWS


def plan(name, dtype=np.float32, seed=0):
    info, r, c, v = PANEL_SHAPES[name](seed)
    return build_panel_plan(info.nrows, info.ncols, r, c, v, dtype=dtype)


def kernel_writes(p):
    """K4's stores, tile by tile, mirrored on the host with the kernel's
    control flow (the pass over the owned empty slices, the walk that steps
    from slice to slice, past empty ones, a ``slice_ptr`` load each).
    Returns the writes of y per slice and of the partial slots, each
    ``(tile, columns summed)`` with None for +0.0, and the number of slices
    each tile's walk stepped."""
    scol = p.slice_ptr // C
    y_w, part_w, stepped = defaultdict(list), defaultdict(list), []
    for t in range(p.ntiles):
        g0 = t * p.tile
        g1 = min(g0 + p.tile, p.ncolumns)
        for s in range(p.tile_own0[t], p.tile_own0[t + 1]):
            if scol[s] == scol[s + 1]:
                y_w[s].append((t, None))
        s = s0 = int(p.tile_slice0[t])
        ce, head, cols, wrote = int(scol[s + 1]), bool(scol[s] < g0), [], set()

        def emit():
            if head:
                part_w[2 * t].append((t, cols))
                wrote.add(2 * t)
            elif ce > g1:
                part_w[2 * t + 1].append((t, cols))
                wrote.add(2 * t + 1)
                y_w[s].append((t, None))
            else:
                y_w[s].append((t, cols))

        for g in range(g0, g1):
            if g >= ce:
                emit()
                head, cols = False, []
                while g >= ce:  # empty slices end where they begin
                    s += 1
                    ce = int(scol[s + 1])
            cols = cols + [g]
        emit()
        for slot in {2 * t, 2 * t + 1} - wrote:
            part_w[slot].append((t, None))
        stepped.append(s - s0)
    return y_w, part_w, stepped


@pytest.mark.parametrize("tile", [TILE_COLS, 3, 1])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_every_row_and_slot_has_one_writer(name, tile):
    """Each slice's rows get exactly one store among K4's tiles, from its
    owning tile: the slice's sum if it lies wholly in that tile, else +0.0
    (and K5 writes the split ones); each partial slot exactly one, from its
    tile; and K5's slots hold each split slice's columns exactly once."""
    info, r, c, v = PANEL_SHAPES[name](0)
    p = build_panel_plan(info.nrows, info.ncols, r, c, v, tile=tile)
    scol = p.slice_ptr // C
    y_w, part_w, _ = kernel_writes(p)
    split = set(p.split_slices.tolist())
    assert p.tile_own0[0] == 0 and p.tile_own0[-1] == p.nslices
    assert (np.diff(p.tile_own0) >= 0).all()
    for s in range(p.nslices):
        cs, ce = int(scol[s]), int(scol[s + 1])
        owner = min(cs // tile, p.ntiles - 1)
        assert p.tile_own0[owner] <= s < p.tile_own0[owner + 1]
        want = None if cs == ce or s in split else list(range(cs, ce))
        assert y_w[s] == [(owner, want)], s
    assert set(y_w) == set(range(p.nslices))
    assert sorted(part_w) == list(range(2 * p.ntiles))
    assert all(len(w) == 1 and w[0][0] == slot // 2 for slot, w in part_w.items())
    for s in split:  # K5: the tail of the first tile, the heads of the rest
        ta, tb = scol[s] // tile, (scol[s + 1] - 1) // tile
        got = [g for slot in [2 * ta + 1, *(2 * np.arange(ta + 1, tb + 1))]
               for g in part_w[slot][0][1]]
        assert got == list(range(scol[s], scol[s + 1]))
    slots = np.arange(p.ntiles) * tile * C  # every slot in one tile's range
    assert slots[0] == 0 and (np.diff(np.append(slots, p.nslots)) > 0).all()


def test_empty_slices_at_a_tile_start_are_skipped_by_the_walk_and_owned():
    p = plan("empty_at_tile_start")
    scol = p.slice_ptr // C
    starts = [t for t in range(1, p.ntiles) if p.tile_own0[t] < p.tile_slice0[t]]
    assert starts  # tile_slice0 skips them, tile_own0 does not
    for t in starts:
        skipped = range(p.tile_own0[t], p.tile_slice0[t])
        assert all(scol[s] == scol[s + 1] == t * TILE_COLS for s in skipped)
    assert max(kernel_writes(p)[2]) > 50  # 50 empty slices inside a tile


def test_leading_and_trailing_empty_slices_belong_to_the_end_tiles():
    p = plan("leading_trailing_empty")
    scol = p.slice_ptr // C
    assert p.tile_own0[1] > C  # tile 0 owns more than one pass of 32 slices
    trailing = np.flatnonzero(scol[:-1] == p.ncolumns)
    assert trailing.size == 40 and (trailing >= p.tile_own0[p.ntiles - 1]).all()
    assert (scol[:70] == 0).all() and p.tile_slice0[0] == 70


def test_slices_that_fill_a_tile_exactly():
    p = plan("slice_fills_tile")
    scol = p.slice_ptr // C
    exact = [s for s in range(p.nslices)
             if scol[s] % TILE_COLS == 0 and scol[s + 1] - scol[s] == TILE_COLS]
    assert len(exact) == 3 and p.split_slices.size == 0


def test_a_hub_slice_passes_through_whole_tiles():
    p = plan("hub_slice")
    scol = p.slice_ptr // C
    (s,) = p.split_slices
    ta, tb = scol[s] // TILE_COLS, (scol[s + 1] - 1) // TILE_COLS
    assert tb - ta >= 8
    _, part_w, _ = kernel_writes(p)
    for t in range(ta + 1, tb):  # its head in the slot, the tail slot +0.0
        assert part_w[2 * t][0][1] == list(range(t * TILE_COLS, (t + 1) * TILE_COLS))
        assert part_w[2 * t + 1] == [(t, None)]


def test_a_tile_of_one_column_slices():
    p = plan("one_column_slices")
    scol = p.slice_ptr // C
    in_tile1 = [s for s in range(p.nslices)
                if TILE_COLS <= scol[s] < 2 * TILE_COLS and scol[s + 1] > scol[s]]
    assert len(in_tile1) == 32 and all(scol[s + 1] - scol[s] == 1 for s in in_tile1)
    assert kernel_writes(p)[2][1] == 62  # past 31 empty and 31 one-column slices


def test_a_last_slice_cut_by_nrows():
    p = plan("cut_last_slice")
    assert p.nrows % C == 7 and p.widths[-1] > 0
    assert p.nslices * C - p.nrows == 25


@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_plain_k4_writes_what_the_mirror_says(name):
    """Plain K4's y and partials against the mirrored stores: a sum where
    the kernel stores one, exact zeros where it stores +0.0; and the probe's
    K4 without the gather is plain K4 on x̃, bit for bit."""
    p = plan(name)
    dev = DevPanel.from_plan(p, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(p.ncols).astype(np.float32))
    y, part = P.panel_spmv_partials(dev, x)
    prod = (dev.vals * x[dev.cols.long()]).double().view(-1, C).numpy()
    y_w, part_w, _ = kernel_writes(p)

    def value(cols):
        return np.zeros(C) if cols is None else prod[cols].sum(axis=0)

    ys = np.zeros(p.nslices * C)
    for s, [(_, cols)] in y_w.items():
        ys[s * C:(s + 1) * C] = value(cols)
    bound = KERNEL_TOL_ABS + fp32_rel_tol(TILE_COLS) * np.abs(ys)
    assert (np.abs(y.double().numpy() - ys[:p.nrows]) <= bound[:p.nrows] + 1e-5).all()
    for slot, [(_, cols)] in part_w.items():
        if cols is None:
            assert not part[slot].any()
        else:
            assert np.allclose(part[slot].double().numpy(), value(cols), atol=1e-4)
    for a, b in zip(KP.panel_ablate_nogather(dev),
                    P.panel_spmv_partials(dev, KP.xtilde(p.ncols, torch.float32, "cpu"))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- against JAX


def inputs(name):
    info, r, c, v = PANEL_SHAPES[name](seed=5)
    x = np.random.default_rng(6).standard_normal(info.ncols)
    return info, r, c, v, x


@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_plain_k4_k5_match_jax_sell(name):
    """Plain K4 + K5 on the shape's panel (row order, as built) against
    JAX's ``SellMatrix.matvec`` in interpret mode and the oracle."""
    info, r, c, v, x = inputs(name)
    x32 = x.astype(np.float32)
    dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v), "cpu")
    before = dict(E.LAUNCHES)
    y = P.panel_fixup(dev, *P.panel_spmv_partials(dev, torch.from_numpy(x32))).numpy()
    assert E.LAUNCHES == before  # CPU tensors: the plain versions ran
    ref = spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v)
    y_jax = np.asarray(ref.matvec(x32))
    k = int(np.bincount(r, minlength=info.nrows).max())
    row_abs = row_scale(info.nrows, r, c, v, x32)
    assert kernel_check(golden_spmv(info.nrows, r, c, v, x32), y, row_abs, k).ok
    bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
             + engine_rel_tol(k) * container_scale(ref, x32, row_abs))
    assert (np.abs(y.astype(np.float64) - y_jax) <= bound).all()


@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_plain_k14_k15_match_jax_x2(name):
    """Plain K14 + K15 on the shape's fp64 panel against JAX's f32x2
    ``X2Matrix`` sell in interpret mode (JAX's ``x2_check``) and the oracle
    (k·2⁻⁵⁰·Σ|v||x|, both sum in fp64)."""
    info, r, c, v, x = inputs(name)
    v = v * (1 + 1e-9 * np.arange(v.size))
    dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                              dtype=np.float64), "cpu")
    y = X2.panel_spmv_x2(dev, torch.from_numpy(x)).numpy()
    y_jax = np.asarray(JaxX2.from_coo("sell", info.nrows, info.ncols, r, c, v).matvec(x))
    scale = row_scale(info.nrows, r, c, v, x)
    k = int(np.bincount(r, minlength=info.nrows).max())
    assert (np.abs(y - golden_spmv(info.nrows, r, c, v, x)) <= k * 2.0 ** -50 * scale).all()
    rep = x2_check(y_jax, y, scale)
    assert rep.ok, rep


# ---------------------------------------------------------------- the probes


def test_panel_triplets_are_the_plans_content():
    """``panel_triplets`` reads back the panel's elements (pads left out),
    so the ``panel`` probe's checks are the plan's own product."""
    info, r, c, v = PANEL_SHAPES["cut_last_slice"](2)
    dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v), "cpu")
    pinfo, pr, pc, pv = panel_triplets(dev)
    assert (pinfo.nrows, pinfo.ncols) == (info.nrows, info.ncols)
    x = np.random.default_rng(3).standard_normal(info.ncols)
    v32 = v.astype(np.float32)
    assert np.allclose(golden_spmv(pinfo.nrows, pr, pc, pv, x),
                       golden_spmv(info.nrows, r, c, v32, x), rtol=0, atol=1e-12)


def test_turns_name_the_panel_matrices_and_their_split():
    assert set(turns.PANEL_TURN_MATRICES) <= set(MATRICES)
    assert set(PANEL_SPLIT) <= set(MATRICES) and PANEL_SPLIT["cant"]
    specs = turns.matrix_specs(turns.PANEL_TURN_MATRICES)
    assert specs["pl"] == ["power_law", dict(n=32768, avg_nnz_per_row=24,
                                             bandwidth=512, seed=0)]


def test_turns_hand_the_panel_shapes_over_as_triplets(tmp_path):
    """``probes.turns`` gives each checkout's worker the shapes as files of
    triplets, so a checkout without ``PANEL_SHAPES`` runs the same ones."""
    paths = turns.shape_specs(tmp_path)
    assert set(paths) == set(PANEL_SHAPES)
    for name, path in paths.items():
        z = np.load(path)
        info, r, c, v = PANEL_SHAPES[name]()
        assert list(z["shape"]) == [info.nrows, info.ncols]
        assert all(np.array_equal(z[k], a) for k, a in zip("rcv", (r, c, v)))


@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_shapes_are_seeded(name):
    a, b = PANEL_SHAPES[name](3), PANEL_SHAPES[name](3)
    assert all(np.array_equal(u, w) for u, w in zip(a[1:], b[1:]))
    assert not np.array_equal(a[3], PANEL_SHAPES[name](4)[3])

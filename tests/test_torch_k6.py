"""K6 (``kernels.panel.panel_spmv_fused``), the one-launch panel kernel, in
its two modes, on the CPU.

K6 walks one slice per warp where every slice is narrow (its slice mode)
and runs K4's tiles where one slice is wider than
``panel.FUSED_SLICE_COLS_MAX`` columns (its tile mode): there each tile
but a split slice's last publishes its piece of the slice as words, and
the last tile waits for them at the end of its tile and sums them with
its own piece in K7's order. Here the plain versions run (CPU tensors):
plain K6's tile mode is plain K4 then plain ``panel_fixup``, bit for bit;
the host mirror below follows the kernel's pieces and waits
(``test_torch_panel_tiles.kernel_writes``); and the port's SELL panel
agrees with the JAX package's on a skewed matrix.
"""

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu_torch import synth
from spmv_tpu_torch.device import DevPanel
from spmv_tpu_torch.formats.base import SLICE_ROWS, TILE_COLS, build_panel_plan
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)
from spmv_tpu_torch.probes import bounds as B
from spmv_tpu_torch.probes.common import PANEL_SHAPES

from test_torch_panel_tiles import kernel_writes

C = SLICE_ROWS


def skewed(n):
    """bench.py's power-law generator (``bench.py:162-169``) at n rows."""
    return synth.power_law(n=n, avg_nnz_per_row=24, bandwidth=512, seed=0)


def sell_pure(trip):
    info, r, c, v = trip
    return spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v, split=False,
                                   device="cpu")


def shape_dev(name, tile=TILE_COLS):
    info, r, c, v = PANEL_SHAPES[name](0)
    return DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                               tile=tile), "cpu")


PANELS = {"pl_2048_sell_pure": lambda: sell_pure(skewed(2048)).dev,
          **{f"shape_{n}": (lambda n=n: shape_dev(n)) for n in sorted(PANEL_SHAPES)}}


@pytest.mark.parametrize("name", sorted(PANELS))
def test_plain_tile_mode_is_plain_k4_then_the_fixup_bit_for_bit(name):
    dev = PANELS[name]()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        dev.ncols).astype(np.float32))
    want = P.panel_fixup_reference(dev, *P.panel_spmv_partials_reference(dev, x))
    got = P.panel_spmv_fused_reference(dev, x, 1)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    if P.fused_mode(dev):  # the wrapper's plain version on the CPU, as it picks
        assert torch.equal(P.panel_spmv_fused(dev, x), want)


@pytest.mark.parametrize("name,tiles", [
    ("pl-2048", True), ("pl-4096", True), ("pl-16384", True),
    ("entry-512", False), ("band-1024", False), ("cant-4096", False)])
def test_the_rule_picks_tiles_on_skewed_panels_and_slices_on_regular_ones(name, tiles):
    trip = {"pl-2048": lambda: skewed(2048), "pl-4096": lambda: skewed(4096),
            "pl-16384": lambda: skewed(16384),
            "entry-512": lambda: synth.synthetic_cant(n=512, avg_nnz_per_row=8,
                                                      bandwidth=40, seed=0),
            "band-1024": lambda: synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                                      bandwidth=60, seed=5),
            "cant-4096": lambda: synth.synthetic_cant(n=4096)}[name]()
    dev = sell_pure(trip).dev
    assert dev.fused  # every one of them is a plan the main path sends K6
    assert P.fused_mode(dev) == int(tiles)
    assert P.fused_mode(dev) == int(dev.max_width > P.FUSED_SLICE_COLS_MAX)


def published_and_kept(p):
    """K6's tile mode on the host, from the ``kernel_writes`` mirror of
    K4's walk: the words each tile publishes (its head and tail pieces,
    slot → (tile, slice)), but the piece a split slice's last tile holds,
    which that tile keeps (slice → (tile, slot)) and finishes at the end
    of its tile."""
    scol = p.slice_ptr // C
    _, part_w, _ = kernel_writes(p)
    col_slice = np.repeat(np.arange(p.nslices), p.widths)
    published, kept = {}, {}
    for slot, [(t, cols)] in part_w.items():
        if cols is None:  # a slot no split slice uses
            continue
        s = int(col_slice[cols[0]])
        if t == (scol[s + 1] - 1) // p.tile:
            kept[s] = (t, slot)
        else:
            published[slot] = (t, s)
    return published, kept, part_w


@pytest.mark.parametrize("tile", [TILE_COLS, 3])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES) + ["pl_2048"])
def test_each_split_slice_is_finished_once_by_its_last_tile(name, tile):
    """Each split slice is finished by its last tile tb, from its own piece
    (the head slot of tb) and the words of tiles ta .. tb - 1, each
    published by a smaller tile (so no wait goes up, and none is circular);
    every published word is read by exactly one finisher (so all are reset
    to 0), and the columns summed, in K7's order, are the slice's, once
    each; the spans are ``panel_fixup_reference``'s."""
    if name == "pl_2048":
        info, r, c, v = skewed(2048)
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
    else:
        info, r, c, v = PANEL_SHAPES[name](0)
    p = build_panel_plan(info.nrows, info.ncols, r, c, v, tile=tile)
    scol = p.slice_ptr // C
    published, kept, part_w = published_and_kept(p)
    split = p.split_slices.astype(np.int64)
    assert sorted(kept) == split.tolist()
    read = []
    for s in split:
        ta, tb = scol[s] // tile, (scol[s + 1] - 1) // tile
        assert kept[s] == (tb, 2 * tb)
        waits = [2 * ta + 1, *(2 * np.arange(ta + 1, tb))]  # split_slot, t < tb
        assert all(published[w] == (w // 2, s) and w // 2 < tb for w in waits)
        read += waits
        cols = [g for slot in [*waits, 2 * tb] for g in part_w[slot][0][1]]
        assert cols == list(range(scol[s], scol[s + 1]))
        span = (scol[s + 1] - 1) // tile - ta + 1  # as panel_fixup_reference counts
        assert len(waits) + 1 == span >= 2
    assert sorted(read) == sorted(published)


def test_k6_wrapper_runs_the_plain_version_on_the_cpu_and_counts_nothing():
    dev = sell_pure(skewed(2048)).dev
    assert not hasattr(dev, "fused_words")  # made on float32 CUDA plans only
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        dev.ncols).astype(np.float32))
    before = dict(E.LAUNCHES)
    y = P.panel_spmv(dev, x)  # a fused plan: K6, here its plain version
    assert E.LAUNCHES == before
    assert torch.equal(y, P.panel_spmv_fused_reference(dev, x))


def test_k6_bytes_count_the_tile_schedule_in_the_tile_mode_only():
    dev = sell_pure(skewed(2048)).dev
    base = sum(t.numel() * t.element_size() for t in (dev.slice_ptr, dev.cols, dev.vals))
    io = (dev.ncols + dev.nrows) * 4
    sched = 4 * (dev.tile_slice0.numel() + dev.tile_own0.numel())
    assert B.panel_fused_bytes(dev, 0) == base + io
    assert B.panel_fused_bytes(dev, 1) == base + io + sched
    assert B.panel_fused_bytes(dev) == B.panel_fused_bytes(dev, P.fused_mode(dev))


def test_skewed_sell_panel_matches_jax():
    """bench.py's power-law generator at 1,024 rows as a whole SELL panel
    (its widest slice 249 columns: K6's tile mode): the port's ``matvec``
    (plain K6, then K7's gather) against JAX's SELL in interpret mode,
    within the sum of both tolerances, and both against the oracle."""
    info, r, c, v = skewed(1024)
    a = sell_pure((info, r, c, v))
    assert a.sorted_rows and a.dev.fused and P.fused_mode(a.dev) == 1
    ref = spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v, split=False)
    x = np.random.default_rng(9).standard_normal(info.ncols).astype(np.float32)
    y = a.matvec(x).numpy()
    y_jax = np.asarray(ref.matvec(x))
    k = int(np.bincount(r, minlength=info.nrows).max())
    row_abs = row_scale(info.nrows, r, c, v, x)
    want = golden_spmv(info.nrows, r, c, v.astype(np.float32), x)
    assert kernel_check(want, y, row_abs, k).ok
    bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
             + engine_rel_tol(k) * container_scale(ref, x, row_abs))
    assert (np.abs(y.astype(np.float64) - y_jax) <= bound).all()

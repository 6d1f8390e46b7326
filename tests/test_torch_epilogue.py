"""K7, the σ-sorted SELL's one epilogue (``kernels.panel.inverse_permute``
with the panel's partials and the spill's y′; ``csrc/panel_spmv.cu``), on
the host, and the sorted containers that run it against the JAX package.

On the card K7 takes over three steps of the shared panel path: the fix-up
of the split slices (K5, K11, K15), the torch add of the spill part's y′,
and the gather back to row order. The tests here hold its rule to those
steps, bit for bit:

* ``k7_mirror``, a numpy mirror of the kernel's per-element rule (row p =
  invperm[i]; its slice split iff it spans two tiles of the plan; then the
  tail slot of its first tile and the head slots after it, in tile order,
  else y′'s row; then + spill), against ``plan.split_slices`` and against
  the parent's sequence of plain versions (plain K5 into y′, the add, the
  gather), on ``probes.common.PANEL_SHAPES`` as built and σ-sorted, and on
  small sorted SELL builds with and without a spill, with nrows below
  nrows_pad and on the fused (K6) path, where it is the gather alone;
* the plain K7 (the CPU route of the wrapper) against the mirror;
* ``SellMatrix.matvec``, ``spmm`` at R = 4 and the sorted ``X2Matrix``
  against the JAX containers in interpret mode, with the tolerances of
  ``test_torch_formats.py``, ``test_torch_spmm.py`` and
  ``test_torch_x2.py``;
* the sorted path's chain (K4 or K6, the spill's engine, K7; no K5, K11 or
  K15), and K7's source: plan reads before ``griddepcontrol.wait``, the
  outputs of earlier kernels after it and never through ``__ldg``, a
  launch through ``cudaLaunchKernelEx`` with the serialization attribute.

``test_torch_gpu.py`` and ``chip_smoke.py`` run the kernel on the card.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spmv_tpu
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu.x2 import X2Matrix as JaxX2
import spmv_tpu_torch
from spmv_tpu_torch import X2Matrix, device, synth
from spmv_tpu_torch.device import DevPanel
from spmv_tpu_torch.formats import split as S
from spmv_tpu_torch.formats.base import (SLICE_ROWS, TILE_COLS, build_panel_plan,
                                         cdiv)
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)
from spmv_tpu_torch.probes.common import PANEL_SHAPES
from test_torch_panel import row_ordered
from test_torch_spmm import check_columns
from test_torch_x2 import check_port

CSRC = Path(__file__).resolve().parents[1] / "spmv_tpu_torch" / "kernels" / "csrc"


def k7_mirror(invperm, slice_ptr, tile, y_sorted, nrows, part=None, spill=None):
    """Host mirror of K7's rule, one output row at a time in the working
    dtype: ``(y, split)``, with ``split[i]`` whether row i was summed from
    the partials (its slice spans more than one tile) rather than read
    from y′."""
    y = np.empty((nrows, *y_sorted.shape[1:]), y_sorted.dtype)
    split = np.zeros(nrows, bool)
    for i in range(nrows):
        p = int(invperm[i])
        s, lane = p // SLICE_ROWS, p % SLICE_ROWS
        cs, ce = slice_ptr[s] // SLICE_ROWS, slice_ptr[s + 1] // SLICE_ROWS
        if part is not None and ce > cs and cs // tile != (ce - 1) // tile:
            ta, tb = cs // tile, (ce - 1) // tile
            v = part[2 * ta + 1, lane].copy()
            for t in range(ta + 1, tb + 1):
                v = v + part[2 * t, lane]
            split[i] = True
        else:
            v = y_sorted[p].copy()
        if spill is not None:
            v = v + spill[p]
        y[i] = v
    return y, split


def parents_sequence(invperm, dev, y_sorted, nrows, part=None, spill=None):
    """What the shared panel path did before K7 took the steps over: plain
    K5 (K11, K15) into y′, the spill added in place, the gather."""
    y = y_sorted.clone()
    if part is not None:
        y = P.panel_fixup_reference(dev, y, part)
    if spill is not None:
        y.add_(spill)
    return y[invperm[:nrows].long()]


def sigma_sorted(trip, sigma=128):
    """The σ-sort's permutation applied whatever it saves (rows stable-
    sorted by descending length within windows of σ): ``(invperm,
    rows_sorted, nrows_pad)``."""
    info, r, _, _ = trip
    nrows_pad = cdiv(max(info.nrows, 1), sigma) * sigma
    lengths = np.zeros(nrows_pad, np.int64)
    lengths[:info.nrows] = np.bincount(r, minlength=info.nrows)
    order = np.argsort(-lengths.reshape(-1, sigma), axis=1, kind="stable")
    perm = (np.arange(nrows_pad // sigma)[:, None] * sigma + order).reshape(-1)
    invperm = np.empty_like(perm)
    invperm[perm] = np.arange(nrows_pad)
    return invperm, invperm[np.asarray(r, np.int64)], nrows_pad


def shape_panel(name, sort, tile, dtype=np.float32):
    """A ``PANEL_SHAPES`` case as a panel plan in sorted row space (or as
    built, with the identity), its invperm and nrows."""
    info, r, c, v = PANEL_SHAPES[name]()
    if sort:
        invperm, rs, npad = sigma_sorted((info, r, c, v))
    else:
        invperm, rs, npad = np.arange(info.nrows), np.asarray(r), info.nrows
    srt = row_ordered((info, rs, c, v))
    dev = DevPanel.from_plan(build_panel_plan(npad, info.ncols, *srt[1:], tile=tile,
                                              dtype=dtype), "cpu")
    return dev, torch.from_numpy(invperm.astype(np.int32)), info.nrows


def check_rule(dev, invperm, nrows, x, spill_y=None):
    """The mirror against the plan's split slices, the parent's sequence
    and the plain K7, bit for bit, with and without the partials, and with
    y′'s rows of split slices NaN."""
    y, part = P.panel_spmv_partials_reference(dev, x)
    ip, sp = invperm.numpy(), dev.slice_ptr.numpy().astype(np.int64)
    split_slices = set(dev.split_slices.tolist())
    spills = (None,) if spill_y is None else (None, spill_y)
    for spill in spills:
        sn = None if spill is None else spill.numpy()
        got, used = k7_mirror(ip, sp, dev.tile, y.numpy(), nrows, part.numpy(), sn)
        assert np.array_equal(used, [int(p) // SLICE_ROWS in split_slices
                                     for p in ip[:nrows]])
        want = parents_sequence(invperm, dev, y, nrows, part, spill)
        assert got.tobytes() == want.numpy().tobytes()
        plain = P.inverse_permute_reference(invperm, y, nrows, dev=dev, part=part,
                                            spill=spill)
        assert plain.numpy().tobytes() == got.tobytes()
        wrapper = (X.inverse_permute_x2 if y.dtype == torch.float64 else
                   P.inverse_permute)
        assert wrapper(invperm, y, nrows, dev=dev, part=part,
                       spill=spill).numpy().tobytes() == got.tobytes()
        # y′'s rows of split slices are never read
        poisoned = y.clone()
        rows = torch.tensor(sorted(split_slices), dtype=torch.long)
        rows = (rows[:, None] * SLICE_ROWS + torch.arange(SLICE_ROWS)).reshape(-1)
        poisoned[rows[rows < dev.nrows]] = float("nan")
        again, _ = k7_mirror(ip, sp, dev.tile, poisoned.numpy(), nrows, part.numpy(), sn)
        assert again.tobytes() == got.tobytes()
        assert P.inverse_permute_reference(
            invperm, poisoned, nrows, dev=dev, part=part,
            spill=spill).numpy().tobytes() == got.tobytes()
        # without partials it is the gather (plus the spill)
        bare, none = k7_mirror(ip, sp, dev.tile, y.numpy(), nrows, None, sn)
        assert not none.any()
        assert bare.tobytes() == parents_sequence(invperm, dev, y, nrows,
                                                  None, spill).numpy().tobytes()
    return len(split_slices)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("tile", [TILE_COLS, 3])
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_k7_rule_on_the_panel_shapes(name, sort, tile, R):
    dev, invperm, nrows = shape_panel(name, sort, tile)
    rng = np.random.default_rng(3)
    tail = () if R == 1 else (R,)
    x = torch.from_numpy(rng.standard_normal((dev.ncols, *tail)).astype(np.float32))
    spill = torch.from_numpy(rng.standard_normal((dev.nrows, *tail)).astype(np.float32))
    nsplit = check_rule(dev, invperm, nrows, x, spill)
    assert nsplit or tile == TILE_COLS


def test_k7_rule_in_float64():
    dev, invperm, nrows = shape_panel("hub_slice", True, TILE_COLS, np.float64)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(dev.ncols))
    spill = torch.from_numpy(rng.standard_normal(dev.nrows))
    assert check_rule(dev, invperm, nrows, x, spill)


@pytest.mark.parametrize("tile", [TILE_COLS, 3])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_epilogue_bytes_count_what_k7_moves(name, tile):
    """``bounds.epilogue_bytes``, the bytes K7 with the partials must move,
    against a count row by row of what the mirror's rule reads: invperm
    and slice_ptr, the partial slots of a split slice's row (never its row
    of y′), else y′'s row, the spill's row where there is one, and the row
    of y written."""
    from spmv_tpu_torch.probes import bounds as B

    for dtype in (np.float32, np.float64):
        dev, invperm, nrows = shape_panel(name, True, tile, dtype)
        es = np.dtype(dtype).itemsize
        sp = dev.slice_ptr.numpy().astype(np.int64)
        slots = 0
        for p in invperm.numpy()[:nrows]:
            cs, ce = sp[p // SLICE_ROWS] // SLICE_ROWS, sp[p // SLICE_ROWS + 1] // SLICE_ROWS
            split = ce > cs and cs // tile != (ce - 1) // tile
            slots += (ce - 1) // tile - cs // tile + 1 if split else 1
        for R in (1, 3):
            for spill in (False, True):
                want = (sp.size * 4 + nrows * 4
                        + (slots + nrows * (2 if spill else 1)) * es * R)
                assert B.epilogue_bytes(dev, invperm, nrows, R, spill) == want


def hyb_power_law():
    return synth.power_law(n=2048, seed=7)  # hyb when the dispatch is free


def band_1024():
    return synth.synthetic_cant(n=1024, avg_nnz_per_row=16, bandwidth=60, seed=5)


# small sorted SELL builds: (matrix, split, dispatch price zeroed, fused
# plan bound: 0 never, None the default, 1 << 40 always): a sorted panel
# with a spill (hyb) on K4 and on K6, a pure panel with nrows below
# nrows_pad, the band matrix on K4 and on K6
SELL_BUILDS = {
    "hyb_spill": (hyb_power_law, True, True, 0),
    "hyb_fused": (hyb_power_law, True, True, 1 << 40),
    "pure_power_law": (lambda: synth.power_law(n=3000, seed=2), False, False, 0),
    "band_tiles": (band_1024, True, False, 0),
    "band_fused": (band_1024, True, False, None),
}


def sell_build(name, monkeypatch, x2=False):
    gen, split, free, fused_max = SELL_BUILDS[name]
    if free:
        monkeypatch.setattr(S, "_DISPATCH_S", 0.0)
    if fused_max is not None:
        monkeypatch.setattr(device, "FUSED_STREAM_BYTES_MAX", fused_max)
    info, r, c, v = gen()
    if x2:
        v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
        a = X2Matrix.from_coo("sell", info.nrows, info.ncols, r, c, v, split=split,
                              device="cpu")
    else:
        a = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v,
                                    split=split, device="cpu")
    assert a.sorted_rows
    assert (a.dev_spill is not None) == free
    if not x2:
        assert a.dev.fused == name.endswith("_fused")
    return a, (info, r, c, v)


@pytest.mark.parametrize("name", sorted(SELL_BUILDS))
def test_k7_rule_on_sorted_sell_builds(name, monkeypatch):
    a, (info, r, c, v) = sell_build(name, monkeypatch)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(info.ncols).astype(np.float32))
    spill = None
    if a.dev_spill is not None:
        spill = E.segmented_spmv(a.dev_spill, x)
    check_rule(a.dev, a.invperm_dev, a.nrows, x, spill)
    if name == "pure_power_law":
        assert a.nrows < a.dev.nrows
    if a.dev.fused:  # K6's y′: K7 takes no partials, a gather (+ the spill)
        y6 = P.panel_spmv_fused(a.dev, x)
        want = parents_sequence(a.invperm_dev, a.dev, y6, a.nrows, None, spill)
        assert a.matvec(x).numpy().tobytes() == want.numpy().tobytes()
    else:
        y4, part = P.panel_spmv_partials(a.dev, x)
        want = parents_sequence(a.invperm_dev, a.dev, y4, a.nrows, part, spill)
        assert a.matvec(x).numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("name", ["hyb_spill", "pure_power_law"])
def test_sorted_spmm_is_the_parents_sequence(name, R, monkeypatch):
    a, (info, r, c, v) = sell_build(name, monkeypatch)
    Xh = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(np.float32)
    X = torch.from_numpy(Xh)
    Y10, part = P.panel_spmv_multi_partials(a.dev, X)
    spill = (E.segmented_spmv_multi(a.dev_spill, X) if a.dev_spill is not None
             else None)
    want = parents_sequence(a.invperm_dev, a.dev, Y10, a.nrows, part, spill)
    got = spmv_tpu_torch.spmm(a, Xh)
    assert got.shape == (info.nrows, R)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    check_rule(a.dev, a.invperm_dev, a.nrows, X, spill)


@pytest.mark.parametrize("name", ["hyb_spill", "pure_power_law", "band_tiles"])
def test_sorted_x2_is_the_parents_sequence(name, monkeypatch):
    a, (info, r, c, v) = sell_build(name, monkeypatch, x2=True)
    xh = np.random.default_rng(6).standard_normal(info.ncols)
    x = torch.from_numpy(xh)
    y14, part = X.panel_spmv_x2_partials(a.dev, x)
    spill = X.segmented_spmv_x2(a.dev_spill, x) if a.dev_spill is not None else None
    want = parents_sequence(a.invperm_dev, a.dev, y14, a.nrows, part, spill)
    got = a.matvec(xh)
    assert got.dtype == torch.float64
    assert got.numpy().tobytes() == want.numpy().tobytes()
    check_port(got, info, r, c, v, xh)


# ---------------------------------------------------------------- against JAX


@functools.cache
def jax_sell(name, x2=False):
    gen = SELL_BUILDS[name][0]
    info, r, c, v = gen()
    if x2:
        v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
        return JaxX2.from_coo("sell", info.nrows, info.ncols, r, c, v)
    return spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v,
                             split=SELL_BUILDS[name][1])


@pytest.mark.parametrize("name", ["hyb_spill", "pure_power_law", "band_fused"])
def test_sorted_sell_matvec_matches_jax(name, monkeypatch):
    """``SellMatrix.matvec`` (K4 or K6, the spill, K7) against JAX's SELL
    and the oracle, within the sum of both tolerances
    (``test_torch_formats.py``)."""
    ref = jax_sell(name)
    a, (info, r, c, v) = sell_build(name, monkeypatch)
    x = np.random.default_rng(7).standard_normal(info.ncols).astype(np.float32)
    y, y_jax = a.matvec(x).numpy(), np.asarray(ref.matvec(x))
    k = int(np.bincount(r, minlength=info.nrows).max())
    row_abs = row_scale(info.nrows, r, c, v, x)
    assert kernel_check(golden_spmv(info.nrows, r, c, v, x), y, row_abs, k).ok
    bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
             + engine_rel_tol(k) * container_scale(ref, x, row_abs))
    assert (np.abs(y.astype(np.float64) - y_jax) <= bound).all()


@pytest.mark.parametrize("name", ["hyb_spill", "pure_power_law"])
def test_sorted_spmm_matches_jax(name, monkeypatch):
    """``spmm`` at R = 4 on a sorted SELL (K10, the spill's K8 + K9, K7)
    against JAX's ``spmm`` column by column (``test_torch_spmm.py``)."""
    ref = jax_sell(name)
    a, (info, r, c, v) = sell_build(name, monkeypatch)
    X = np.random.default_rng(8).standard_normal((info.ncols, 4)).astype(np.float32)
    Y = spmv_tpu_torch.spmm(a, X).numpy()
    check_columns(Y, np.asarray(spmv_tpu.spmm(ref, X)), ref, info, r, c, v, X)


@pytest.mark.parametrize("name", ["hyb_spill", "pure_power_law", "band_tiles"])
def test_sorted_x2_matches_jax(name, monkeypatch):
    """The sorted ``X2Matrix`` (K14, the spill's K12 + K13, K7 in fp64)
    against JAX's f32x2 SELL, a dense fp64 product and the oracle
    (``test_torch_x2.py``)."""
    a, (info, r, c, v) = sell_build(name, monkeypatch, x2=True)
    x = np.random.default_rng(9).standard_normal(info.ncols)
    check_port(a.matvec(x), info, r, c, v, x,
               np.asarray(jax_sell(name, x2=True).matvec(x)))


# ---------------------------------------------------------------- the chain


def calls_of(monkeypatch, module, names):
    calls = []
    for n in names:
        orig = getattr(module, n)
        monkeypatch.setattr(module, n, lambda *a, _o=orig, _n=n, **k:
                            calls.append(_n) or _o(*a, **k))
    return calls


@pytest.mark.parametrize("name", sorted(SELL_BUILDS))
def test_the_sorted_path_runs_the_tile_kernel_the_spill_then_k7(name, monkeypatch):
    """matvec: K4 (K6 on a small plan), the spill's engine, K7, in that
    order, and never K5; spmm: K10, the spill's, K7, never K11; the x2
    matvec: K14, the spill's, K7, never K15."""
    a, (info, r, c, v) = sell_build(name, monkeypatch)
    spill = ["spill"] if a.dev_spill is not None else []
    calls = calls_of(monkeypatch, P, ("panel_spmv_partials", "panel_spmv_fused",
                                      "panel_fixup", "panel_spmv_multi_partials",
                                      "panel_fixup_multi", "inverse_permute"))
    for fn in ("segmented_spmv", "segmented_spmv_multi"):
        monkeypatch.setattr(P, fn, lambda *args, _o=getattr(P, fn):
                            calls.append("spill") or _o(*args))
    a.matvec(np.ones(info.ncols))
    tiles = "panel_spmv_fused" if a.dev.fused else "panel_spmv_partials"
    assert calls == [tiles, *spill, "inverse_permute"]
    calls.clear()
    spmv_tpu_torch.spmm(a, np.ones((info.ncols, 4)))
    assert calls == ["panel_spmv_multi_partials", *spill, "inverse_permute"]
    b, _ = sell_build(name, monkeypatch, x2=True)
    calls = calls_of(monkeypatch, X, ("panel_spmv_x2_partials", "panel_fixup_x2",
                                      "segmented_spmv_x2", "inverse_permute_x2"))
    b.matvec(np.ones(info.ncols))
    assert calls == ["panel_spmv_x2_partials",
                     *(["segmented_spmv_x2"] if spill else []), "inverse_permute_x2"]


def test_k7_wrappers_refuse_mismatched_inputs(monkeypatch):
    a, _ = sell_build("hyb_spill", monkeypatch)
    y, part = P.panel_spmv_partials(a.dev, torch.ones(a.ncols))
    ip, n = a.invperm_dev, a.nrows
    with pytest.raises(ValueError, match="plan they belong to"):
        P.inverse_permute(ip, y, n, part=part)
    with pytest.raises(ValueError, match="plan they belong to"):
        P.inverse_permute(ip, y, n, dev=a.dev, part=part[:-1])
    with pytest.raises(ValueError, match="spill"):
        P.inverse_permute(ip, y, n, spill=y[:-1])
    with pytest.raises(ValueError, match="do not match"):
        P.inverse_permute(ip, torch.ones(ip.numel(), 9), n)
    with pytest.raises(ValueError, match="expected contiguous torch.float32"):
        P.inverse_permute(ip, y, n, dev=a.dev, part=part, spill=y.double())
    with pytest.raises(ValueError, match="plan holds torch.float32"):
        X.inverse_permute_x2(ip, y.double(), n, dev=a.dev, part=part.double())


# ---------------------------------------------------------------- the source


def body_of(src: str, signature: str) -> str:
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_k7_reads_the_plan_before_it_waits_and_launches_as_a_dependent():
    """K7 reads invperm (or, on the split slices' grid, split_slices) and
    its slice's two slice_ptr entries, then ``griddepcontrol.wait``, then
    y′, the partials and the spill, never through the read-only path; both
    entry points launch each of its grids through ``launch_programmatic``
    (``cudaLaunchKernelEx`` with the programmatic-serialization
    attribute), and the panel tile kernel ahead of it releases it."""
    src = (CSRC / "panel_spmv.cu").read_text()
    body = body_of(src, "inverse_permute_kernel(const int*")
    wait = body.index('asm volatile("griddepcontrol.wait;" ::: "memory")')
    for read in ("__ldg(invperm + row)", "__ldg(split_slices + i / kC)",
                 "split_tiles(slice_ptr, s, ta, tb)",
                 "split_tiles(slice_ptr, p / kC, ta, tb)"):
        assert body.index(read) < wait, read
    tiles = body_of(src, "void split_tiles(const int* __restrict__ slice_ptr")
    assert "__ldg(slice_ptr + s)" in tiles and "__ldg(slice_ptr + s + 1)" in tiles
    rule = body_of(src, "void sum_split_row(const T* part")
    for name, where in (("part", rule), ("y_sorted", body), ("spill", body)):
        assert f"load_row<R, CoherentLoad>({name} +" in where, name
        assert f"__ldg({name}" not in body + rule, name
        assert re.search(rf"const T\* {name},", body), name  # no __restrict__
    assert body.index("sum_split_row<R>(part,") > wait
    assert body.index("load_row<R, CoherentLoad>(y_sorted +") > wait
    # the loads after the wait are plain (coherent) ones
    rows = (CSRC / "x_rows.cuh").read_text()
    coherent = rows[rows.index("struct CoherentLoad {"):]
    coherent = coherent[:coherent.index("\n};\n")]
    assert "__ldg" not in coherent and "return *p;" in coherent
    loads = body_of(rows, "__device__ __forceinline__ void load_row(")
    assert "__ldg" not in loads and "__restrict__" not in loads
    launcher = body_of(src, "int launch_inverse_permute(")
    assert "launch_programmatic(" in launcher and "<<<" not in launcher
    for grid in ("kSorted", "kIdentity", "kSplitRows"):
        assert f"launch(inverse_permute_kernel<T, R, {grid}>" in launcher, grid
    entries = src[src.index('extern "C" {'):]
    assert re.findall(r"launch_inverse_permute<(\w+), (\w+)>", entries) == [
        ("float", "R"), ("double", "1")]
    assert "K7_CASE(1) K7_CASE(2) K7_CASE(3) K7_CASE(4)" in entries
    helper = body_of((CSRC / "seg_tile.cuh").read_text(), "int launch_programmatic(")
    assert "cudaLaunchKernelEx(" in helper and "<<<" not in helper
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in helper
    assert "programmaticStreamSerializationAllowed = 1" in helper
    # the trigger lives in the tile body that K4, K10, K14 (and K6's tile
    # mode) run, once
    tile_src = (CSRC / "panel_tile.cuh").read_text()
    tiles = body_of(tile_src, "void panel_tile_body(const int*")
    assert tiles.count('asm volatile("griddepcontrol.launch_dependents;")') == 1
    assert "panel_tile_body<T, kX, R>(" in body_of(tile_src,
                                                   "panel_spmv_tiles_kernel(const int*")

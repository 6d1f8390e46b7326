"""The PyTorch port's panel engine (``formats.base.build_panel_plan``,
``formats.split``, ``kernels.panel``) and its ELL, SELL-C-σ and HYB
containers against the JAX package, on the same seeded triplets.

JAX runs as its own tests run it (Pallas interpret mode on the CPU); the
port's wrappers get CPU tensors and run their plain PyTorch versions (the
CUDA kernels are held against those on the card, ``test_torch_gpu.py``).
Port and JAX agree within the sum of both tolerances (see
``test_torch_engines.py``); the format arrays, the σ permutation and the
unpermute gather agree bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.device import x_to_table, y_from_padded
from spmv_tpu.kernels.engines import inverse_permute_blocks as jax_permute
from spmv_tpu.kernels.engines import panel_spmv_fused as jax_panel_fused
from spmv_tpu.kernels.engines import panel_spmv_partials as jax_panel_partials
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu_torch import device, synth
from spmv_tpu_torch.device import DevPanel
from spmv_tpu_torch.formats import split as S
from spmv_tpu_torch.formats.base import (PAD_COL, SLICE_ROWS, TILE_COLS,
                                         build_panel_plan)
from spmv_tpu_torch.formats.sell import sigma_sort_tables
from spmv_tpu_torch.io.mmio import MMInfo
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)


def wide_rows(seed=0):
    """Rows of 1500 and 2600 elements in slices of short rows (slices that
    span many 32-column tiles), empty slices between, and a ragged last
    slice."""
    rng = np.random.default_rng(seed)
    lengths = np.zeros(150, dtype=np.int64)
    lengths[:40] = rng.integers(0, 5, 40)
    lengths[7], lengths[100] = 1500, 2600
    lengths[130:] = rng.integers(1, 40, 20)
    rows = np.repeat(np.arange(lengths.size), lengths)
    info = MMInfo("matrix", "coordinate", "real", "general", lengths.size, 60,
                  rows.size)
    return (info, rows, rng.integers(0, 60, rows.size),
            rng.standard_normal(rows.size))


CASES = {
    **{f"edge_{n}": (lambda n=n: synth.edge_case(n)) for n in sorted(synth.EDGE_CASES)},
    "random_500x300": lambda: synth.random_coo(500, 300, 4000, seed=3),
    "band_1024": lambda: synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                              bandwidth=60, seed=5),
    "power_law_2048": lambda: synth.power_law(n=2048, seed=7),
    "wide_rows": wide_rows,
}
TILES = [TILE_COLS, 3, 1]


def row_ordered(trip):
    info, r, c, v = trip
    order = np.lexsort((c, r))
    return info, np.asarray(r)[order], np.asarray(c)[order], np.asarray(v)[order]


def panel_of(trip, tile=TILE_COLS):
    info, r, c, v = row_ordered(trip)
    return build_panel_plan(info.nrows, info.ncols, r, c, v, tile=tile)


def max_row(nrows, r):
    return int(np.bincount(r, minlength=max(nrows, 1)).max()) if r.size else 1


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_panel_plan_slots_and_tile_schedule(case, tile):
    info, r, c, v = row_ordered(CASES[case]())
    p = build_panel_plan(info.nrows, info.ncols, r, c, v, tile=tile)
    C = SLICE_ROWS
    lengths = np.bincount(r, minlength=info.nrows) if r.size else np.zeros(info.nrows, int)
    nslices = -(-info.nrows // C)
    padded = np.zeros(nslices * C, np.int64)
    padded[:info.nrows] = lengths
    assert p.widths.tolist() == padded.reshape(nslices, C).max(axis=1, initial=0).tolist()
    assert p.slice_ptr.tolist() == [0] + np.cumsum(C * p.widths).tolist()
    assert (p.slice_ptr % C == 0).all()
    # every element at slice_ptr[s] + r % 32 + 32·k, every other slot a pad
    # (value 0, column PAD_COL)
    vals = np.zeros(p.nslots, np.float32)
    cols = np.full(p.nslots, PAD_COL, np.int32)
    for e in range(r.size):
        k = e - np.searchsorted(r, r[e])  # rank within the row
        pos = p.slice_ptr[r[e] // C] + r[e] % C + C * k
        vals[pos], cols[pos] = v[e], c[e]
    assert p.vals.tobytes() == vals.tobytes() and p.cols.tobytes() == cols.tobytes()
    assert p.vals.dtype == np.float32 and p.cols.dtype == np.int32
    assert (p.nnz, p.max_width) == (r.size, int(lengths.max(initial=0)))
    # the slice of each tile's first column; split slices by brute force
    scol = p.slice_ptr // C
    assert p.tile_slice0.size == p.ntiles + 1
    for t in range(p.ntiles):
        s = p.tile_slice0[t]
        assert scol[s] <= t * tile < scol[s + 1]
    col_slice = np.repeat(np.arange(nslices), p.widths)
    split = [s for s in range(nslices)
             if np.unique(np.flatnonzero(col_slice == s) // tile).size > 1]
    assert p.split_slices.tolist() == split


def test_panel_plan_refuses_malformed_input():
    r, c, v = np.array([0, 1, 1]), np.array([0, 1, 2]), np.ones(3)
    with pytest.raises(ValueError, match="row order"):
        build_panel_plan(2, 3, r[::-1], c, v)
    with pytest.raises(ValueError, match="column"):
        build_panel_plan(2, 2, r, c, v)
    with pytest.raises(ValueError, match="row index"):
        build_panel_plan(1, 3, r, c, v)
    with pytest.raises(ValueError, match="tile"):
        build_panel_plan(2, 3, r, c, v, tile=0)
    with pytest.raises(ValueError, match="differ"):
        build_panel_plan(2, 3, r, c[:2], v)


def test_panel_plan_refuses_slot_counts_past_int32(monkeypatch):
    from spmv_tpu_torch.formats import base

    monkeypatch.setattr(base, "_INT32_MAX", 40 * SLICE_ROWS)
    r = np.zeros(8, np.int64)
    build_panel_plan(1, 9, r, np.arange(8), np.ones(8), tile=1)  # 256 slots
    with pytest.raises(ValueError, match="int32"):
        build_panel_plan(1, 41, np.zeros(40, np.int64), np.arange(40),
                         np.ones(40), tile=1)


def test_device_panel_bytes_and_types():
    p = panel_of(CASES["band_1024"]())
    dev = DevPanel.from_plan(p, "cpu")
    arrays = (p.slice_ptr.astype(np.int32), p.vals, p.cols, p.tile_slice0,
              p.tile_own0, p.split_slices)
    assert dev.stream_bytes == sum(a.nbytes for a in arrays)
    assert dev.slice_ptr.dtype == dev.cols.dtype == torch.int32
    assert (dev.nslices, dev.nslots, dev.ntiles, dev.nsplit) == (
        p.nslices, p.nslots, p.ntiles, p.split_slices.size)
    assert dev.fused == (dev.stream_bytes <= device.FUSED_STREAM_BYTES_MAX)


# ---------------------------------------------------------------- plain kernels


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_against_the_oracle(case, tile):
    """Plain K4 + K5 (many tile boundaries at tile 1 and 3) and plain K6."""
    info, r, c, v = CASES[case]()
    dev = DevPanel.from_plan(panel_of((info, r, c, v), tile), "cpu")
    xh = np.random.default_rng(11).standard_normal(info.ncols).astype(np.float32)
    x = torch.from_numpy(xh)
    before = dict(E.LAUNCHES)
    y45 = P.panel_fixup(dev, *P.panel_spmv_partials(dev, x))
    y6 = P.panel_spmv_fused(dev, x)
    assert E.LAUNCHES == before  # CPU tensors: the plain versions ran
    expected = golden_spmv(info.nrows, r, c, v.astype(np.float32), xh)
    scale = row_scale(info.nrows, r, c, v.astype(np.float32), xh)
    k = max_row(info.nrows, r)
    for y in (y45, y6):
        assert y.dtype == torch.float32 and y.shape == (info.nrows,)
        assert kernel_check(expected, y.numpy(), scale, k).ok


def test_wide_slice_partials_sum_over_a_tile_range():
    info, r, c, v = wide_rows()
    dev = DevPanel.from_plan(panel_of((info, r, c, v), tile=4), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        info.ncols).astype(np.float32))
    y, part = P.panel_spmv_partials_reference(dev, x)
    s = 100 // SLICE_ROWS  # the slice of the 2600-element row
    scol = dev.slice_ptr.long() // SLICE_ROWS
    ta, tb = int(scol[s] // 4), int((scol[s + 1] - 1) // 4)
    assert tb - ta > 100 and s in dev.split_slices.tolist()
    assert y[100] == 0  # K4 leaves a split slice to K5
    slots = [2 * ta + 1] + [2 * t for t in range(ta + 1, tb + 1)]
    y = P.panel_fixup_reference(dev, y, part)
    assert float(y[100]) == pytest.approx(float(part[slots, 100 % 32].sum()), rel=1e-6)
    prod = (v.astype(np.float32) * x.numpy()[c]).astype(np.float64)
    assert float(y[100]) == pytest.approx(prod[r == 100].sum(), rel=1e-4)


@pytest.mark.parametrize("case", ["power_law_2048", "random_500x300", "wide_rows"])
def test_plain_inverse_permute_undoes_the_sort(case):
    info, r, c, v = CASES[case]()
    rows_sorted, sorted_, perm, invperm, nrows_pad = sigma_sort_tables(
        r, info.nrows, 128)
    assert sorted_ and nrows_pad % 128 == 0
    assert np.array_equal(perm[invperm], np.arange(nrows_pad))
    y_sorted = torch.from_numpy(np.random.default_rng(1).standard_normal(
        nrows_pad).astype(np.float32))
    y = P.inverse_permute(torch.from_numpy(invperm.astype(np.int32)), y_sorted,
                          info.nrows)
    assert y.shape == (info.nrows,)
    assert torch.equal(y, y_sorted[torch.from_numpy(invperm[:info.nrows])])
    # a product in sorted space, unpermuted, is the product in row space
    xh = np.random.default_rng(3).standard_normal(info.ncols).astype(np.float32)
    srt = row_ordered((MMInfo("matrix", "coordinate", "real", "general",
                              nrows_pad, info.ncols, r.size), rows_sorted, c, v))
    dev = DevPanel.from_plan(build_panel_plan(nrows_pad, info.ncols, *srt[1:]), "cpu")
    y = P.inverse_permute(torch.from_numpy(invperm.astype(np.int32)),
                          P.panel_spmv(dev, torch.from_numpy(xh)), info.nrows)
    assert kernel_check(golden_spmv(info.nrows, r, c, v.astype(np.float32), xh),
                        y.numpy(), row_scale(info.nrows, r, c, v, xh),
                        max_row(info.nrows, r)).ok


def test_wrappers_refuse_mismatched_inputs():
    dev = DevPanel.from_plan(panel_of(CASES["edge_ragged"]()), "cpu")
    x = torch.ones(dev.ncols)
    with pytest.raises(ValueError, match="shape"):
        P.panel_spmv_fused(dev, x[:-1])
    with pytest.raises(ValueError, match="float32"):
        P.panel_spmv_partials(dev, x.double())
    y, part = P.panel_spmv_partials(dev, x)
    with pytest.raises(ValueError, match="does not match"):
        P.panel_fixup(dev, y, part[:-1])
    with pytest.raises(ValueError, match="int32"):
        P.inverse_permute(torch.arange(4), torch.ones(4), 4)
    with pytest.raises(ValueError, match="do not match"):
        P.inverse_permute(torch.arange(4, dtype=torch.int32), torch.ones(4), 5)


@pytest.mark.parametrize("fused", [True, False])
def test_panel_spmv_dispatches_on_plan_bytes(monkeypatch, fused):
    calls = []
    for fn in ("panel_spmv_fused", "panel_spmv_partials"):
        orig = getattr(P, fn)
        monkeypatch.setattr(P, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    monkeypatch.setattr(device, "FUSED_STREAM_BYTES_MAX", 1 << 40 if fused else 0)
    info, r, c, v = CASES["band_1024"]()
    dev = DevPanel.from_plan(panel_of((info, r, c, v)), "cpu")
    xh = np.random.default_rng(4).standard_normal(info.ncols).astype(np.float32)
    y = P.panel_spmv(dev, torch.from_numpy(xh))
    assert calls == (["panel_spmv_fused"] if fused else ["panel_spmv_partials"])
    assert kernel_check(golden_spmv(info.nrows, r, c, v, xh), y.numpy(),
                        row_scale(info.nrows, r, c, v, xh), max_row(info.nrows, r)).ok


# ---------------------------------------------------------------- against JAX


JAX_MATRICES = ["edge_empty_rows", "edge_ragged", "edge_all_empty",
                "edge_rectangular", "random_500x300", "band_1024",
                "power_law_2048"]


@functools.cache
def jax_panel(name):
    """Triplets, x, and the JAX panel engine's two paths on the pure-panel
    ELL container (cached: interpret mode costs about half a second)."""
    info, r, c, v = CASES[name]()
    x = np.random.default_rng(17).standard_normal(info.ncols).astype(np.float32)
    a = spmv_tpu.from_coo("ell", info.nrows, info.ncols, r, c, v, split=False)
    x2d = x_to_table(x, info.ncols)
    y_partials = np.asarray(y_from_padded(jax_panel_partials(a.dev, x2d), info.nrows))
    y_fused = np.asarray(y_from_padded(jax_panel_fused(a.dev, x2d), info.nrows))
    row_abs = row_scale(info.nrows, r, c, v, x)
    k = max_row(info.nrows, r)
    jax_bound = KERNEL_TOL_ABS + engine_rel_tol(k) * container_scale(a, x, row_abs)
    port_bound = KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
    return info, r, c, v, x, y_partials, y_fused, jax_bound + port_bound


@pytest.mark.parametrize("tile", [TILE_COLS, 2])
@pytest.mark.parametrize("name", JAX_MATRICES)
def test_panel_engine_matches_jax(name, tile):
    """Plain K4 + K5 against ``panel_spmv_partials`` (B4 + B2) and plain K6
    against ``panel_spmv_fused`` (B5)."""
    info, r, c, v, x, y_partials, y_fused, bound = jax_panel(name)
    dev = DevPanel.from_plan(panel_of((info, r, c, v), tile), "cpu")
    xt = torch.from_numpy(x)
    y45 = P.panel_fixup(dev, *P.panel_spmv_partials(dev, xt)).numpy()
    y6 = P.panel_spmv_fused(dev, xt).numpy()
    assert (np.abs(y45.astype(np.float64) - y_partials) <= bound).all()
    assert (np.abs(y6.astype(np.float64) - y_fused) <= bound).all()


@pytest.mark.parametrize("case", ["power_law_2048", "random_500x300"])
def test_inverse_permute_matches_jax(case):
    """K7's plain version against ``inverse_permute_blocks`` (B6) on the
    same σ permutation: a gather, so bit for bit."""
    info, r, c, v = CASES[case]()
    ref = spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v, split=False)
    a = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v,
                                split=False, device="cpu")
    assert ref.sorted_rows and a.sorted_rows and np.array_equal(ref.perm, a.perm)
    npad = a.invperm_dev.numel()
    y_sorted = np.random.default_rng(6).standard_normal(npad).astype(np.float32)
    y2d = y_sorted.reshape(-1, 128)
    if y2d.shape[0] < 8:  # the JAX epilogue slices 8-row windows
        y2d = np.vstack([y2d, np.zeros((8 - y2d.shape[0], 128), np.float32)])
    want = np.asarray(jax_permute(ref._perm_whi, ref._perm_idx, y2d)).reshape(-1)
    got = P.inverse_permute(a.invperm_dev, torch.from_numpy(y_sorted), info.nrows)
    assert got.numpy().tobytes() == want[:info.nrows].tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_ell_arrays_match_jax_bit_for_bit(case):
    info, r, c, v = CASES[case]()
    a = spmv_tpu_torch.EllMatrix.from_coo(info.nrows, info.ncols, r, c, v,
                                          device="cpu")
    ref = spmv_tpu.from_coo("ell", info.nrows, info.ncols, r, c, v)
    assert (a.K, a.row_length_stats, a.nnz) == (ref.K, ref.row_length_stats, ref.nnz)
    for mine, theirs in zip(a.ell_arrays(), ref.ell_arrays()):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.tobytes() == theirs.tobytes()
    data, cols = a.ell_arrays()
    x = np.random.default_rng(5).standard_normal(info.ncols)
    assert np.allclose(a.cpu_spmv(data, cols, x),
                       golden_spmv(info.nrows, r, c, v, x), rtol=1e-12, atol=1e-12)


# (matrix, split, whether both sort): one where both sort, one where neither
SORT_CASES = [("power_law_2048", False, True), ("random_500x300", False, True),
              ("power_law_2048", True, False), ("edge_dense_small", False, False),
              ("sorted_999", False, False)]


@pytest.mark.parametrize("case,split,both_sort", SORT_CASES)
def test_sell_arrays_and_perm_match_jax_on_the_same_decision(case, split, both_sort):
    if case == "sorted_999":
        info, r, c, v = synth.synthetic_cant(n=999, sorted_by_row_length=True, seed=2)
    else:
        info, r, c, v = CASES[case]()
    a = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v,
                                split=split, device="cpu")
    ref = spmv_tpu.from_coo("sell", info.nrows, info.ncols, r, c, v, split=split)
    assert a.sorted_rows == ref.sorted_rows == both_sort
    assert np.array_equal(a.perm, ref.perm) and a.perm.dtype == ref.perm.dtype
    assert a.slice_widths.tobytes() == ref.slice_widths.tobytes()
    for mine, theirs in zip(a.sell_arrays(), ref.sell_arrays()):
        assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()
    x = np.random.default_rng(8).standard_normal(info.ncols)
    assert np.allclose(a.cpu_spmv(*a.sell_arrays(), a.perm, x, info.nrows),
                       golden_spmv(info.nrows, r, c, v, x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sigma", [0, -128, 64, 100, 128, 256, 640, 1024, 1152, 2048])
def test_sigma_accepted_and_refused_as_in_jax(sigma):
    info, r, c, v = synth.edge_case("ragged")

    def outcome(make):
        try:
            make()
        except ValueError as e:
            return str(e)
        return "ok"

    port = outcome(lambda: spmv_tpu_torch.from_coo(
        "sell", info.nrows, info.ncols, r, c, v, sigma=sigma, device="cpu"))
    jax = outcome(lambda: spmv_tpu.from_coo("sell", info.nrows, info.ncols, r,
                                            c, v, sigma=sigma))
    assert port == jax


@pytest.mark.parametrize("fmt", ["ell", "sell", "hyb"])
@pytest.mark.parametrize("case", ["random_500x300", "band_1024", "wide_rows"])
def test_to_coo_is_the_jax_triplet_set(fmt, case):
    info, r, c, v = CASES[case]()
    a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    ref = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)

    def as_set(t):
        rows, cols, vals = t
        order = np.lexsort((vals, cols, rows))
        return rows[order], cols[order], vals[order]

    for mine, theirs in zip(as_set(a.to_coo()), as_set(ref.to_coo())):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


# ---------------------------------------------------------------- ingest


def test_from_ell_round_trip():
    info, r, c, v = synth.random_coo(80, 70, 600, seed=2)
    a = spmv_tpu_torch.EllMatrix.from_coo(info.nrows, info.ncols, r, c, v,
                                          device="cpu")
    data, cols = a.ell_arrays()
    b = spmv_tpu_torch.EllMatrix.from_ell(info.nrows, info.ncols, data, cols,
                                          device="cpu")
    ref = spmv_tpu.formats.ell.EllMatrix.from_ell(info.nrows, info.ncols, data, cols)
    for t in (b.to_coo(), ref.to_coo()):
        for mine, theirs in zip(a.to_coo(), t):
            assert np.array_equal(mine, theirs)
    x = np.random.default_rng(1).standard_normal(info.ncols)
    assert torch.equal(a.matvec(x), b.matvec(x))
    with pytest.raises(ValueError, match="nrows, K"):
        spmv_tpu_torch.EllMatrix.from_ell(info.nrows, info.ncols, data[:, :2],
                                          cols, device="cpu")


@pytest.mark.parametrize("split", [True, False])
def test_from_sell_round_trip(split):
    info, r, c, v = CASES["power_law_2048"]()
    a = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v,
                                split=split, device="cpu")
    slice_ptr, data, cols = a.sell_arrays()
    b = spmv_tpu_torch.SellMatrix.from_sell(info.nrows, info.ncols, slice_ptr,
                                            data, cols, a.perm, split=split,
                                            device="cpu")
    assert b.sorted_rows == a.sorted_rows
    x = np.random.default_rng(1).standard_normal(info.ncols)
    assert torch.equal(a.matvec(x), b.matvec(x))
    order_a, order_b = (np.lexsort(t.to_coo()[::-1]) for t in (a, b))
    for ma, mb in zip(a.to_coo(), b.to_coo()):
        assert np.array_equal(ma[order_a], mb[order_b])
    with pytest.raises(ValueError, match="slots"):
        spmv_tpu_torch.SellMatrix.from_sell(info.nrows, info.ncols, slice_ptr,
                                            data[:-1], cols[:-1], device="cpu")


# ---------------------------------------------------------------- the split


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_never_costs_more_than_a_pure_shape(case):
    info, r, c, v = CASES[case]()
    rr, cc, vv, keep, shape = S.priced_split(r, c, v, info.nrows)
    assert np.array_equal(rr, row_ordered((info, r, c, v))[1])
    panel = build_panel_plan(info.nrows, info.ncols, rr[keep], cc[keep], vv[keep])
    spill = int((~keep).sum())
    engines = 2 if panel.nnz and spill else 1
    chosen = S.modeled_seconds(panel.nslots, spill, engines)
    pure_panel = S.modeled_seconds(panel_of((info, r, c, v)).nslots, 0, 1)
    pure_spill = S.modeled_seconds(0, r.size, 1)
    assert chosen <= min(pure_panel, pure_spill) * (1 + 1e-12)
    if r.size:
        assert shape == ("panel" if keep.all() else
                         "spill" if not keep.any() else "hyb")


def test_split_caps_each_slice_at_its_byte_optimum(monkeypatch):
    """Without a dispatch price the capped shape wins on a skewed slice:
    each slice keeps the smallest width with at most 32·PANEL_B/SPILL_B
    rows above it, and every spilled element lies past its slice's cap."""
    monkeypatch.setattr(S, "_DISPATCH_S", 0.0)
    info, r, c, v = synth.power_law(n=2048, seed=7)
    rr, cc, vv, keep, shape = S.priced_split(r, c, v, info.nrows)
    assert shape == "hyb" and keep.any() and (~keep).any()
    lengths = np.bincount(rr, minlength=info.nrows).reshape(-1, SLICE_ROWS)
    thresh = int(SLICE_ROWS * S.PANEL_B / S.SPILL_B)
    caps = -np.sort(-lengths, axis=1)[:, thresh]
    assert ((lengths > caps[:, None]).sum(axis=1) <= thresh).all()
    kept = np.bincount(rr[keep], minlength=info.nrows).reshape(-1, SLICE_ROWS)
    assert (kept == np.minimum(lengths, caps[:, None])).all()


@pytest.mark.parametrize("fmt", ["ell", "sell", "hyb"])
def test_capped_panel_plus_spill_matches_jax(monkeypatch, fmt):
    """Both parts at once (the ``hyb`` shape, which the dispatch price
    keeps off small matrices): their y add up to JAX's and the oracle's."""
    monkeypatch.setattr(S, "_DISPATCH_S", 0.0)
    info, r, c, v = synth.power_law(n=2048, seed=7)
    a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    assert a.shape == "hyb" and a.panel_nnz and a.spill_nnz
    assert a.panel_nnz + a.spill_nnz == a.nnz == r.size
    assert a.stream_bytes >= a.dev.stream_bytes + a.dev_spill.stream_bytes
    x = np.random.default_rng(9).standard_normal(info.ncols).astype(np.float32)
    y = a.matvec(x).numpy()
    ref = spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    y_jax = np.asarray(ref.matvec(x))
    k = max_row(info.nrows, r)
    row_abs = row_scale(info.nrows, r, c, v, x)
    assert kernel_check(golden_spmv(info.nrows, r, c, v, x), y, row_abs, k).ok
    bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
             + engine_rel_tol(k) * container_scale(ref, x, row_abs))
    assert (np.abs(y.astype(np.float64) - y_jax) <= bound).all()


def test_sell_drops_the_sort_when_everything_spills():
    info, r, c, v = synth.power_law(n=4096, seed=3)
    assert sigma_sort_tables(r, info.nrows)[1]  # the sort would apply
    a = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v, device="cpu")
    assert a.shape == "spill" and not a.sorted_rows and a.invperm_dev is None
    assert np.array_equal(a.perm, np.arange(a.perm.size))
    pure = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v,
                                   split=False, device="cpu")
    assert pure.shape == "panel" and pure.sorted_rows
    x = np.random.default_rng(2).standard_normal(info.ncols)
    k = max_row(info.nrows, r)
    for m in (a, pure):
        assert kernel_check(golden_spmv(info.nrows, r, c, v, x), m.matvec(x).numpy(),
                            row_scale(info.nrows, r, c, v, x), k).ok

"""``spmv_tpu_torch.bench.runner`` on the CPU route: JAX's public names,
fields, keys and formulas, the traffic model against the plans' bytes
counted here, the host clock, and no ceiling off a card."""

import dataclasses

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu.bench import runner as jax_runner

import spmv_tpu_torch
from spmv_tpu_torch import synth
from spmv_tpu_torch.bench import runner as R
from spmv_tpu_torch.probes.turns import SPILL_PRICES, forced_split

TILE, SLICE = 1024, 32


@pytest.fixture(scope="module")
def small():
    return synth.synthetic_cant(n=600, avg_nnz_per_row=8, bandwidth=40, seed=7)


@pytest.fixture(scope="module")
def band():
    """band-1024 (PERF.md §4): its SELL keeps a σ-sorted pure panel."""
    return synth.synthetic_cant(n=1024, avg_nnz_per_row=16, bandwidth=60, seed=5)


@pytest.fixture(scope="module")
def skewed():
    return synth.power_law(n=2048, avg_nnz_per_row=16, bandwidth=128, seed=3)


def build(fmt, trip, **kw):
    info, r, c, v = trip
    return spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v,
                                   device="cpu", **kw)


def test_public_names_are_jaxs():
    for name in jax_runner.__all__ + ["traffic_model"]:
        assert callable(getattr(R, name)), name


def test_bench_result_carries_every_jax_field_but_the_tunnels_history():
    jax_fields = {f.name for f in dataclasses.fields(jax_runner.BenchResult)}
    ours = {f.name for f in dataclasses.fields(R.BenchResult)}
    assert jax_fields - {"min_history_ms"} <= ours
    assert {"cold_ms_per_spmv", "l2_resident", "timing", "card"} <= ours


def test_every_container_has_a_timing_method(small):
    for fmt in ("coo", "csr", "ell", "sell", "cmrs", "hyb", "bsr", "sym"):
        assert type(build(fmt, small)) in R.TIMING, fmt
    info, r, c, v = small
    assert spmv_tpu_torch.X2Matrix in R.TIMING
    assert R.TIMING[spmv_tpu_torch.BSRMatrix] == "events"


def test_reference_formulas_hold_exactly_on_a_cpu_result(small):
    """helper_functions.h:167-182, as tests/test_bench.py:27-41 holds JAX's."""
    a = build("csr", small)
    d = R.bench_format(a, "csr", repeats=2).to_dict()
    assert d["format"] == "csr" and d["nnz"] == small[1].size
    assert d["ms_per_spmv"] > 0 and d["gnnz_per_s"] > 0
    assert d["padded_slots"] >= d["nnz"]
    ms, nnz = d["ms_per_spmv"], d["nnz"]
    assert d["gflops"] == 2 * nnz / ms * 1e-6
    assert d["gbps_lower"] == nnz * 8 / ms * 1e-6
    assert d["gbps_upper"] == 2 * nnz * 8 / ms * 1e-6
    assert d["gnnz_per_s"] == pytest.approx(nnz / (ms / 1e3) / 1e9, rel=1e-12)
    slots, total = R.traffic_model(a)
    assert d["bytes_per_nnz"] == total / nnz
    assert d["effective_gbps"] == pytest.approx(total / (ms / 1e3) / 1e9, rel=1e-12)
    # the host clock measures no device: no cold reading, ceiling or card
    assert d["timing"] == "host" and d["card"] is None
    for k in ("cold_ms_per_spmv", "roofline_pct", "true_eff_pct", "hbm_bw_gbps",
              "l2_resident"):
        assert d[k] is None, k


@pytest.mark.parametrize("l2", [50 * 2**20, 1000])
def test_roofline_is_the_cold_reading_against_the_ceiling(small, l2):
    a = build("sell", small)
    r = R._result(a, "sell", warm_ms=0.01, cold_ms=0.02, bw=3.0e12, timing="graph",
                  card="NVIDIA H100 80GB HBM3, 700.00 W", l2=l2)
    slots, total = R.traffic_model(a)
    tc = 0.02e-3
    assert r.roofline_pct == pytest.approx(100 * total / tc / 3.0e12, rel=1e-12)
    assert r.true_eff_pct == pytest.approx(
        100 * (a.nnz / tc) / (3.0e12 / (total / slots)), rel=1e-12)
    assert r.effective_gbps == pytest.approx(total / 0.01e-3 / 1e9, rel=1e-12)
    assert r.hbm_bw_gbps == 3000.0 and r.cold_ms_per_spmv == 0.02
    assert r.l2_resident is (total <= l2)


def csr_bytes(lengths: np.ndarray, val_size: int) -> int:
    """A CSR plan's device bytes from its row lengths: ptr, cols, vals,
    tile_row0 (one entry per 1024-nonzero tile and one more), carry_rows
    (the rows that cross a tile boundary), int32 but the values."""
    nnz = int(lengths.sum())
    ends = np.cumsum(lengths)
    starts = ends - lengths
    split = (lengths > 0) & (starts // TILE != (ends - 1) // TILE)
    ntiles = -(-nnz // TILE)
    return 4 * (lengths.size + 1) + nnz * (4 + val_size) + 4 * (ntiles + 1) + 4 * int(split.sum())


def panel_bytes(plan) -> int:
    """A panel plan's device bytes from its host arrays (slice_ptr as int32)."""
    return (4 * plan.slice_ptr.size + plan.vals.nbytes + plan.cols.nbytes
            + plan.tile_slice0.nbytes + plan.tile_own0.nbytes + plan.split_slices.nbytes)


def k7_reads(plan, slots_of_rows: np.ndarray) -> int:
    """Rows of y′ or partial slots K7 reads for the panel rows given: a
    split slice's row reads one slot per tile the slice touches, any other
    row its row of y′."""
    scol = plan.slice_ptr.astype(np.int64) // SLICE
    span = np.ones(scol.size - 1, np.int64)
    s = plan.split_slices.astype(np.int64)
    span[s] = (scol[s + 1] - 1) // plan.tile - scol[s] // plan.tile + 1
    return int(span[slots_of_rows // SLICE].sum())


def test_traffic_model_csr_and_x2_csr(small):
    info, r = small[0], small[1]
    lengths = np.bincount(r, minlength=info.nrows)
    a = build("csr", small)
    assert R.traffic_model(a) == (r.size, float(csr_bytes(lengths, 4)))
    x2 = spmv_tpu_torch.X2Matrix.from_coo("csr", info.nrows, info.ncols, *small[1:],
                                          device="cpu")
    assert R.traffic_model(x2) == (r.size, float(csr_bytes(lengths, 8)))


@pytest.mark.parametrize("fused", [True, False])
def test_traffic_model_pure_ell(small, fused):
    """ELL without the split: the panel alone; K7's identity mode without
    a spill after K4 (the split slices' rows), nothing after K6."""
    with forced_split(fused_max=None if fused else 0):
        a = build("ell", small, split=False)
        assert a.dev.fused is fused and a.dev_spill is None
        plan = a.plan
        k7 = 0
        if not fused:  # each split slice: its partials read, 3 ints, 32 rows written
            rows = (plan.split_slices.astype(np.int64)[:, None] * SLICE
                    + np.arange(SLICE)).reshape(-1)
            k7 = 4 * k7_reads(plan, rows) + plan.split_slices.size * (12 + 4 * SLICE)
            assert plan.split_slices.size
        assert R.traffic_model(a) == (plan.vals.size, float(panel_bytes(plan) + k7))


@pytest.mark.parametrize("fused", [True, False])
def test_traffic_model_sorted_sell_bills_k7(band, fused):
    """A σ-sorted SELL: the panel, then K7 over the rows (``invperm`` read,
    each row's partial slots or y′ row read, y written); after K6 the gather
    alone."""
    with forced_split(fused_max=None if fused else 0):
        a = build("sell", band)
        assert a.sorted_rows and a.shape == "panel" and a.dev.fused is fused
        plan, n = a.plan, a.nrows
        p = a.invperm_dev.numpy().astype(np.int64)[:n]
        if fused:
            k7 = n * (4 + 2 * 4)
        else:
            k7 = 4 * plan.slice_ptr.size + 4 * n + 4 * (k7_reads(plan, p) + n)
        assert R.traffic_model(a) == (plan.vals.size, float(panel_bytes(plan) + k7))
        assert R.bytes_per_slot(a) == (panel_bytes(plan) + k7) / plan.vals.size


def test_traffic_model_hyb_with_a_spill(skewed):
    """A HYB that keeps a panel and spills (the split's dispatch price at 0):
    both plans, and K7's identity mode with the spill over every row."""
    with forced_split(**SPILL_PRICES):
        a = build("hyb", skewed)
        assert a.shape == "hyb" and a.panel_nnz and a.spill_nnz
        plan, sp = a.plan, a.spill_plan
        rows = np.arange(plan.nrows)
        k7 = 4 * plan.slice_ptr.size + 4 * (k7_reads(plan, rows) + 2 * plan.nrows)
        want = panel_bytes(plan) + csr_bytes(np.diff(sp.ptr.astype(np.int64)), 4) + k7
        assert R.traffic_model(a) == (plan.vals.size + sp.nnz, float(want))


def test_traffic_model_pure_spill_hyb_bills_the_spill_alone():
    trip = synth.power_law(n=2048, avg_nnz_per_row=16, seed=5)
    a = build("hyb", trip)
    assert a.shape == "spill" and a.panel_nnz == 0
    lengths = np.bincount(trip[1], minlength=trip[0].nrows)
    assert R.traffic_model(a) == (trip[1].size, float(csr_bytes(lengths, 4)))


def test_traffic_model_x2_sell_always_has_partials(band):
    """The fp64 panel has no one-dispatch kernel: K14, then K7 with its
    partials in float64, even for a plan under the one-dispatch bound."""
    info = band[0]
    a = spmv_tpu_torch.X2Matrix.from_coo("sell", info.nrows, info.ncols, *band[1:],
                                         device="cpu")
    assert a.sorted_rows and a.shape == "panel" and a.dev.fused
    plan, n = a.parts.plan, a.nrows
    p = a.invperm_dev.numpy().astype(np.int64)[:n]
    k7 = 4 * plan.slice_ptr.size + 4 * n + 8 * (k7_reads(plan, p) + n)
    assert R.traffic_model(a) == (plan.vals.size, float(panel_bytes(plan) + k7))


def test_traffic_model_bsr(small):
    info, r, c, _ = small
    a = build("bsr", small)
    ns = -(-info.ncols // 128)
    T = np.unique((r.astype(np.int64) >> 7) * ns + (c >> 7)).size
    nb = -(-info.nrows // 128)
    assert R.traffic_model(a) == (T * 128 * 128, float(T * 128 * 128 * 4 + 8 * T + 8 * nb))


def test_interleaved_on_the_cpu_is_host_timed_and_names_no_card(small):
    objs = {f: build(f, small) for f in ("csr", "ell", "sell")}
    res = R.bench_formats_interleaved(objs, repeats=2)
    assert set(res) == set(objs)
    for name, r in res.items():
        assert r.format == name and r.timing == "host" and r.card is None
        assert r.ms_per_spmv > 0 and r.roofline_pct is None


def test_no_ceiling_off_a_card(small):
    """probe=True on the CPU raises, as probes.timing does, before it times
    anything, and does not fall back to a number."""
    with pytest.raises(ValueError, match="CUDA device only"):
        R.bench_formats_interleaved({"csr": build("csr", small)}, repeats=2, probe=True)
    with pytest.raises(ValueError, match="CUDA device only"):
        R.measure_hbm_bw("cpu")


def test_bench_spmm_keys_are_jaxs(small):
    """JAX's keys (its bench_spmm on BSR, as tests/test_bench.py:104-109
    calls it), plus the timing and the card."""
    info, r, c, v = small
    jd = jax_runner.bench_spmm(spmv_tpu.from_coo("bsr", info.nrows, info.ncols, r, c, v),
                               "bsr", 4, repeats=2, iters_a=2, iters_b=4)
    d = R.bench_spmm(build("bsr", small), "bsr", 4, repeats=2)
    assert set(d) == set(jd) | {"timing", "card"}
    assert d["rhs"] == 4 and d["nnz"] == jd["nnz"] and d["fill"] == pytest.approx(jd["fill"])
    assert d["gflops"] == 2 * d["nnz"] * 4 / d["ms_per_spmm"] * 1e-6
    assert d["timing"] == "host" and d["card"] is None
    e = R.bench_spmm(build("sell", small), "sell", 3, repeats=2)
    assert set(e) == set(jd) - {"fill"} | {"timing", "card"}

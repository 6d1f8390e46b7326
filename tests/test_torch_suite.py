"""``spmv_tpu_torch.bench.suite``, the port's ``bench.py``, on the CPU:
its fingerprints, flags and last-line keys against ``bench.py`` and the JAX
package's generators, each suite at a small size, the big cell's triplet
cache, the simulated sweep on two gloo ranks, and ``main()`` end to end."""

import ast
import functools
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spmv_tpu import synth as jax_synth

from spmv_tpu_torch import synth
from spmv_tpu_torch.bench import suite as S
from spmv_tpu_torch.oracle import EPSILON

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL_N = 2048  # the main matrix's rows here (SPMV_N)


@pytest.fixture(scope="module")
def bench_py():
    """The root ``bench.py`` as a module (its top level imports no JAX)."""
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cant():
    return synth.synthetic_cant(n=SMALL_N, avg_nnz_per_row=64, bandwidth=350, seed=0)


# ------------------------------------------------------------ against bench.py


@pytest.mark.parametrize("which", ["cant", "power_law"])
def test_fingerprint_is_bench_pys_on_the_jax_generators(bench_py, which):
    make, params = {
        "cant": ("synthetic_cant", dict(n=SMALL_N, avg_nnz_per_row=64, bandwidth=350,
                                        seed=0)),
        "power_law": ("power_law", dict(n=4096, avg_nnz_per_row=24, bandwidth=512,
                                        seed=0))}[which]
    ours = S.matrix_fingerprint(*getattr(synth, make)(**params), params)
    theirs = bench_py.matrix_fingerprint(*getattr(jax_synth, make)(**params), params)
    assert ours == theirs
    assert S.GENERATOR_VERSION == bench_py.GENERATOR_VERSION


def test_fingerprint_change_warns_against_the_ports_file(tmp_path, capsys, cant):
    fp = S.matrix_fingerprint(*cant, {"n": SMALL_N})
    path = tmp_path / S.RESULTS_FILE
    assert not S.warn_if_fingerprint_changed(fp, str(path))  # no file yet
    path.write_text(json.dumps({"__matrix_fingerprint__": fp}))
    assert not S.warn_if_fingerprint_changed(fp, str(path))
    path.write_text(json.dumps({"__matrix_fingerprint__": dict(fp, nnz=1)}))
    assert S.warn_if_fingerprint_changed(fp, str(path))
    assert "fingerprint CHANGED" in capsys.readouterr().err


def _bench_py_flags(pl_results):
    """bench.py:192-198's expressions, as written there."""
    sell_wins = (pl_results["sell_pure"]["gnnz_per_s"]
                 > pl_results["ell_pure"]["gnnz_per_s"])
    best_pure = max(pl_results["ell_pure"]["gnnz_per_s"],
                    pl_results["csr"]["gnnz_per_s"])
    routing_sound = (pl_results["hyb"]["gnnz_per_s"]
                     >= 0.95 * best_pure)
    pl_best = max(r["gnnz_per_s"] for r in pl_results.values())
    return {"sell_beats_ell_on_power_law": sell_wins,
            "split_routing_sound": routing_sound,
            "power_law_best_gnnz_per_s": round(pl_best, 3)}


@pytest.mark.parametrize("rates", [
    # sell_pure, ell_pure, csr, hyb, and one more format
    (2.0, 1.0, 1.5, 1.5, 0.5),
    (1.0, 1.0, 1.0, 1.0, 1.0),          # ties everywhere: sell does not beat ell
    (1.0, 2.0, 1.0, 1.9, 0.1),          # hyb exactly 0.95 of the better pure shape
    (1.0, 2.0, 1.0, 1.8999999, 0.1),    # just under it
    (3.0, 1.0, 4.0, 3.8, 4.0004),       # csr the better pure shape; best a tie at 3 places
    (0.5, 0.7, 0.2, 0.0, 0.3),
])
def test_power_law_flags_are_bench_pys(rates):
    names = ("sell_pure", "ell_pure", "csr", "hyb", "coo")
    pl = {k: {"gnnz_per_s": v} for k, v in zip(names, rates)}
    assert S.power_law_flags(pl) == _bench_py_flags(pl)


@pytest.mark.parametrize("min_eff", [80.0, 0.0, 41.23456, 100.0, 79.99999, None])
def test_vs_baseline_is_bench_pys(min_eff):
    want = None if min_eff is None else round(min_eff / 80.0, 4)  # bench.py:536
    assert S.vs_baseline(min_eff) == want


def _bench_py_last_keys() -> set:
    """The keys of bench.py's final ``json.dumps({...})`` (bench.py:531-559),
    read from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    dicts = [node.args[0] for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    last = max(dicts, key=lambda d: d.lineno)
    return {k.value for k in last.keys}


def test_last_line_keys_are_bench_pys_plus_card():
    assert len(S.LAST_LINE_KEYS) == len(set(S.LAST_LINE_KEYS))
    assert set(S.LAST_LINE_KEYS) == _bench_py_last_keys() | {"card"}


# ---------------------------------------------------------------- the suites


def test_main_suite_times_the_six_formats(cant):
    row, entries = S.main_suite(cant, device="cpu", repeats=2)
    assert set(entries) == set(S.FORMATS6)
    assert row["best"] == max(e["gnnz_per_s"] for e in entries.values())
    assert row["best"] > 0
    # no ceiling and no roofline off a card
    assert row["bw"] is None and row["min_roofline_pct"] is None
    assert all(e["timing"] == "host" and e["roofline_pct"] is None for e in entries.values())


def test_power_law_suite_builds_benchpy_members(capsys):
    row, entries = S.power_law_suite(n=2048, device="cpu", repeats=2)
    pl = entries["__power_law__"]
    assert set(pl) == {"ell", "sell", "csr", "coo", "cmrs", "hyb", "ell_pure", "sell_pure"}
    assert row == _bench_py_flags(pl)
    assert "power-law sell_pure" in capsys.readouterr().err


def test_power_law_big_suite():
    best, entries = S.power_law_big_suite(n=4096, device="cpu", repeats=2)
    big = entries["__power_law_big__"]
    assert set(big) == {"pl_big_csr", "pl_big_sell", "pl_big_hyb"}
    assert best == round(max(r["gnnz_per_s"] for r in big.values()), 3)


def test_x2_suite_is_within_the_reference_epsilon(cant):
    row, entries = S.x2_suite(cant, device="cpu", repeats=2)
    assert row["within_reference_epsilon"] is True
    assert 0 <= row["max_abs_err_vs_fp64"] <= EPSILON
    assert entries["__x2_csr__"]["max_abs_err_vs_fp64"] == row["max_abs_err_vs_fp64"]


def test_sym_suite_counts_bench_pys_cut(cant):
    row, entries = S.sym_suite(cant, device="cpu", repeats=2)
    _, rows, cols, _ = cant
    keep = rows >= cols  # bench.py:272-275
    tr, tc = rows[keep], cols[keep]
    assert row["host_triplets_stored"] == tr.size
    assert row["host_triplets_expanded"] == tr.size + int((tr > tc).sum())
    assert set(entries) == {"__sym_tri__", "__sym_expanded_csr__"}
    assert entries["__sym_tri__"]["nnz"] == row["host_triplets_expanded"]


def test_spmm_suite(cant):
    rate, entries = S.spmm_suite(cant, device="cpu", repeats=2)
    r4 = entries["__spmm_r4__"]
    assert r4["rhs"] == 4 and r4["gnnzvec_per_s"] > 0
    assert rate == round(r4["gnnzvec_per_s"], 3)


def test_bsr_suite_has_no_roofline_without_a_ceiling(cant):
    row, entries = S.bsr_suite(cant, device="cpu", repeats=1)
    assert row["rhs"] == 32 and row["roofline_pct"] is None
    assert entries["__bsr_spmm__"]["roofline_pct"] is None
    assert entries["__bsr_spmm__"]["effective_gbps"] > 0


def test_big_suite_checks_and_caches(tmp_path):
    params = dict(n=30_000, avg_nnz_per_row=8, bandwidth=300, seed=0)
    cache_dir = str(tmp_path / ".bench_cache")
    rate, entries = S.big_suite(**params, device="cpu", repeats=1, cache_dir=cache_dir)
    first = entries["__big__"]
    assert first["format"] == "csr_0.03M" and not first["triplets_cached"]
    assert first["gnnz_per_s"] > 0 and rate == round(first["gnnz_per_s"], 3)
    assert first["check"].startswith("result is ok")
    again = S.big_suite(**params, device="cpu", repeats=1, cache_dir=cache_dir)[1]["__big__"]
    assert again["triplets_cached"]
    assert again["matrix_fingerprint"] == first["matrix_fingerprint"]
    assert any(p.name.startswith("plan-csr-") for p in pathlib.Path(cache_dir).iterdir())
    # csr, sell and hyb of the cached triplets against the fp64 oracle
    trip, cached = S.big_triplets(**params, cache_dir=cache_dir)
    assert cached
    want = synth.synthetic_cant(**params)
    for a, b in zip(trip[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for fmt in ("csr", "sell", "hyb"):
        rep = S.check_matvec(S._build(fmt, trip, "cpu"), trip)
        assert rep.ok, (fmt, str(rep))


def test_weak_scaling_suite_tears_down_its_group():
    assert not dist.is_initialized()
    row, entries = S.weak_scaling_suite(512, 8, 64, device="cpu", iters_a=2, iters_b=4,
                                        repeats=1)
    assert not dist.is_initialized()
    rep = entries["__weak_scaling__"]
    assert rep["backend"] == "gloo" and rep["simulated"]
    assert row["d1_ms_per_spmv"] == rep["points"][0]["ms_per_spmv"] > 0
    assert set(row["eff_no_overlap"]) == {"2", "4", "8", "16"}
    assert row["meets_80pct_target_at_2"] in (True, False)


def test_simulated_sweep_runs_on_two_gloo_ranks():
    ok, entries = S.simulated_sweep(128, 8, 32, device_counts=(1, 2), timeout=240)
    sweep = entries["__simulated_sweep__"]
    assert ok is True, sweep.get("error")
    assert [p["devices"] for p in sweep["points"]] == [1, 2]
    assert [p["nrows"] for p in sweep["points"]] == [128, 256]


# ---------------------------------------------------------------- main()


def test_main_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert S.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_main_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPMV_N", str(SMALL_N))
    monkeypatch.setenv("SPMV_SKIP_BIG", "1")
    monkeypatch.setenv("SPMV_SKIP_SIM_SWEEP", "1")
    monkeypatch.delenv("SPMV_MATRIX", raising=False)
    for name, kw in (("main_suite", dict(repeats=2)),
                     ("power_law_suite", dict(n=2048, repeats=2)),
                     ("power_law_big_suite", dict(n=4096, repeats=2)),
                     ("x2_suite", dict(repeats=2)), ("sym_suite", dict(repeats=2)),
                     ("spmm_suite", dict(repeats=2)), ("bsr_suite", dict(repeats=1)),
                     ("weak_scaling_suite", dict(rows_per_device=512, iters_a=2,
                                                 iters_b=4, repeats=1))):
        monkeypatch.setattr(S, name, functools.partial(getattr(S, name), **kw))
    assert S.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "FAILED" not in out.err and "SYNTHETIC" in out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == list(S.LAST_LINE_KEYS)
    # skipped here: the big cell and the sweep; measured on a card only:
    # vs_baseline (a roofline share) and the card
    nulls = {k for k, v in line.items() if v is None}
    assert nulls == {"big_tiled_gnnz_per_s", "simulated_sweep_ok", "vs_baseline", "card"}
    assert line["x2_csr"]["within_reference_epsilon"] is True
    assert line["synthetic_matrix"] is True
    assert line["matrix_fingerprint"]["nnz"] == synth.synthetic_cant(
        n=SMALL_N, avg_nnz_per_row=64, bandwidth=350, seed=0)[1].size
    assert line["fingerprint_changed_since_last_run"] is False
    assert line["roofline_pct_per_format"] == {}  # no ceiling off a card
    assert os.path.exists(S.RESULTS_FILE) and not os.path.exists("bench_results.json")
    with open(S.RESULTS_FILE) as f:
        results = json.load(f)
    assert set(S.FORMATS6) <= set(results)
    for key in ("__power_law__", "__power_law_big__", "__x2_csr__", "__sym_tri__",
                "__spmm_r4__", "__bsr_spmm__", "__weak_scaling__", "__matrix_fingerprint__"):
        assert key in results, key
    suites = results["__suites__"]
    assert "big-matrix suite" not in suites and "simulated sweep" not in suites
    assert all(s["seconds"] >= 0 and s["launches"] == {} for s in suites.values())

"""The driver benchmark of the PyTorch port, the counterpart of the root
``bench.py``::

    python -m spmv_tpu_torch.bench.suite               # on the CUDA card
    python -m spmv_tpu_torch.bench.suite --device cpu  # plain versions, host clock

It runs ``bench.py``'s ten suites in its order, each on the port's own
containers and bench (``bench.runner``), on ``cuda`` unless the caller asks
for the CPU:

1. ``main_suite``: csr, coo, ell, sell, cmrs and hyb on cant
   (``databases/cant.mtx``, or ``synthetic_cant(n=62464, 64, 350, 0)`` when
   the file is missing or a git-LFS pointer; ``SPMV_MATRIX`` and ``SPMV_N``
   as in bench.py), interleaved with the co-sampled HBM ceiling ``bw``,
   which every later suite takes as its floor;
2. ``power_law_suite``: the six formats and the pure-panel ``ell_pure`` and
   ``sell_pure`` on ``power_law(32768, 24, bandwidth=512)``, and bench.py's
   two flags (``power_law_flags``);
3. ``power_law_big_suite``: csr, sell and hyb on ``pl_big`` (524,288 rows);
4. ``x2_suite``: the fp64-grade csr (``X2Matrix``) on cant, with its error
   against the fp64 oracle at the reference's ``EPSILON``;
5. ``sym_suite``: cant's lower triangle as ``sym`` against the expanded csr;
6. ``spmm_suite``: ``spmm`` at R = 4 on cant's csr;
7. ``bsr_suite``: BSR at R = 32 on cant, its roofline on the tile, X and Y
   bytes over the co-sampled ceiling (the H100's 3.35 TB/s without one);
8. ``big_suite``: the 4.2M-row big cell, ``synthetic_cant(4_200_000, 8,
   300, 0)``, its triplets cached in ``.bench_cache/`` under the working
   directory (the plan cache too). The JAX package tiles it past the TPU's
   VMEM (``TiledSpmv``); the port's plans live in HBM, so it is the port's
   ordinary csr container, no tiling (``SPMV_SKIP_BIG`` skips it);
9. ``weak_scaling_suite``: ``bench.scaling.weak_scaling_report`` (cmrs,
   16,384 rows per device) on the default process group, a one-rank group
   brought up and torn down here when there is none;
10. ``simulated_sweep``: D = 1, 2, 4 and 8 gloo ranks on the CPU, spawned
    from the suite, which checks the sharded program, not its numbers
    (``SPMV_SKIP_SIM_SWEEP`` skips it).

Each suite is a plain function that takes its matrix's parameters
(bench.py's values as defaults) and a ``device`` and returns its row of the
last line and its entries of the results file. ``main`` keeps each suite
in its own ``try``: a failing suite prints ``<suite>: FAILED <type>: <msg>``
and its traceback to stderr and leaves its key null. Per-format readings go
to stderr. The last line of stdout is one JSON object with bench.py's keys
(``bench.py:531-559``) and ``card`` (``nvidia-smi``'s name and power limit,
null on the CPU). The roofline is the runner's cold reading against the
co-sampled ceiling (``bench.runner``). The results go to
``bench_results_torch.json`` in the working directory, with each suite's
kernel launches and seconds; the JAX package's ``bench_results.json`` is
never written. The exit code is bench.py's: 1 when no format of the main
suite was timed, else 0.

This module imports ``torch`` and never ``jax``, ``spmv_tpu`` or the root
``bench``: ``GENERATOR_VERSION``, ``matrix_fingerprint`` and
``warn_if_fingerprint_changed`` are copies of ``bench.py:26-63``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

__all__ = ["GENERATOR_VERSION", "RESULTS_FILE", "LAST_LINE_KEYS", "matrix_fingerprint",
           "warn_if_fingerprint_changed", "power_law_flags", "vs_baseline",
           "main_matrix", "big_triplets", "check_matvec", "main_suite",
           "power_law_suite", "power_law_big_suite", "x2_suite", "sym_suite",
           "spmm_suite", "bsr_suite", "big_suite", "weak_scaling_suite",
           "simulated_sweep", "main"]

# bench.py:26, the generator version of the bench matrices
GENERATOR_VERSION = "fem-beam-v2"
RESULTS_FILE = "bench_results_torch.json"
CACHE_DIR = ".bench_cache"
FORMATS6 = ("csr", "coo", "ell", "sell", "cmrs", "hyb")  # bench.py:105's order
TARGET_ROOFLINE_PCT = 80.0  # BASELINE.json: 80% of the HBM roofline per format
# the keys of the last line: bench.py's (bench.py:531-559), then the card
LAST_LINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "synthetic_matrix",
    "sell_beats_ell_on_power_law", "split_routing_sound", "power_law_best_gnnz_per_s",
    "power_law_big_best_gnnz_per_s", "big_tiled_gnnz_per_s", "spmm_r4_gnnzvec_per_s",
    "bsr_spmm_r32", "symmetric_storage", "x2_csr", "weak_scaling", "simulated_sweep_ok",
    "matrix_fingerprint", "fingerprint_changed_since_last_run", "roofline_pct_per_format",
    "true_nnz_sol_pct_per_format", "card")


def matrix_fingerprint(info, rows, cols, vals, params: dict) -> dict:
    """Content hash and provenance of a bench matrix (``bench.py:29-46``),
    so a change of generator or parameters never passes for a change of
    speed."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(rows, np.int64).tobytes())
    h.update(np.ascontiguousarray(cols, np.int64).tobytes())
    h.update(np.ascontiguousarray(vals, np.float64).tobytes())
    return {
        "generator": GENERATOR_VERSION,
        "params": params,
        "nrows": int(info.nrows),
        "ncols": int(info.ncols),
        "nnz": int(rows.size),
        "triplet_hash": h.hexdigest(),
    }


def warn_if_fingerprint_changed(fp: dict, prev_path: str) -> bool:
    """Compare against the previous results file (``bench.py:49-63``);
    True, with a warning on stderr, when the bench matrix changed."""
    try:
        with open(prev_path) as f:
            prev = json.load(f).get("__matrix_fingerprint__")
    except (OSError, ValueError, AttributeError):
        return False
    if prev and prev != fp:
        print("WARNING: bench matrix fingerprint CHANGED since the last "
              f"recorded run:\n  previous: {prev}\n  current:  {fp}\n"
              "  -> throughput numbers are NOT comparable across this "
              "boundary.", file=sys.stderr)
        return True
    return False


def power_law_flags(pl_results: dict) -> dict:
    """bench.py's power-law flags (``bench.py:192-197``) from the suite's
    results (name → result dict): the pure σ-sorted panel against the pure
    natural-order one, the routed hyb against 95% of the better pure shape
    (``ell_pure`` or csr), and the best rate."""
    rate = {k: r["gnnz_per_s"] for k, r in pl_results.items()}
    return {"sell_beats_ell_on_power_law": rate["sell_pure"] > rate["ell_pure"],
            "split_routing_sound": rate["hyb"] >= 0.95 * max(rate["ell_pure"], rate["csr"]),
            "power_law_best_gnnz_per_s": round(max(rate.values()), 3)}


def vs_baseline(min_roofline_pct: float | None) -> float | None:
    """The weakest per-format roofline share over BASELINE.json's 80%
    (``bench.py:536``); None where no roofline was measured (the host)."""
    if min_roofline_pct is None:
        return None
    return round(min_roofline_pct / TARGET_ROOFLINE_PCT, 4)


def _build(fmt: str, trip, device, **kw):
    from spmv_tpu_torch.api import from_coo

    info, rows, cols, vals = trip
    return from_coo(fmt, info.nrows, info.ncols, rows, cols, vals, device=device, **kw)


def _interleaved(objs: dict, device, hbm_bw: float | None, repeats: int):
    """``bench_formats_interleaved`` with the ceiling co-sampled on a card
    (the caller's ``hbm_bw`` its floor); on the CPU no ceiling:
    ``(results, bw)``, ``bw`` None there."""
    from spmv_tpu_torch.bench.runner import bench_formats_interleaved

    if torch.device(device).type == "cuda":
        return bench_formats_interleaved(objs, probe=True, hbm_bw=hbm_bw, repeats=repeats)
    return bench_formats_interleaved(objs, repeats=repeats), None


def _pct(v: float | None) -> str:
    return "roofline not measured" if v is None else f"{v:4.1f}% roofline"


def _sol(v: float | None) -> str:
    return "true-nnz SoL not measured" if v is None else f"{v:4.1f}% true-nnz SoL"


def _ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def check_matvec(a, trip, seed: int = 3):
    """``a.matvec(x)`` on a seeded float32 x against ``golden_spmv`` by
    ``check_result`` at the port's fp32 bound, as ``run`` checks it."""
    from spmv_tpu_torch.oracle import spmv_check

    info, rows, cols, vals = trip
    x = np.random.default_rng(seed).standard_normal(info.ncols).astype(np.float32)
    return spmv_check(info.nrows, rows, cols, vals, x,
                      a.matvec(x).float().cpu().numpy()[:info.nrows])


# ------------------------------------------------------------------ suites


def main_matrix(path: str = "databases/cant.mtx", n: int = 62464):
    """The main suite's matrix (``bench.py:88-96``): ``path`` if it is a
    real .mtx, else ``synthetic_cant(n, 64, 350, 0)``. Returns the
    triplets, whether they were synthesized, and the fingerprint."""
    from spmv_tpu_torch.io.mmio import is_real_mtx, read_path_or_synthesize

    params = dict(n=n, avg_nnz_per_row=64, bandwidth=350, seed=0)
    trip = read_path_or_synthesize(path, **params)
    synthetic = not is_real_mtx(path)
    fp = matrix_fingerprint(*trip, params if synthetic else {"path": path})
    return trip, synthetic, fp


def main_suite(trip, *, device, repeats: int = 28):
    """The six formats on the main matrix with the co-sampled ceiling
    (``bench.py:99-141``). Row: the best result's Gnnz/s (``best``), the
    weakest roofline share (``min_roofline_pct``: 0 when a format failed,
    None where no roofline was measured) and the ceiling (``bw``)."""
    results, objs = {}, {}
    failed = False
    for fmt in FORMATS6:
        try:
            objs[fmt] = _build(fmt, trip, device)
        except (ValueError, NotImplementedError, RuntimeError) as e:
            print(f"{fmt}: FAILED {type(e).__name__}: {e}", file=sys.stderr)
            results[fmt] = {"error": str(e)}
            failed = True
    bench, bw = _interleaved(objs, device, None, repeats)
    del objs
    if bw is not None:
        print(f"measured HBM BW: {bw / 1e9:.0f} GB/s (co-sampled hbm member)",
              file=sys.stderr)
    for fmt, r in bench.items():
        results[fmt] = r.to_dict()
        print(f"{fmt:5s}: {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s  "
              f"{r.gflops:8.1f} GFLOP/s(ref)  {r.effective_gbps:5.0f} GB/s eff "
              f"({_pct(r.roofline_pct)}, {_sol(r.true_eff_pct)}, "
              f"pad {r.padded_slots / max(r.nnz, 1):.2f}x; cold {_ms(r.cold_ms_per_spmv)}, "
              f"L2-resident {r.l2_resident}, {r.timing})", file=sys.stderr)
    best = max((r.gnnz_per_s for r in bench.values()), default=None)
    shares = [r.roofline_pct for r in bench.values()]
    min_eff = (0.0 if failed else None if not shares or None in shares else min(shares))
    return {"best": best, "min_roofline_pct": min_eff, "bw": bw}, results


def power_law_suite(n: int = 32768, avg_nnz_per_row: int = 24, bandwidth: int = 512,
                    seed: int = 0, *, device, hbm_bw: float | None = None,
                    repeats: int = 24):
    """The six formats and the pure-panel ``ell_pure`` and ``sell_pure``
    (``split=False``) on the power-law matrix (``bench.py:158-200``). Row:
    ``power_law_flags``."""
    from spmv_tpu_torch import synth

    trip = synth.power_law(n=n, avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth,
                           seed=seed)
    objs = {fmt: _build(fmt, trip, device) for fmt in ("ell", "sell", "csr", "coo",
                                                         "cmrs", "hyb")}
    objs["ell_pure"] = _build("ell", trip, device, split=False)
    objs["sell_pure"] = _build("sell", trip, device, split=False)
    bench, _ = _interleaved(objs, device, hbm_bw, repeats)
    pl = {k: r.to_dict() for k, r in bench.items()}
    for k, r in bench.items():
        print(f"power-law {k:9s}: {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s  "
              f"({_pct(r.roofline_pct)}, pad {r.padded_slots / max(r.nnz, 1):.2f}x)",
              file=sys.stderr)
    return power_law_flags(pl), {"__power_law__": pl}


def power_law_big_suite(n: int = 524288, avg_nnz_per_row: int = 24, bandwidth: int = 512,
                        seed: int = 0, *, device, hbm_bw: float | None = None,
                        repeats: int = 12):
    """csr, sell and hyb on ``pl_big`` (``bench.py:207-228``). Row: the
    best Gnnz/s."""
    from spmv_tpu_torch import synth

    trip = synth.power_law(n=n, avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth,
                           seed=seed)
    objs = {f"pl_big_{fmt}": _build(fmt, trip, device) for fmt in ("csr", "sell", "hyb")}
    bench, _ = _interleaved(objs, device, hbm_bw, repeats)
    for k, r in bench.items():
        print(f"{k}: {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s  "
              f"({_pct(r.roofline_pct)}, {_sol(r.true_eff_pct)})", file=sys.stderr)
    return (round(max(r.gnnz_per_s for r in bench.values()), 3),
            {"__power_law_big__": {k: r.to_dict() for k, r in bench.items()}})


def x2_suite(trip, *, device, hbm_bw: float | None = None, repeats: int = 10):
    """The fp64-grade csr on the main matrix (``bench.py:234-261``): its max
    abs error against ``golden_spmv`` on ``default_rng(3)``'s x, within the
    reference's ``EPSILON`` or not, and its rate."""
    from spmv_tpu_torch.oracle import EPSILON, golden_spmv
    from spmv_tpu_torch.x2 import X2Matrix

    info, rows, cols, vals = trip
    a2 = X2Matrix.from_coo("csr", info.nrows, info.ncols, rows, cols, vals, device=device)
    x64 = np.random.default_rng(3).standard_normal(info.ncols)
    err = float(np.abs(a2.matvec(x64).cpu().numpy()
                       - golden_spmv(info.nrows, rows, cols, vals, x64)).max())
    bench, _ = _interleaved({"csr_x2": a2}, device, hbm_bw, repeats)
    r = bench["csr_x2"]
    row = {"gnnz_per_s": round(r.gnnz_per_s, 3), "ms_per_spmv": r.ms_per_spmv,
           "max_abs_err_vs_fp64": err, "within_reference_epsilon": bool(err <= EPSILON)}
    print(f"f32x2 csr: {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s  max|err| "
          f"{err:.2e} vs fp64 oracle (EPSILON {EPSILON:g})", file=sys.stderr)
    return row, {"__x2_csr__": dict(r.to_dict(), max_abs_err_vs_fp64=err)}


def sym_suite(trip, *, device, hbm_bw: float | None = None, repeats: int = 10):
    """The main matrix's lower triangle (``rows >= cols``) as ``sym``
    against its expansion as csr, interleaved (``bench.py:268-306``)."""
    info, rows, cols, vals = trip
    keep = rows >= cols
    tr, tc, tv = rows[keep], cols[keep], vals[keep]
    s = tr > tc
    er, ec, ev = (np.concatenate([tr, tc[s]]), np.concatenate([tc, tr[s]]),
                  np.concatenate([tv, tv[s]]))
    objs = {"sym_tri": _build("sym", (info, tr, tc, tv), device),
            "sym_expanded_csr": _build("csr", (info, er, ec, ev), device)}
    bench, _ = _interleaved(objs, device, hbm_bw, repeats)
    for k, r in bench.items():
        print(f"{k}: {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s  "
              f"({_pct(r.roofline_pct)}, {r.bytes_per_nnz:.2f} B/nnz)", file=sys.stderr)
    tri, exp = bench["sym_tri"], bench["sym_expanded_csr"]
    row = {"gnnz_per_s": round(tri.gnnz_per_s, 3),
           "expanded_csr_gnnz_per_s": round(exp.gnnz_per_s, 3),
           "host_triplets_stored": int(tr.size),
           "host_triplets_expanded": int(er.size),
           "device_bytes_tri": int(tri.bytes_per_nnz * tri.nnz),
           "device_bytes_expanded": int(exp.bytes_per_nnz * exp.nnz)}
    return row, {f"__{k}__": r.to_dict() for k, r in bench.items()}


def spmm_suite(trip, *, device, repeats: int = 10):
    """``spmm`` at R = 4 on the main matrix's csr (``bench.py:311-322``).
    Row: Gnnz·vec/s."""
    from spmv_tpu_torch.bench.runner import bench_spmm

    r4 = bench_spmm(_build("csr", trip, device), "csr", 4, repeats=repeats)
    print(f"spmm csr R=4: {r4['ms_per_spmm']:7.3f} ms {r4['gnnzvec_per_s']:6.2f} "
          f"Gnnz·vec/s ({r4['timing']})", file=sys.stderr)
    return round(r4["gnnzvec_per_s"], 3), {"__spmm_r4__": r4}


def bsr_suite(trip, *, device, hbm_bw: float | None = None, repeats: int = 8):
    """BSR at R = 32 on the main matrix (``bench.py:328-355``), its roofline
    on the exact tile, X and Y bytes (a lower bound of its traffic) over the
    co-sampled ceiling, or the H100's 3.35 TB/s without one; None on the
    CPU, which has no ceiling."""
    from spmv_tpu_torch.bench.runner import bench_spmm
    from spmv_tpu_torch.probes.bounds import HBM_PEAK_BPS

    info, rhs = trip[0], 32
    absr = _build("bsr", trip, device)
    rb = bench_spmm(absr, "bsr", rhs, repeats=repeats)
    t_s = rb["ms_per_spmm"] * 1e-3
    tile_bytes = float(absr.tiles.numel() * absr.tiles.element_size())
    xy_bytes = 4.0 * rhs * (absr.ncols + absr.nrows)
    eff_gbps = (tile_bytes + xy_bytes) / t_s / 1e9
    ceiling = hbm_bw or (HBM_PEAK_BPS if torch.device(device).type == "cuda" else None)
    roofline = 100.0 * eff_gbps / (ceiling / 1e9) if ceiling else None
    rb.update(fill=float(absr.fill), effective_gbps=eff_gbps, roofline_pct=roofline)
    row = {"gnnzvec_per_s": round(rb["gnnzvec_per_s"], 3), "rhs": rhs,
           "fill": round(float(absr.fill), 2),
           "roofline_pct": None if roofline is None else round(roofline, 1)}
    print(f"bsr spmm R={rhs}: {rb['ms_per_spmm']:7.3f} ms {rb['gnnzvec_per_s']:6.2f} "
          f"Gnnz·vec/s  (fill {absr.fill:.1f}x, {_pct(roofline)}; {info.nrows} rows, "
          f"{rb['timing']})", file=sys.stderr)
    return row, {"__bsr_spmm__": rb}


def big_triplets(n: int = 4_200_000, avg_nnz_per_row: int = 8, bandwidth: int = 300,
                 seed: int = 0, cache_dir: str = CACHE_DIR):
    """The big cell's triplets, ``synthetic_cant(n, avg_nnz_per_row,
    bandwidth, seed)``, read from ``cache_dir`` when an earlier run saved
    them there (``bench.py:383-406``: the file's name carries every
    parameter and the generator version). Returns ``(trip, cached)``."""
    from spmv_tpu_torch import synth
    from spmv_tpu_torch.io.mmio import MMInfo

    path = os.path.join(cache_dir, f"big_synth_{GENERATOR_VERSION}_{n}_{avg_nnz_per_row}_"
                                   f"{bandwidth}_{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            rows, cols, vals = z["rows"], z["cols"], z["vals"]
            info = MMInfo(object="matrix", format="coordinate", field="real",
                          symmetry="general", nrows=int(z["nrows"]), ncols=int(z["ncols"]),
                          nnz=int(rows.shape[0]))
        return (info, rows, cols, vals), True
    trip = synth.synthetic_cant(n=n, avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth,
                                seed=seed)
    os.makedirs(cache_dir, exist_ok=True)
    info, rows, cols, vals = trip
    np.savez(path, nrows=info.nrows, ncols=info.ncols, rows=rows, cols=cols, vals=vals)
    return trip, False


def big_suite(n: int = 4_200_000, avg_nnz_per_row: int = 8, bandwidth: int = 300,
              seed: int = 0, *, device, hbm_bw: float | None = None, repeats: int = 8,
              cache_dir: str = CACHE_DIR):
    """The big cell (``bench.py:363-428``) on the port's ordinary csr
    container, its plan in HBM (no tiling), the plan cache in
    ``cache_dir``; its ``matvec`` held to ``golden_spmv`` first. Row:
    Gnnz/s (the last line's ``big_tiled_gnnz_per_s``, bench.py's key)."""
    from spmv_tpu_torch.cache import plan_cache

    t0 = time.perf_counter()
    trip, cached = big_triplets(n, avg_nnz_per_row, bandwidth, seed, cache_dir)
    t_trip = time.perf_counter() - t0
    info, rows, cols, vals = trip
    fp = matrix_fingerprint(info, rows, cols, vals, dict(
        n=n, avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth, seed=seed))
    t0 = time.perf_counter()
    with plan_cache(cache_dir):
        big = _build("csr", trip, device)
    t_build = time.perf_counter() - t0
    rep = check_matvec(big, trip)
    if not rep.ok:
        raise ValueError(f"the big cell's csr matvec against golden_spmv: {rep}")
    name = f"csr_{n / 1e6:g}M"
    bench, _ = _interleaved({name: big}, device, hbm_bw, repeats)
    r = bench[name]
    print(f"big {info.nrows} x {info.ncols} csr, no tiling (the plan lives in device "
          f"memory): {r.ms_per_spmv:7.3f} ms  {r.gnnz_per_s:6.2f} Gnnz/s  "
          f"({_pct(r.roofline_pct)}, {big.dev.ntiles} tiles, plan {big.stream_bytes} B, "
          f"L2-resident {r.l2_resident}, cold {_ms(r.cold_ms_per_spmv)}; triplets "
          f"{'read from the cache' if cached else 'synthesized'} in {t_trip:.1f} s, "
          f"plan {t_build:.1f} s; {rep})", file=sys.stderr)
    entry = dict(r.to_dict(), tiles=int(big.dev.ntiles), plan_bytes=int(big.stream_bytes),
                 check=str(rep), triplets_cached=cached, matrix_fingerprint=fp)
    return round(r.gnnz_per_s, 3), {"__big__": entry}


def weak_scaling_suite(rows_per_device: int = 16384, avg_nnz_per_row: int = 32,
                       bandwidth: int = 256, *, device, iters_a: int = 200,
                       iters_b: int = 1000, repeats: int = 5):
    """``weak_scaling_report`` for cmrs with the modelled efficiencies
    (``bench.py:435-466``), on the default process group, or on a one-rank
    group on a local port brought up and torn down here when there is none
    (NCCL for a card, gloo for the CPU)."""
    import torch.distributed as dist

    from spmv_tpu_torch.bench.scaling import weak_scaling_report
    from spmv_tpu_torch.dist.mesh import free_port, init_distributed

    owned = not dist.is_initialized()
    if owned:
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        rep = weak_scaling_report(format="cmrs", rows_per_device=rows_per_device,
                                  avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth,
                                  iters_a=iters_a, iters_b=iters_b, repeats=repeats,
                                  force_model=True)
    finally:
        if owned:
            dist.destroy_process_group()
    modeled = rep.get("modeled_efficiency") or []
    row = {
        "d1_ms_per_spmv": rep["points"][0]["ms_per_spmv"] if rep["points"] else None,
        "backend": rep["backend"],
        "eff_no_overlap": {str(m["devices"]): round(m["eff_no_overlap"], 4) for m in modeled},
        "eff_overlap": {str(m["devices"]): round(m["eff_overlap"], 4) for m in modeled},
        "meets_80pct_target_at_2": (bool(modeled[0]["eff_no_overlap"] >= 0.8)
                                    if modeled else None),
    }
    print(f"weak scaling: D=1 {row['d1_ms_per_spmv']:.4f} ms ({rep['backend']}, "
          f"{'simulated' if rep['simulated'] else rep['timing']}); modeled "
          f"eff(no-overlap) {row['eff_no_overlap']}", file=sys.stderr)
    return row, {"__weak_scaling__": rep}


def _sweep_rank(rank: int, world: int, port: int, params: dict, out) -> None:
    """One gloo rank of ``simulated_sweep`` on the CPU, one torch thread
    (the ranks share the host's cores); rank 0 puts the points on ``out``."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # before anything reaches CUDA
    import torch.distributed as dist

    from spmv_tpu_torch.bench.scaling import weak_scaling
    from spmv_tpu_torch.dist.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        pts = weak_scaling(format="cmrs", iters_a=2, iters_b=6, repeats=1, **params)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out.put([p.to_dict() for p in pts])


def simulated_sweep(rows_per_device: int = 1024, avg_nnz_per_row: int = 8,
                    bandwidth: int = 64, device_counts=(1, 2, 4, 8), *,
                    timeout: float = 900.0):
    """The weak-scaling sweep at D = 1, 2, 4 and 8 on gloo ranks on the CPU
    (``bench.py:473-514``): max(D) spawned ranks, each at one torch thread,
    over the plain versions, killed past ``timeout`` seconds; the numbers
    are simulated and only ``all_points_ran`` counts. Row:
    ``all_points_ran``."""
    import torch.multiprocessing as mp

    from spmv_tpu_torch.dist.mesh import free_port

    params = dict(rows_per_device=rows_per_device, avg_nnz_per_row=avg_nnz_per_row,
                  bandwidth=bandwidth, device_counts=list(device_counts))
    world = max(device_counts)
    out = mp.get_context("spawn").SimpleQueue()
    row = {"simulated": True, "backend": "gloo, cpu (plain versions)", "points": None}
    t0 = time.perf_counter()
    ctx = mp.start_processes(_sweep_rank, args=(world, free_port(), params, out),
                             nprocs=world, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the sweep's {world} ranks ran past {timeout} s")
        row["points"] = out.get() if not out.empty() else None
    except Exception as e:  # a rank failed or ran late: the row says which
        row["error"] = f"{type(e).__name__}: {e}"[-500:]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    row["seconds"] = time.perf_counter() - t0
    pts = row["points"]
    row["all_points_ran"] = bool(pts) and len(pts) == len(device_counts)
    print(f"simulated CPU sweep D={'/'.join(map(str, device_counts))}: "
          f"{'OK' if row['all_points_ran'] else 'FAILED'} in {row['seconds']:.1f} s",
          file=sys.stderr)
    return row["all_points_ran"], {"__simulated_sweep__": row}


# -------------------------------------------------------------------- main


def _run(name: str, fn, results: dict, record: dict):
    """One suite in its own ``try``: its row, or None after printing
    ``<name>: FAILED`` and the traceback; its entries go into ``results``,
    its launches (the counters' growth) and seconds into ``record``."""
    from spmv_tpu_torch.kernels.engines import LAUNCHES

    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    try:
        row, entries = fn()
        results.update(entries)
    except Exception as e:  # a suite that fails leaves its key null, as in bench.py
        print(f"{name}: FAILED {type(e).__name__}: {e}", file=sys.stderr)
        traceback.print_exc(file=sys.stderr)
        row = None
    finally:
        seconds = time.perf_counter() - t0
        record[name] = {"seconds": seconds,
                        "launches": {k: n - before.get(k, 0) for k, n in LAUNCHES.items()
                                     if n > before.get(k, 0)}}
        print(f"[{name}: {seconds:.1f} s]", file=sys.stderr)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spmv_tpu_torch.bench.suite",
                                description="The port's driver benchmark: bench.py's "
                                            "suites, one JSON line on stdout.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions, the host clock)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False); --device cpu "
              "runs the plain PyTorch versions instead", file=sys.stderr)
        return 1
    if device.type not in ("cuda", "cpu"):
        print(f"error: unsupported device {args.device!r}", file=sys.stderr)
        return 1
    card = None
    if device.type == "cuda":
        from spmv_tpu_torch.probes.timing import card_line

        card = card_line(device)
    print(f"bench suite on {device} [{card or 'host clock, no card'}]", file=sys.stderr)

    path = os.environ.get("SPMV_MATRIX", "databases/cant.mtx")
    n = int(os.environ.get("SPMV_N", 62464))
    trip, synthetic, fp = main_matrix(path, n)
    results_path = os.path.join(os.getcwd(), RESULTS_FILE)
    fp_changed = warn_if_fingerprint_changed(fp, results_path)
    info, rows = trip[0], trip[1]
    print(f"matrix: {info.nrows}x{info.ncols} nnz={rows.size}"
          f"{' (SYNTHETIC cant-scale band; real cant.mtx unavailable)' if synthetic else ''}",
          file=sys.stderr)

    results, record = {}, {}
    main_row = _run("main suite", lambda: main_suite(trip, device=device), results, record)
    bw = main_row["bw"] if main_row else None
    pl_row = _run("power-law suite",
                  lambda: power_law_suite(device=device, hbm_bw=bw), results, record) or {}
    pl_big = _run("power-law-big suite",
                  lambda: power_law_big_suite(device=device, hbm_bw=bw), results, record)
    x2_row = _run("f32x2 suite", lambda: x2_suite(trip, device=device, hbm_bw=bw),
                  results, record)
    sym_row = _run("symmetric suite", lambda: sym_suite(trip, device=device, hbm_bw=bw),
                   results, record)
    spmm_row = _run("spmm suite", lambda: spmm_suite(trip, device=device), results, record)
    bsr_row = _run("bsr suite", lambda: bsr_suite(trip, device=device, hbm_bw=bw),
                   results, record)
    big_row = None
    if not os.environ.get("SPMV_SKIP_BIG"):
        cache_dir = os.path.join(os.getcwd(), CACHE_DIR)
        big_row = _run("big-matrix suite",
                       lambda: big_suite(device=device, hbm_bw=bw, cache_dir=cache_dir),
                       results, record)
    ws_row = _run("weak-scaling suite", lambda: weak_scaling_suite(device=device),
                  results, record)
    sim_ok = None
    if not os.environ.get("SPMV_SKIP_SIM_SWEEP"):
        sim_ok = _run("simulated sweep", simulated_sweep, results, record)

    results["__matrix_fingerprint__"] = fp
    results["__suites__"] = record
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)

    if main_row is None or main_row["best"] is None:
        print(json.dumps({"metric": "spmv_best_gnnz_per_s", "value": 0.0,
                          "unit": "Gnnz/s", "vs_baseline": 0.0, "card": card}))
        return 1
    rated = {k: r for k, r in results.items() if isinstance(r, dict)}
    line = {
        "metric": "spmv_best_gnnz_per_s",
        "value": round(main_row["best"], 3),
        "unit": "Gnnz/s",
        "vs_baseline": vs_baseline(main_row["min_roofline_pct"]),
        "synthetic_matrix": synthetic,
        "sell_beats_ell_on_power_law": pl_row.get("sell_beats_ell_on_power_law"),
        "split_routing_sound": pl_row.get("split_routing_sound"),
        "power_law_best_gnnz_per_s": pl_row.get("power_law_best_gnnz_per_s"),
        "power_law_big_best_gnnz_per_s": pl_big,
        "big_tiled_gnnz_per_s": big_row,
        "spmm_r4_gnnzvec_per_s": spmm_row,
        "bsr_spmm_r32": bsr_row,
        "symmetric_storage": sym_row,
        "x2_csr": x2_row,
        "weak_scaling": ws_row,
        "simulated_sweep_ok": sim_ok,
        "matrix_fingerprint": {"generator": fp["generator"], "nnz": fp["nnz"],
                               "triplet_hash": fp["triplet_hash"]},
        "fingerprint_changed_since_last_run": fp_changed,
        "roofline_pct_per_format": {k: round(r["roofline_pct"], 1) for k, r in rated.items()
                                    if r.get("roofline_pct") is not None},
        "true_nnz_sol_pct_per_format": {k: round(r["true_eff_pct"], 1)
                                        for k, r in rated.items()
                                        if r.get("true_eff_pct") is not None},
        "card": card,
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

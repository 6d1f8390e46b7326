"""Command-line interface of the PyTorch port.

    python -m spmv_tpu_torch run   --format csr --matrix databases/cant.mtx
    python -m spmv_tpu_torch run   --format sell --rhs 4
    python -m spmv_tpu_torch run   --format csr --dtype f32x2 --bench --json r.json
    python -m spmv_tpu_torch bench --formats all --probe-bw --json out.json
    python -m spmv_tpu_torch bench --scaling --rows-per-device 16384
    torchrun --nproc-per-node 2 -m spmv_tpu_torch bench --scaling --device cpu
    python -m spmv_tpu_torch solve --format csr --solver cg --cache-dir .cache
    python -m spmv_tpu_torch info  --matrix m.mtx
    python -m spmv_tpu_torch devices

Counterpart of ``spmv_tpu/cli.py`` (``run``, ``bench``, ``solve``,
``info``, ``devices``). ``run`` mirrors one reference driver end to end:
load (or synthesize) → convert → SpMV on the device → fp64 golden
validation → a timed host SpMV beside it, with the reference's ``x[i] =
i`` input (``coo.c:88-92``) by default. With ``--rhs R`` it runs ``spmm``
on R columns (column j made with seed + j, as ``spmv_tpu/cli.py:197``
makes them) and validates every column. With ``--dtype f32x2`` it runs the
fp64-grade mode (``x2.X2Matrix``; the port computes it in fp64) and
validates at JAX's x2 criterion (``x2_check``), as
``spmv_tpu/cli.py:117-177`` does. ``--bench`` then times the container
(``bench.runner``; ``spmv_tpu/cli.py:227-250``) and ``--json`` writes the
result.

``bench`` (``spmv_tpu/cli.py:254-334``) times ``--formats`` (``all``: the
six matvec formats, no bsr) interleaved in one rotation, with the
co-sampled HBM ceiling under ``--probe-bw``; ``--rhs R`` > 1 or ``bsr``
(R = 128 by default) time ``spmm``; ``--dtype f32x2`` the fp64-grade mode
of the formats that have one. It prints one header line that names the
card and its power limit, then JAX's line per format; ``--json`` writes
``{format: result}``; ``--profile DIR`` writes a ``torch.profiler`` chrome
trace of the run for viewing (no number is taken from it). ``bench
--scaling`` (``spmv_tpu/cli.py:258-280``) runs the weak-scaling sweep of
``bench.scaling`` on ``--formats`` (one format, default cmrs) at
``--rows-per-device`` rows per device, over D = 1, 2, 4, … up to the
process group's size, and prints JAX's lines; under ``torchrun
--nproc-per-node D -m spmv_tpu_torch bench --scaling`` every rank runs it
and only rank 0 prints and writes. Without a group it brings up one rank
on a local port (NCCL on a card, gloo with ``--device cpu``); in a group
that is up, a ``--device`` of another kind than its ranks' is refused.

``solve`` runs ``solve.cg``, ``bicgstab`` or ``power_iteration`` and checks
the residual again in fp64 on the host, as ``spmv_tpu/cli.py:354-404``
does. ``--cache-dir`` keeps the parsed triplets and the built plans as
``.npz`` (``cache``).

``--device`` defaults to ``cuda``: without a card ``run``, ``bench`` and
``solve`` stop with an error and do not carry on on the CPU. ``--device
cpu`` is the explicit CPU route, through the kernels' plain PyTorch
versions; there ``bench`` times with the host clock and names no card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from spmv_tpu_torch.errors import ReturnCode

FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb", "bsr"]
# JAX's ALL_FORMATS (spmv_tpu/cli.py:27), the matvec suite of ``bench
# --formats all``; ``solve`` takes the same, as BSR's block-dense container
# is SpMM-shaped (spmv_tpu/cli.py:384-386)
ALL_FORMATS = FORMATS[:-1]
SOLVE_FORMATS = ALL_FORMATS


def _load(args):
    from spmv_tpu_torch.cache import load_triplets

    synth_kwargs = dict(n=args.synth_n) if args.synth_n else {}
    return load_triplets(args.matrix, args.cache_dir, **synth_kwargs)


def _make_x(mode: str, ncols: int, seed: int = 0) -> np.ndarray:
    if mode == "index":  # the reference's vector (coo.c:88-92)
        return np.arange(ncols, dtype=np.float32)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(ncols).astype(np.float32)


def _cpu_comparison(info, rows, cols, vals, x) -> None:
    """Timed host SpMV beside the device verdict — reference parity with
    ``compute_using_cpu`` and its GFLOP/s print (``coo.c:280-300``)."""
    from spmv_tpu_torch.oracle import check_result, golden_spmv

    def host_spmv():
        y = np.zeros(info.nrows, dtype=np.float64)
        np.add.at(y, np.asarray(rows, dtype=np.int64),
                  np.asarray(vals, np.float64) * np.asarray(x, np.float64)[cols])
        return y

    host_spmv()  # warm caches, like the device warm-up
    t0 = time.perf_counter()
    y_cpu = host_spmv()
    ms = max((time.perf_counter() - t0) * 1e3, 1e-6)
    rep = check_result(golden_spmv(info.nrows, rows, cols, vals, x), y_cpu)
    print(f"CPU: {ms:.3f} ms  {2 * rows.size / ms * 1e-6:.2f} GFLOP/s  "
          f"({'ok' if rep.ok else 'WRONG'})")


def _device_error(device: str) -> str | None:
    """Why ``device`` cannot run, or None."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        return ("no CUDA device (torch.cuda.is_available() is False); "
                "--device cpu runs the plain PyTorch versions instead")
    if kind not in ("cuda", "cpu"):
        return f"unsupported device {device!r}"
    return None


def _validate_x2(nrows, rows, cols, vals, x, y):
    """JAX's f32x2 verdict (``spmv_tpu/cli.py:145-151``)."""
    from spmv_tpu_torch.oracle import golden_spmv, row_scale, x2_check

    return x2_check(golden_spmv(nrows, rows, cols, vals, x), y,
                    row_scale(nrows, rows, cols, vals, x))


def run_spmv(fmt: str, info, rows, cols, vals, *, x_mode: str = "index",
             seed: int = 0, device: str = "cuda", rhs: int = 1,
             dtype: str = "f32", bench: bool = False, json_path: str = "") -> int:
    """Convert, run one SpMV (or with ``rhs`` > 1 one SpMM on ``rhs``
    columns) on ``device``, validate against the fp64 oracle and print the
    verdict; the ``run`` command after loading (which has checked that
    ``device`` is usable). ``dtype="f32x2"`` runs the fp64-grade mode:
    ``X2Matrix``, an fp64 x (column j from seed + j), fp64 y, every column
    held to ``x2_check``. ``bench`` then times the container (``spmm`` at
    ``rhs`` > 1, the fp64-grade ``matvec`` in any case, as JAX's ``run``
    does) and ``json_path`` receives the result."""
    import spmv_tpu_torch
    from spmv_tpu_torch.kernels import engines

    rhs = max(int(rhs), 1)
    x2 = dtype == "f32x2"
    out_dtype = torch.float64 if x2 else torch.float32
    x_type = np.float64 if x2 else np.float32  # JAX's _run_x2 casts x so
    try:
        if x2:
            a = spmv_tpu_torch.X2Matrix.from_coo(fmt, info.nrows, info.ncols,
                                                 rows, cols, vals, device=device)
        else:
            a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, rows, cols,
                                        vals, device=device)
        before = dict(engines.LAUNCHES)
        if rhs > 1:
            X = np.stack([_make_x(x_mode, info.ncols, seed + j).astype(x_type)
                          for j in range(rhs)], axis=1)
            Y = spmv_tpu_torch.device.Y_to_numpy(spmv_tpu_torch.spmm(a, X),
                                                 info.nrows, rhs, out_dtype)
        else:
            x = _make_x(x_mode, info.ncols, seed).astype(x_type)
            y = spmv_tpu_torch.device.y_to_numpy(a.matvec(x), info.nrows, out_dtype)
    except (ValueError, NotImplementedError) as e:  # a matrix the format refuses
        print(f"error: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR
    except Exception as e:
        # any other failure while converting or multiplying (a build error,
        # a CUDA error, out of memory) is PROGRAM_ERROR too, as
        # spmv_tpu/cli.py:141-143 and :203-205 return
        print(f"kernel error: {type(e).__name__}: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR
    ran = [k for k, n in engines.LAUNCHES.items() if n > before[k]]
    on = a.device if isinstance(a, spmv_tpu_torch.BSRMatrix) else a.dev.device
    where = (torch.cuda.get_device_name(on) if on.type == "cuda"
             else "plain PyTorch versions")
    if getattr(a, "parts", None) is not None:
        extra = (f" (split: {a.shape}, panel {a.panel_nnz} + spill "
                 f"{a.spill_nnz} nnz)")
    elif isinstance(a, spmv_tpu_torch.BSRMatrix):
        extra = (f" ({a.tiles.shape[0]} tiles, fill {a.fill:.2f}x, precision "
                 f"{a.precision}; batched matmul, no kernel of the port)")
    else:
        extra = ""
    if x2:
        extra += " [f32x2: fp64 values, x and y]"
    print(f"{fmt}: {info.nrows} x {info.ncols}, nnz {rows.size}, plan "
          f"{a.stream_bytes / 1e6:.2f} MB{extra} on {on} ({where}); "
          f"kernels: {' + '.join(ran) or 'none'}")
    if fmt == "ell" and not x2:  # parity with ell.c:103-104, spmv_tpu/cli.py:207-210
        st = a.row_length_stats
        print(f"row length: average {st['average']:.2f}, "
              f"shortest {st['shortest']}, longest {st['longest']}")
    from spmv_tpu_torch.oracle import spmv_check

    check = _validate_x2 if x2 else spmv_check
    tag = "f32x2, " if x2 else ""
    if rhs == 1:
        rep = check(info.nrows, rows, cols, vals, x, y)
        print(f"{rep}  [f32x2]" if x2 else rep)
        _cpu_comparison(info, rows, cols, vals, x)
        ok = rep.ok
    else:
        reps = [check(info.nrows, rows, cols, vals, X[:, j], Y[:, j]) for j in range(rhs)]
        bad = next((j for j, rep in enumerate(reps) if not rep.ok), None)
        if bad is not None:  # the first failing column, not the last one checked
            print(f"{reps[bad]}  [{tag}column {bad} of {rhs} right-hand sides]")
        else:
            print(f"{reps[-1]}  [{tag}{rhs} right-hand sides]")
        ok = bad is None
    if bench:
        _bench_run(a, f"{fmt}/x2" if x2 else fmt, 1 if x2 else rhs, json_path)
    return ReturnCode.SUCCESS if ok else ReturnCode.VALIDATION_FAILED


def _where(card: str | None) -> str:
    return f"[{card}]" if card else "[host clock, no card]"


def _roofline(r) -> str:
    return ("roofline not measured" if r.roofline_pct is None
            else f"{r.roofline_pct:4.1f}% roofline")


def _bench_run(a, name: str, rhs: int, json_path: str) -> None:
    """``run --bench``: one container timed (``spmv_tpu/cli.py:227-250``)."""
    from spmv_tpu_torch.bench.runner import bench_format, bench_spmm

    if rhs > 1:
        d = bench_spmm(a, name, rhs)
        print(f"{d['ms_per_spmm']:.3f} ms/SpMM  {d['gnnzvec_per_s']:.2f} Gnnz·vec/s  "
              f"{d['gflops']:.1f} GFLOP/s (R={rhs}, {d['timing']})  {_where(d['card'])}")
    else:
        r = bench_format(a, name)
        d = r.to_dict()
        print(f"{r.ms_per_spmv:.3f} ms/SpMV  {r.gnnz_per_s:.2f} Gnnz/s  "
              f"{r.gflops:.1f} GFLOP/s  {r.effective_gbps:.0f} GB/s effective "
              f"({_roofline(r)}, cold {_ms(r.cold_ms_per_spmv)}, {r.timing})  "
              f"{_where(r.card)}")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(d, f, indent=2)


def _ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def cmd_run(args) -> int:
    why = _device_error(args.device)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:  # any failure to read is FILE_ERROR, as in JAX
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    return run_spmv(args.format, info, rows, cols, vals, x_mode=args.x,
                    seed=args.seed, device=args.device, rhs=args.rhs,
                    dtype=args.dtype, bench=args.bench, json_path=args.json)


def _profiled(directory: str, device: torch.device):
    """``--profile DIR``: a ``torch.profiler`` chrome trace of the block,
    written to ``DIR/trace.json`` for viewing; no number is taken from it
    (on the card's machine it drops kernel records, PERF.md)."""
    if not directory:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(directory, exist_ok=True)
    print(f"writing profiler trace to {directory}", file=sys.stderr)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    prof = profile(activities=activities)

    @contextlib.contextmanager
    def run():
        with prof:
            yield
        prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    return run()


def cmd_bench(args) -> int:
    """Time ``--formats`` (``bench.runner``) and print JAX's line per format
    (``spmv_tpu/cli.py:254-334``) after one header line with the card's
    name and power limit. The matvec formats run interleaved in one
    rotation (with the co-sampled HBM ceiling under ``--probe-bw``); the
    ``spmm`` ones (``--rhs`` > 1, or bsr at R = 128) one after another."""
    from spmv_tpu_torch import from_coo
    from spmv_tpu_torch.bench.runner import bench_formats_interleaved, bench_spmm
    from spmv_tpu_torch.probes.timing import card_line
    from spmv_tpu_torch.x2 import X2_FORMATS, X2Matrix

    if args.scaling:
        return _bench_scaling(args)
    why = _device_error(args.device)
    if why is None and args.probe_bw and torch.device(args.device).type != "cuda":
        why = "--probe-bw measures the HBM ceiling of a CUDA card"
    if why:
        print(f"error: {why}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:  # any failure to read is FILE_ERROR, as in JAX
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    device = torch.device(args.device)
    formats = ALL_FORMATS if args.formats == "all" else args.formats.split(",")
    rhs = max(int(args.rhs), 1)
    x2 = args.dtype == "f32x2"
    if x2:
        formats = [f for f in formats if f in X2_FORMATS]
    card = card_line(device) if device.type == "cuda" else None
    print(f"bench: {info.nrows} x {info.ncols}, nnz {rows.size}, formats "
          f"{','.join(formats)}{' f32x2' if x2 else ''} on {device}  {_where(card)}")
    results, lines = {}, {}
    try:
        with _profiled(args.profile, device):
            spmv = {}
            for fmt in formats:
                if x2:
                    spmv[f"{fmt}/x2"] = X2Matrix.from_coo(
                        fmt, info.nrows, info.ncols, rows, cols, vals, device=device)
                    continue
                a = from_coo(fmt, info.nrows, info.ncols, rows, cols, vals, device=device)
                if rhs > 1 or fmt == "bsr":
                    d = bench_spmm(a, fmt, rhs if rhs > 1 else 128)
                    results[fmt] = d
                    lines[fmt] = (f"{fmt:5s}: {d['ms_per_spmm']:7.3f} ms  "
                                  f"{d['gnnzvec_per_s']:6.2f} Gnnz·vec/s "
                                  f"{d['gflops']:8.1f} GFLOP/s  (R={d['rhs']}, "
                                  f"{d['timing']})")
                    del a
                else:
                    spmv[fmt] = a
            if spmv:
                out = bench_formats_interleaved(spmv, probe=args.probe_bw)
                timed, bw = out if args.probe_bw else (out, None)
                if bw is not None:
                    print(f"HBM ceiling (co-sampled hbm member, warm): {bw / 1e9:.1f} GB/s")
                for name, r in timed.items():
                    results[name] = r.to_dict()
                    label = name if x2 else f"{name:5s}"
                    lines[name] = (f"{label}: {r.ms_per_spmv:7.3f} ms  "
                                   f"{r.gnnz_per_s:6.2f} Gnnz/s {r.gflops:8.1f} GFLOP/s  "
                                   f"{_roofline(r)} (pad "
                                   f"{r.padded_slots / max(r.nnz, 1):.2f}x; cold "
                                   f"{_ms(r.cold_ms_per_spmv)}, {r.timing})")
    except (ValueError, NotImplementedError) as e:  # a matrix a format refuses
        print(f"error: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR
    for name in (f"{f}/x2" if x2 else f for f in formats):
        print(lines[name])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return ReturnCode.SUCCESS


def _bench_scaling(args) -> int:
    """``bench --scaling``: the weak-scaling sweep (``bench.scaling``) and
    JAX's lines (``spmv_tpu/cli.py:258-280``), after a header line with the
    card's name and power limit. It runs on the default process group,
    and brings up a group of one rank on a local port when there is none
    (torchrun's environment when it is set); rank 0 prints and writes."""
    import torch.distributed as dist

    from spmv_tpu_torch.bench.scaling import weak_scaling_report
    from spmv_tpu_torch.dist.mesh import free_port, init_distributed

    why = _device_error(args.device)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    fmt = args.formats if args.formats != "all" else "cmrs"
    if fmt not in ALL_FORMATS:
        print(f"error: --scaling takes one of {', '.join(ALL_FORMATS)}, not {fmt!r}",
              file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR
    owned = not dist.is_initialized()
    if not owned:  # the group's backend fixes the ranks' device (dist.mesh)
        on = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if torch.device(args.device).type != on:
            print(f"error: --device {args.device}, but the process group's "
                  f"{dist.get_backend()} ranks run on {on}", file=sys.stderr)
            return ReturnCode.DEVICE_ERROR
    elif "MASTER_ADDR" in os.environ:  # torchrun's environment
        init_distributed(device=args.device)
    else:
        init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=args.device)
    try:
        rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
        # JAX's CLI's iteration counts (spmv_tpu/cli.py:265-268)
        rep = weak_scaling_report(format=fmt, rows_per_device=args.rows_per_device,
                                  iters_a=200, iters_b=1000, repeats=5)
    finally:
        if owned:
            dist.destroy_process_group()
    if rank != 0:
        return ReturnCode.SUCCESS
    print(f"bench --scaling: {fmt}, {args.rows_per_device} rows per device, "
          f"{world} rank(s) ({backend})  {_where(rep['card'])}")
    tag = " (SIMULATED backend; numbers not meaningful)" if rep["simulated"] else ""
    for pt in rep["points"]:
        print(f"D={pt['devices']:3d}: {pt['ms_per_spmv']:7.3f} ms  "
              f"{pt['gnnz_per_s']:6.2f} Gnnz/s  "
              f"eff {pt['efficiency']:.2f}{tag}")
    for m in rep.get("modeled_efficiency", []):
        print(f"D={m['devices']:3d}: modeled eff "
              f"{m['eff_no_overlap']:.2f}-{m['eff_overlap']:.2f} "
              f"(NVLink all-gather {m['t_comm_us']:.1f} us)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2)
    return ReturnCode.SUCCESS


def cmd_solve(args) -> int:
    """An iterative solve, or power iteration, around the format's SpMV
    kernels (``solve``). One solve on a fresh container: the eager loop,
    which a one-shot solve runs faster than a CUDA graph it would capture."""
    import spmv_tpu_torch
    from spmv_tpu_torch import solve
    from spmv_tpu_torch.oracle import golden_spmv

    why = _device_error(args.device)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:  # any failure to read is FILE_ERROR, as in JAX
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    if info.nrows != info.ncols:
        print(f"solve requires a square matrix, got "
              f"{info.nrows}x{info.ncols}", file=sys.stderr)
        return ReturnCode.OTHER_ERROR
    try:
        a = spmv_tpu_torch.from_coo(args.format, info.nrows, info.ncols,
                                    rows, cols, vals, device=args.device)
    except Exception as e:
        print(f"{args.format}: {type(e).__name__}: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR

    if args.solver == "power":
        t0 = time.perf_counter()
        lam, _ = solve.power_iteration(a, iters=args.maxiter)
        dt = time.perf_counter() - t0
        print(f"power iteration: |lambda_max| ~= {lam:.6e} "
              f"({args.maxiter} iterations, {dt * 1e3:.1f} ms)")
        return ReturnCode.SUCCESS

    b = _make_x(args.b, info.nrows, args.seed)
    fn = solve.cg if args.solver == "cg" else solve.bicgstab
    t0 = time.perf_counter()
    x, iters, res = fn(a, b, tol=args.tol, maxiter=args.maxiter)
    dt = time.perf_counter() - t0
    r64 = golden_spmv(info.nrows, rows, cols, vals, x.cpu().numpy().astype(np.float64))
    rel = float(np.linalg.norm(r64 - b) / max(np.linalg.norm(b), 1e-30))
    # JAX's rule, and a finite residual: a NaN also stops the loop early,
    # which the rule alone would call converged
    converged = (iters < args.maxiter or rel <= args.tol * 10) and np.isfinite(rel)
    print(f"{args.solver}: {iters} iterations, {dt * 1e3:.1f} ms, "
          f"device residual {res:.3e}, fp64 relative residual {rel:.3e}"
          f" ({'converged' if converged else 'NOT converged'})")
    return ReturnCode.SUCCESS if converged else ReturnCode.VALIDATION_FAILED


def cmd_info(args) -> int:
    try:
        info, rows, cols, vals = _load(args)
    except Exception as e:  # any failure to read is FILE_ERROR, as in JAX
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    lengths = (np.bincount(rows, minlength=max(info.nrows, 1)) if rows.size
               else np.zeros(1, np.int64))
    print(f"{info.nrows} x {info.ncols}, nnz {rows.size} "
          f"({info.field} {info.symmetry})")
    print(f"row length: average {lengths.mean():.2f}, "
          f"shortest {int(lengths.min())}, longest {int(lengths.max())}")
    return ReturnCode.SUCCESS


def cmd_devices(args) -> int:
    """List the CUDA devices (the analog of the reference's
    ``get_device_ids`` walk, helper_functions.h:76-129)."""
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    n = torch.cuda.device_count()
    print(f"cuda: {n} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"  [{i}] {p.name} (sm_{p.major}{p.minor}, "
              f"{p.multi_processor_count} SMs, {p.total_memory / 2**30:.1f} GiB)")
    return ReturnCode.SUCCESS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spmv-tpu-torch",
                                description="SpMV on an NVIDIA GPU (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--matrix", default="databases/cant.mtx",
                        help=".mtx path (LFS pointers / missing files are "
                             "synthesized)")
        sp.add_argument("--synth-n", type=int, default=0,
                        help="synthesis size when the matrix file is absent")
        sp.add_argument("--cache-dir", default="",
                        help="npz cache of parsed triplets and built plans")

    r = sub.add_parser("run", help="one format end-to-end with validation")
    common(r)
    r.add_argument("--format", default="csr", choices=FORMATS)
    r.add_argument("--x", default="index", choices=["index", "random"],
                   help="input vector: reference x[i]=i or random")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--rhs", type=int, default=1,
                   help="right-hand sides: R > 1 runs spmm on an (ncols, R) X")
    r.add_argument("--dtype", default="f32", choices=["f32", "f32x2"],
                   help="f32, or f32x2: the fp64-grade mode (computed in "
                        "fp64 here), validated at the reference's 1e-6")
    r.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    r.add_argument("--bench", action="store_true",
                   help="time the container after the check (bench.runner)")
    r.add_argument("--json", default="", help="write the --bench result here")
    r.set_defaults(fn=cmd_run)

    b = sub.add_parser("bench", help="benchmark formats")
    common(b)
    b.add_argument("--formats", default="all",
                   help="comma-separated, or all (the six matvec formats)")
    b.add_argument("--probe-bw", action="store_true",
                   help="co-sample the HBM ceiling for the roofline (a card only)")
    b.add_argument("--scaling", action="store_true",
                   help="weak-scaling sweep over the process group's ranks "
                        "(--formats picks ONE format, default cmrs)")
    b.add_argument("--rows-per-device", type=int, default=16384,
                   help="rows per device of the --scaling sweep")
    b.add_argument("--rhs", type=int, default=1,
                   help="right-hand sides: >1 benches SpMM instead of SpMV "
                        "(bsr defaults to R=128 even without this flag)")
    b.add_argument("--dtype", default="f32", choices=["f32", "f32x2"],
                   help="f32x2 benches the fp64-grade mode (csr/coo/cmrs/ell/"
                        "sell/hyb)")
    b.add_argument("--profile", default="",
                   help="directory for a torch.profiler chrome trace of the bench")
    b.add_argument("--json", default="")
    b.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu (host clock)")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("solve", help="iterative solve (CG/BiCGSTAB) or power "
                                     "iteration around the SpMV kernels")
    common(s)
    s.add_argument("--format", default="csr", choices=SOLVE_FORMATS)
    s.add_argument("--solver", default="bicgstab",
                   choices=["cg", "bicgstab", "power"],
                   help="cg assumes SPD; bicgstab handles general square")
    s.add_argument("--b", default="random", choices=["index", "random"],
                   help="right-hand side")
    s.add_argument("--tol", type=float, default=1e-5)
    s.add_argument("--maxiter", type=int, default=1000)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    s.set_defaults(fn=cmd_solve)

    i = sub.add_parser("info", help="matrix statistics")
    common(i)
    i.set_defaults(fn=cmd_info)

    d = sub.add_parser("devices", help="list CUDA devices")
    d.set_defaults(fn=cmd_devices)

    args = p.parse_args(argv)
    from spmv_tpu_torch.cache import plan_cache

    with plan_cache(getattr(args, "cache_dir", "") or None):
        return int(args.fn(args))


if __name__ == "__main__":
    sys.exit(main())

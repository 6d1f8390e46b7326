"""Command-line interface of the PyTorch port.

    python -m spmv_tpu_torch run  --format csr --matrix databases/cant.mtx
    python -m spmv_tpu_torch run  --format sell --rhs 4
    python -m spmv_tpu_torch run  --format csr --dtype f32x2
    python -m spmv_tpu_torch solve --format csr --solver cg --cache-dir .cache
    python -m spmv_tpu_torch info --matrix m.mtx
    python -m spmv_tpu_torch devices

Counterpart of ``spmv_tpu/cli.py`` (``run``, ``solve``, ``info``,
``devices``; ``bench`` is not ported yet). ``run``
mirrors one reference driver end to end: load (or synthesize) → convert →
SpMV on the device → fp64 golden validation → a timed host SpMV beside it,
with the reference's ``x[i] = i`` input (``coo.c:88-92``) by default. With
``--rhs R`` it runs ``spmm`` on R columns (column j made with seed + j, as
``spmv_tpu/cli.py:197`` makes them) and validates every column. With
``--dtype f32x2`` it runs the fp64-grade mode (``x2.X2Matrix``; the port
computes it in fp64) and validates at JAX's x2 criterion (``x2_check``),
as ``spmv_tpu/cli.py:117-177`` does. ``solve`` runs ``solve.cg``,
``bicgstab`` or ``power_iteration`` and checks the residual again in fp64
on the host, as ``spmv_tpu/cli.py:354-404`` does. ``--cache-dir`` keeps
the parsed triplets and the built plans as ``.npz`` (``cache``).

``--device`` defaults to ``cuda``: without a card ``run`` stops with an
error and does not carry on on the CPU. ``--device cpu`` is the explicit
CPU route, through the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from spmv_tpu_torch.errors import ReturnCode

FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb", "bsr"]
# the formats ``solve`` takes: BSR's block-dense container is SpMM-shaped
# (spmv_tpu/cli.py:384-386)
SOLVE_FORMATS = FORMATS[:-1]


def _load(args):
    from spmv_tpu_torch.cache import load_triplets

    synth_kwargs = dict(n=args.synth_n) if args.synth_n else {}
    return load_triplets(args.matrix, args.cache_dir, **synth_kwargs)


def _make_x(mode: str, ncols: int, seed: int = 0) -> np.ndarray:
    if mode == "index":  # the reference's vector (coo.c:88-92)
        return np.arange(ncols, dtype=np.float32)
    rng = np.random.default_rng(seed)
    return rng.standard_normal(ncols).astype(np.float32)


def _validate(info, rows, cols, vals, x, y):
    from spmv_tpu_torch.oracle import golden_spmv, kernel_check, row_scale

    expected = golden_spmv(info.nrows, rows, cols, vals, x)
    scale = row_scale(info.nrows, rows, cols, vals, x)
    lengths = (np.bincount(rows, minlength=max(info.nrows, 1)) if rows.size
               else np.zeros(1, np.int64))
    return kernel_check(expected, y, scale, int(lengths.max()))


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


def _validate_x2(info, rows, cols, vals, x, y):
    """JAX's f32x2 verdict (``spmv_tpu/cli.py:145-151``)."""
    from spmv_tpu_torch.oracle import golden_spmv, row_scale, x2_check

    return x2_check(golden_spmv(info.nrows, rows, cols, vals, x), y,
                    row_scale(info.nrows, rows, cols, vals, x))


def run_spmv(fmt: str, info, rows, cols, vals, *, x_mode: str = "index",
             seed: int = 0, device: str = "cuda", rhs: int = 1,
             dtype: str = "f32") -> int:
    """Convert, run one SpMV (or with ``rhs`` > 1 one SpMM on ``rhs``
    columns) on ``device``, validate against the fp64 oracle and print the
    verdict; the ``run`` command after loading (which has checked that
    ``device`` is usable). ``dtype="f32x2"`` runs the fp64-grade mode:
    ``X2Matrix``, an fp64 x (column j from seed + j), fp64 y, every column
    held to ``x2_check``."""
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
    check = _validate_x2 if x2 else _validate
    tag = "f32x2, " if x2 else ""
    if rhs == 1:
        rep = check(info, rows, cols, vals, x, y)
        print(f"{rep}  [f32x2]" if x2 else rep)
        _cpu_comparison(info, rows, cols, vals, x)
        return ReturnCode.SUCCESS if rep.ok else ReturnCode.VALIDATION_FAILED
    reps = [check(info, rows, cols, vals, X[:, j], Y[:, j]) for j in range(rhs)]
    bad = next((j for j, rep in enumerate(reps) if not rep.ok), None)
    if bad is not None:  # the first failing column, not the last one checked
        print(f"{reps[bad]}  [{tag}column {bad} of {rhs} right-hand sides]")
        return ReturnCode.VALIDATION_FAILED
    print(f"{reps[-1]}  [{tag}{rhs} right-hand sides]")
    return ReturnCode.SUCCESS


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
                    dtype=args.dtype)


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
    r.set_defaults(fn=cmd_run)

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

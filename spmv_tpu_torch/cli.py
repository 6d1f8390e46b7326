"""Command-line interface of the PyTorch port.

    python -m spmv_tpu_torch run  --format csr --matrix databases/cant.mtx
    python -m spmv_tpu_torch info --matrix m.mtx
    python -m spmv_tpu_torch devices

Counterpart of ``spmv_tpu/cli.py`` (``run``, ``info``, ``devices``). ``run``
mirrors one reference driver end to end: load (or synthesize) → convert →
SpMV on the device → fp64 golden validation → a timed host SpMV beside it,
with the reference's ``x[i] = i`` input (``coo.c:88-92``) by default.

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

FORMATS = ["coo", "csr", "cmrs"]


def _load(args):
    from spmv_tpu_torch.io import mmio

    synth_kwargs = dict(n=args.synth_n) if args.synth_n else {}
    return mmio.read_path_or_synthesize(args.matrix, **synth_kwargs)


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


def run_spmv(fmt: str, info, rows, cols, vals, *, x_mode: str = "index",
             seed: int = 0, device: str = "cuda") -> int:
    """Convert, run one SpMV on ``device``, validate against the fp64
    oracle and print the verdict; the ``run`` command after loading (which
    has checked that ``device`` is usable)."""
    import spmv_tpu_torch
    from spmv_tpu_torch.kernels import _build, engines

    try:
        a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, rows, cols,
                                    vals, device=device)
        x = _make_x(x_mode, info.ncols, seed)
        before = dict(engines.LAUNCHES)
        y = spmv_tpu_torch.device.y_to_numpy(a.matvec(x), info.nrows)
    except (_build.BuildError, engines.KernelError) as e:
        print(f"kernel error: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return ReturnCode.OTHER_ERROR
    ran = [k for k, n in engines.LAUNCHES.items() if n > before[k]]
    where = (torch.cuda.get_device_name(a.dev.device)
             if a.dev.device.type == "cuda" else "plain PyTorch versions")
    print(f"{fmt}: {info.nrows} x {info.ncols}, nnz {rows.size}, plan "
          f"{a.dev.stream_bytes / 1e6:.2f} MB on {a.dev.device} ({where}); "
          f"kernels: {' + '.join(ran) or 'none'}")
    rep = _validate(info, rows, cols, vals, x, y)
    print(rep)
    _cpu_comparison(info, rows, cols, vals, x)
    return ReturnCode.SUCCESS if rep.ok else ReturnCode.VALIDATION_FAILED


def cmd_run(args) -> int:
    why = _device_error(args.device)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    try:
        info, rows, cols, vals = _load(args)
    except (OSError, ValueError) as e:
        print(f"error reading {args.matrix}: {e}", file=sys.stderr)
        return ReturnCode.FILE_ERROR
    return run_spmv(args.format, info, rows, cols, vals, x_mode=args.x,
                    seed=args.seed, device=args.device)


def cmd_info(args) -> int:
    try:
        info, rows, cols, vals = _load(args)
    except (OSError, ValueError) as e:
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

    r = sub.add_parser("run", help="one format end-to-end with validation")
    common(r)
    r.add_argument("--format", default="csr", choices=FORMATS)
    r.add_argument("--x", default="index", choices=["index", "random"],
                   help="input vector: reference x[i]=i or random")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    r.set_defaults(fn=cmd_run)

    i = sub.add_parser("info", help="matrix statistics")
    common(i)
    i.set_defaults(fn=cmd_info)

    d = sub.add_parser("devices", help="list CUDA devices")
    d.set_defaults(fn=cmd_devices)

    args = p.parse_args(argv)
    return int(args.fn(args))


if __name__ == "__main__":
    sys.exit(main())

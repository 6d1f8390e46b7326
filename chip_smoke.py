#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``spmv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases; any failure exits non-zero, and nothing falls back to the CPU:

1. The card (nvidia-smi name and power limit), and the build of the CUDA
   kernels from ``spmv_tpu_torch/kernels/csrc/`` with nvcc's register and
   spill lines.
2. Each kernel against its plain PyTorch version on the card, on the edge
   cases, a 1024-row band matrix, the cant-scale matrix and two 524,288-row
   power-law matrices (``bench.py``'s ``pl_big``, and the same without its
   column band: about 12.6M nnz, above L2), per row within
   ``1e-5 + fp32_rel_tol(max_row_nnz)·Σ|v||x|``; each kernel twice, with
   bitwise-equal output.
3. The main path: ``python -m spmv_tpu_torch run --format {csr,coo,cmrs}``
   (in process) on ``databases/cant.mtx``, synthesized at n = 62,451 when
   the file is absent, each validated against the fp64 oracle; then CSR on
   the two power-law matrices and on the 512-row matrix of
   ``__graft_entry__.entry()``.
4. The launch counters show that phase 3 went through the kernels.
5. Times of each kernel and of its plain version at cant scale and on
   the power-law matrices, and of the two-dispatch and fused paths from 512
   rows up (the fused threshold): per call (CUDA events around one call,
   median of 30 after warm-up; host launch work included) and on the
   device (``torch.profiler``, the card's own kernel and memset time).
6. One JSON line with the kernels, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "spmv_tpu_torch/kernels/csrc/seg_spmv.cu"
REPLACES = {
    "seg_spmv_tiles": "spmv_tpu/kernels/engines.py:414",
    "carry_fixup": "spmv_tpu/kernels/engines.py:171",
    "csr_spmv_fused": "spmv_tpu/kernels/engines.py:430",
}
REPS = 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median ms of REPS single calls of ``fn``, each between two CUDA
    events on the current stream, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int = 20) -> tuple[float | None, dict]:
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    durations of the kernels and memsets it ran on the card over ``calls``
    calls, in ms, and the same split by kernel name. None when the profiler
    saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key: e.self_device_time_total / calls / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    total = sum(by_name.values())
    return (total if total > 0 else None), by_name


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def slot_rows(dev) -> np.ndarray:
    """Row that owns each carry slot (-1 for slots no row uses)."""
    ptr = dev.ptr.cpu().numpy().astype(np.int64)
    owner = np.full(2 * dev.ntiles, -1, np.int64)
    for r in dev.carry_rows.cpu().numpy():
        ta, tb = ptr[r] // dev.tile, (ptr[r + 1] - 1) // dev.tile
        owner[2 * ta + 1] = r
        owner[2 * np.arange(ta + 1, tb + 1)] = r
    return owner


def within(name: str, got: torch.Tensor, want: torch.Tensor,
           scale: np.ndarray, tol_rel: float) -> float:
    """Max |got - want|; raises unless every entry is within
    1e-5 + tol_rel·scale."""
    from spmv_tpu_torch.oracle import KERNEL_TOL_ABS

    err = (got.double() - want.double()).abs().cpu().numpy()
    bad = err > KERNEL_TOL_ABS + tol_rel * scale
    if bad.any():
        i = int(np.argmax(bad))
        raise AssertionError(f"{name}: entry {i} differs by {err[i]:.3e} "
                             f"(got {float(got[i])}, plain {float(want[i])})")
    return float(err.max()) if err.size else 0.0


def same_bits(name: str, fn) -> torch.Tensor:
    a, b = fn(), fn()
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(u, v):
            raise AssertionError(f"{name}: two runs differ")
    return a


def check_kernels(label: str, trip, seed: int) -> dict:
    """Phase 2 on one matrix: each kernel against its plain version and
    against itself. Returns the max abs error per kernel."""
    from spmv_tpu_torch import CSRMatrix
    from spmv_tpu_torch.kernels import engines as E
    from spmv_tpu_torch.oracle import fp32_rel_tol, golden_spmv, kernel_check, row_scale

    info, rows, cols, vals = trip
    a = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals, device="cuda")
    dev = a.dev
    xh = np.random.default_rng(seed).standard_normal(info.ncols).astype(np.float32)
    x = torch.from_numpy(xh).cuda()
    scale = row_scale(info.nrows, rows, cols, vals.astype(np.float32), xh)
    tol = fp32_rel_tol(dev.max_row_nnz)

    y1, c1 = same_bits("seg_spmv_tiles", lambda: E.segmented_spmv_partials(dev, x))
    y1r, c1r = E.segmented_spmv_partials_reference(dev, x)
    owner = slot_rows(dev)
    cscale = np.where(owner >= 0, scale[np.maximum(owner, 0)], 0.0)
    e1 = max(within(f"{label} seg_spmv_tiles y", y1, y1r, scale, tol),
             within(f"{label} seg_spmv_tiles carry", c1, c1r, cscale, tol))
    y2 = same_bits("carry_fixup", lambda: E.carry_fixup(dev, y1.clone(), c1))
    y2r = E.carry_fixup_reference(dev, y1.clone(), c1)
    e2 = within(f"{label} carry_fixup", y2, y2r, scale, tol)
    y3 = same_bits("csr_spmv_fused", lambda: E.segmented_spmv_fused(dev, x))
    y3r = E.segmented_spmv_fused_reference(dev, x)
    e3 = within(f"{label} csr_spmv_fused", y3, y3r, scale, tol)
    expected = golden_spmv(info.nrows, rows, cols, vals.astype(np.float32), xh)
    for name, y in (("K1+K2", y2), ("K3", y3)):
        rep = kernel_check(expected, y.cpu().numpy(), scale, dev.max_row_nnz)
        if not rep.ok:
            raise AssertionError(f"{label} {name} vs fp64 oracle: {rep}")
    print(f"  {label}: {info.nrows}x{info.ncols} nnz {rows.size} tiles "
          f"{dev.ntiles} split rows {dev.ncarry}: max |kernel - plain| "
          f"K1 {e1:.3e}  K2 {e2:.3e}  K3 {e3:.3e}; K1+K2 and K3 pass the "
          f"fp64 oracle; two runs bitwise equal")
    return {"seg_spmv_tiles": e1, "carry_fixup": e2, "csr_spmv_fused": e3}


def time_matrix(label: str, trip, card: str, plain: bool = True) -> dict:
    """Phase 5 on one matrix: ``{name: (call_ms, device_ms)}`` for each
    kernel, its plain version (with ``plain``) and the K1+K2 path, and the
    plan's bytes under ``plan_bytes``.
    call_ms is what a caller waits per call, host launch work included;
    device_ms is the card's own time (kernels and memsets)."""
    from spmv_tpu_torch import CSRMatrix
    from spmv_tpu_torch.kernels import engines as E

    info, rows, cols, vals = trip
    dev = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals,
                             device="cuda").dev
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        info.ncols).astype(np.float32)).cuda()
    y, carry = E.segmented_spmv_partials(dev, x)
    fns = {
        "seg_spmv_tiles": lambda: E.segmented_spmv_partials(dev, x),
        "carry_fixup": lambda: E.carry_fixup(dev, y, carry),
        "csr_spmv_fused": lambda: E.segmented_spmv_fused(dev, x),
        "path K1+K2": lambda: E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x)),
    }
    if plain:
        fns.update({
            "seg_spmv_tiles_plain": lambda: E.segmented_spmv_partials_reference(dev, x),
            "carry_fixup_plain": lambda: E.carry_fixup_reference(dev, y, carry),
            "csr_spmv_fused_plain": lambda: E.segmented_spmv_fused_reference(dev, x),
        })
    gb = dev.stream_bytes / 1e9
    print(f"  {label}: {info.nrows} rows, nnz {dev.nnz}, plan "
          f"{dev.stream_bytes} B, tiles {dev.ntiles}, split rows {dev.ncarry}, "
          f"K3 lanes/row {E.fused_lanes(dev)}  [{card}]")
    t = {"plan_bytes": dev.stream_bytes}
    for k, fn in fns.items():
        call = time_ms(fn)
        dms, by_name = device_ms(fn)
        t[k] = (call, dms)
        line = (f"    {k:22s} call {call:9.4f} ms  {dev.nnz / call / 1e6:8.2f} "
                f"Gnnz/s  {gb / call * 1e3:8.1f} GB/s | device {fmt_ms(dms)}")
        if dms:
            line += (f"  {dev.nnz / dms / 1e6:8.2f} Gnnz/s  "
                     f"{gb / dms * 1e3:8.1f} GB/s")
        print(f"{line}  [{card}]")
        if not k.endswith("_plain"):
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
                print(f"        {ms:9.4f} ms  {name[:70]}")
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from spmv_tpu_torch import cli, synth
    from spmv_tpu_torch.kernels import _build
    from spmv_tpu_torch.kernels import engines as E

    # 1. the card and the build
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.library()
    print(f"build: {built.path.name}, nvcc {built.seconds:.1f} s, load "
          f"{time.perf_counter() - t0:.1f} s in all")
    for line in built.log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 2. kernels against their plain versions
    print("phase 2: kernels against plain PyTorch versions")
    for name in sorted(synth.EDGE_CASES):
        check_kernels(name, synth.edge_case(name), seed=1)
    check_kernels("band-1024", synth.synthetic_cant(
        n=1024, avg_nnz_per_row=16, bandwidth=60, seed=5), seed=2)
    cant = synth.synthetic_cant()
    errs = check_kernels("cant-62451", cant, seed=3)
    # bench.py's pl_big, and the same generator without the column band:
    # about 12.6M nnz, a plan above the 50 MB L2, hub rows over many tiles
    pl_big = synth.power_law(n=524_288, avg_nnz_per_row=24, bandwidth=512, seed=0)
    pl_wide = synth.power_law(n=524_288, avg_nnz_per_row=24, seed=0)
    check_kernels("pl_big-524288", pl_big, seed=4)
    check_kernels("pl_wide-524288", pl_wide, seed=5)
    torch.cuda.synchronize()

    # 3. the main path, with the launch counters from zero
    print("phase 3: main path")
    entry = synth.synthetic_cant(n=512, avg_nnz_per_row=8, bandwidth=40, seed=0)
    E.reset_launches()
    for fmt in ("csr", "coo", "cmrs"):
        rc = cli.main(["run", "--format", fmt, "--matrix",
                       os.path.join(ROOT, "databases", "cant.mtx")])
        if rc != 0:
            raise SystemExit(f"run --format {fmt} on cant returned {rc}")
    after_cant = dict(E.LAUNCHES)
    for label, trip in (("pl_big", pl_big), ("pl_wide", pl_wide)):
        if cli.run_spmv("csr", *trip, device="cuda") != 0:
            raise SystemExit(f"run on {label} failed")
    if cli.run_spmv("csr", *entry, x_mode="random", seed=1, device="cuda") != 0:
        raise SystemExit("run on the 512-row entry() matrix failed")
    torch.cuda.synchronize()
    launches = dict(E.LAUNCHES)

    # 4. the path went through the kernels
    print(f"phase 4: launches after the cant runs {after_cant}, in all {launches}")
    if after_cant["seg_spmv_tiles"] < 1 or after_cant["carry_fixup"] < 1:
        raise SystemExit("the cant-scale runs did not launch K1 and K2")
    if launches["csr_spmv_fused"] < 1:
        raise SystemExit("the 512-row run did not launch K3")

    # 5. times
    print(f"phase 5: times per call (CUDA events, median of {REPS} single "
          "calls after 3 warm-up calls) and on the device (torch.profiler)")
    tc = time_matrix("cant-62451", cant, card)
    times = {"cant-62451": tc,
             "pl_big-524288": time_matrix("pl_big-524288", pl_big, card),
             "pl_wide-524288": time_matrix("pl_wide-524288", pl_wide, card)}
    # the fused threshold: both paths across plan sizes
    sweep = {"entry-512": entry,
             "band-1024": synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                               bandwidth=60, seed=5),
             "cant-8192": synth.synthetic_cant(n=8192),
             "cant-16384": synth.synthetic_cant(n=16384),
             # bench.py's 32k-row power-law suite, and without its band
             "pl-32768": synth.power_law(n=32768, avg_nnz_per_row=24,
                                         bandwidth=512, seed=0),
             "pl_wide-32768": synth.power_law(n=32768, avg_nnz_per_row=24,
                                              seed=0)}
    for label, trip in sweep.items():
        times[label] = time_matrix(label, trip, card, plain=False)
    print(f"fused threshold: K1+K2 against K3, ms per call | device  [{card}]")
    for label, t in times.items():
        print(f"  {label:16s} plan {t['plan_bytes']:10d} B  K1+K2 "
              f"{t['path K1+K2'][0]:.4f} | {fmt_ms(t['path K1+K2'][1])}  K3 "
              f"{t['csr_spmv_fused'][0]:.4f} | {fmt_ms(t['csr_spmv_fused'][1])}")

    # 6. results
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": tc[k][0],
                "plain_ms": tc[f"{k}_plain"][0], "device_ms": tc[k][1],
                "plain_device_ms": tc[f"{k}_plain"][1],
                "at": "synthetic_cant n=62451"} for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

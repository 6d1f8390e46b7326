"""Run one cell of ``BENCHMARK.json`` once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the cell's matrix from the seed, converts it with the
port's ``from_coo``, warms up the cell's jobs, then runs them back to back
for ``--seconds`` (the window). After the window it judges a sample of the
answers against the plain float64 reference (``benchmark/check.py``).
With ``--trace 1`` it also profiles ``TRACE_SECONDS`` of jobs and times
the container's ``matvec`` alone, and reports the cell's per-layer metrics in
place of its end-to-end ones. The configuration's ``dtype`` picks the
container (``benchmark/session.py``) and the type of that ``matvec``'s x.

Notes go to standard error, ending with each compared number beside its
limit. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``card`` and last ``checks``. The run exits 2, with no
result, where the card or cards the cell asks for are missing, and 3 where
the process has loaded ``jax``, ``jaxlib``, ``flax`` or the JAX package
``spmv_tpu`` (whole top-level module names).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

__all__ = ["main", "run_cell", "matvec_x", "forbidden_modules", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "spmv_tpu")
TRACE_SECONDS = 1.0  # the profiled stretch of jobs in a traced run


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _note(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line(query: str = "name,power.limit") -> str:
    """The card's name and power limit (or another ``--query-gpu``) as
    ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


_CLOCKS = "clocks.sm,clocks.mem,temperature.gpu,power.draw"


class Context:
    """What the metric readers read (``benchmark/metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.setup_s = None
        self.spans = {}
        self.window = None
        self.matrix = None
        self.matvec_s = None  # the container's matvec alone, CUDA-graph timed
        self.stretch = None  # the profiled stretch (benchmark.trace.Stretch)
        self.__dict__.update(kw)


def _launches() -> dict:
    from spmv_tpu_torch.kernels.engines import LAUNCHES

    return dict(LAUNCHES)


def _delta(before: dict, after: dict) -> int:
    return sum(after[k] - before.get(k, 0) for k in after)


def matvec_x(session, device):
    """A standard normal x for the container's ``matvec`` alone, in the
    configuration's dtype, so that an ``X2Matrix``'s call casts nothing."""
    import torch

    return torch.randn(session.matrix.ncols, device=device,
                       dtype=getattr(torch, session.matrix.dtype))


def _stretch(session, seconds: float):
    """Profile ``seconds`` of jobs; the stretch's readings and its check of
    the recorded kernels against the launch counters and the replays."""
    import torch

    from benchmark.jobs import run_window
    from benchmark.trace import Stretch, profiled

    solver = session.jobs.name  # the key of the container's graph loop
    x = matvec_x(session, "cuda")
    before = _launches()
    session.a.matvec(x)
    torch.cuda.synchronize()
    per_matvec = _delta(before, _launches())
    replays = []

    def on_job(_out):
        loop = getattr(session.a, "_graph_loops", {}).get(solver)
        replays.append((getattr(loop, "replays", None), getattr(loop, "chunk", None)))

    stretch = Stretch()
    keys = list(_launches())
    with profiled(stretch, keys):
        before = _launches()
        w = run_window(session.jobs, session.seeds, seconds, 0,
                       session.streams["sample"], on_job=on_job)
        eager = _delta(before, _launches())
    stretch.jobs = len(w.times)
    if replays and all(r is not None and c is not None for r, c in replays):
        stretch.kernels_expected = eager + sum(r * c for r, c in replays) * per_matvec
    return stretch


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root=None, device="cuda", chips: int = 1, t0: float | None = None,
             note=_note) -> dict:
    """One run of ``workload``: the result object the run prints last."""
    import statistics

    import torch

    from benchmark import check, spec
    from benchmark.jobs import run_window
    from benchmark.roofline import graph_seconds
    from benchmark.session import open_session

    t0 = _T0 if t0 is None else t0
    cell = spec.load_cell(workload, spec.ROOT if root is None else root)
    cuda = torch.device(device).type == "cuda"
    spans = {"imports": time.perf_counter() - t0}
    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
    spans["card"] = time.perf_counter() - t
    session = open_session(cell, seed, device)
    spans.update(session.spans)
    ctx = Context(matrix=session.matrix, spans=spans)
    ctx.setup_s = time.perf_counter() - t0
    note(f"[{workload} seed {seed}] set-up {ctx.setup_s:.3f} s: "
         + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
         + f"; {session.matrix.nrows} rows, {session.matrix.nnz} nonzeros")

    sample = int(cell.traffic["sample"])
    clocks = card_line(_CLOCKS) if cuda else None
    ctx.window = w = run_window(session.jobs, session.seeds, seconds, sample,
                                session.streams["sample"])
    if cuda:
        note(f"[card] {_CLOCKS}: before the window {clocks}; after {card_line(_CLOCKS)}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    note(f"[window] {w.seconds:.3f} s, {w.attempted} jobs, {w.failed} failed, "
         f"{sum(w.iters)} iterations, {w.spmvs} SpMVs; job ms median "
         f"{statistics.median(w.times) * 1e3 if w.times else float('nan'):.4f}; "
         f"device memory peak {peak} B")
    if w.iters and len(set(w.iters)) > 1:
        hist = {k: w.iters.count(k) for k in sorted(set(w.iters))}
        note(f"[window] iterations: {hist}; longest job {max(w.times) * 1e3:.4f} ms")
    for err in w.errors[:5]:
        note(f"[window] job error: {err}")

    metrics = cell.per_layer if trace else cell.end_to_end
    stretch = None
    if trace:
        ctx.stretch = stretch = _stretch(session, TRACE_SECONDS)
        note(f"[trace] stretch: {stretch.window_s:.6f} s, busy {stretch.busy_s:.6f} s, "
             f"{stretch.jobs} jobs; the port's kernels recorded {stretch.kernels_recorded}, "
             f"expected {stretch.kernels_expected} ("
             f"{'every one recorded' if stretch.complete else 'NOT every one recorded'})")
        note(f"[trace] events recorded: {stretch.kinds}")
        x = matvec_x(session, device)
        ctx.matvec_s = graph_seconds(lambda: session.a.matvec(x))
        note(f"[trace] matvec alone {ctx.matvec_s * 1e6:.3f} us (CUDA graph of 20 calls)")

    values = {}
    for m in metrics:
        v = spec.metric_reader(cell.root, m["name"])(ctx)
        if v is None:
            note(f"[metrics] {m['name']}: nothing to read")
        else:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    session.close()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    t = time.perf_counter()
    numbers = check.numbers(session.matrix, w.kept, session.jobs.kind, cell.traffic, device)
    correct, checks = check.judge(numbers, w.failed, cell.limits)
    note(f"[check] {len(w.kept)} answers against the float64 reference in "
         f"{time.perf_counter() - t:.3f} s")

    result = {"correct": correct, "attempted": w.attempted, "failed": w.failed,
              "metrics": values}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
    result["device"] = dev
    if stretch is not None:
        result["breakdown"] = {"device_ops": stretch.device_ops,
                               "idle_gaps": stretch.idle_gaps}
    result["card"] = card_line() if cuda else None
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    chips = int(spec.load_cell(args.workload).workload["chips"])
    if not torch.cuda.is_available():
        _note("no CUDA device (torch.cuda.is_available() is False): no result")
        return 2
    if torch.cuda.device_count() < chips:
        _note(f"{args.workload} needs {chips} cards, found {torch.cuda.device_count()}: no result")
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          chips=chips)
    except ForbiddenModules as e:
        _note(f"forbidden modules loaded: {', '.join(e.args[0])}: no result")
        return 3
    found = forbidden_modules()
    if found:
        _note(f"forbidden modules loaded: {', '.join(found)}: no result")
        return 3
    for name, c in result["checks"].items():
        _note(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILS'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

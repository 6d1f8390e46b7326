"""The port's span recorder (``spmv_tpu_torch.trace``): what it records
and when, the counts the solves give their spans, and its clock against
the profiler's.

The graph loop's spans are held on the CPU with ``CpuLoop``
(``_torch_loops.py``) and, in the ``gpu`` test, on the card's CUDA graph:

    python -m pytest -m gpu --noconftest tests/test_torch_trace.py
"""

import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spmv_tpu_torch
from spmv_tpu_torch import solve, trace
from spmv_tpu_torch.kernels import probes
from spmv_tpu_torch.kernels.engines import LAUNCHES

from _torch_loops import cpu_graph  # noqa: F401  (the fixture, with CpuLoop)

FORMATS = ["csr", "coo", "cmrs", "ell", "sell", "hyb", "sym"]


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def laplacian(m=10, shift=0.05):
    """The 5-point Laplacian on an m×m grid plus shift·I: SPD, so cg takes
    tens of iterations."""
    n = m * m
    A = np.zeros((n, n))
    for i in range(m):
        for j in range(m):
            k = i * m + j
            A[k, k] = 4 + shift
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                if 0 <= i + di < m and 0 <= j + dj < m:
                    A[k, (i + di) * m + j + dj] = -1
    rr, cc = np.nonzero(A)
    return n, rr, cc, A[rr, cc]


def matrix(fmt="csr", device="cpu", m=10):
    n, r, c, v = laplacian(m)
    if fmt == "sym":  # the stored lower triangle
        keep = r >= c
        r, c, v = r[keep], c[keep], v[keep]
    return spmv_tpu_torch.from_coo(fmt, n, n, r, c, v, device=device)


def rhs(n, seed=6):
    return np.random.default_rng(seed).standard_normal(n)


def named(name):
    return [s for s in trace.spans() if s.name == name]


def root(name):
    roots = named(name)
    assert len(roots) == 1
    return roots[0]


def children(r):
    return [s for s in trace.spans() if s.request == r.request and s is not r]


def test_nothing_is_recorded_unless_armed():
    a = matrix()
    solve.cg(a, rhs(a.nrows))
    solve.power_iteration(a, iters=5)
    a.matvec(np.ones(a.ncols))
    assert not trace.armed() and trace.spans() == [] and trace.dropped() == 0


def test_cg_under_the_profiler():
    a = matrix()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.armed()
        x, k, res = solve.cg(a, rhs(a.nrows), tol=1e-6)
    assert not trace.armed()
    r = root("solve.cg")
    assert r.parent is None
    assert r.counts == {"mode": "eager", "replays": 0, "host_reads": k + 1,
                        "spmvs": k + 1, "iterations": k, "rhs": 1}
    kids = children(r)
    assert kids and all(s.parent == r.id for s in kids)
    reads = [s for s in kids if s.name == "solve.read"]
    assert len(reads) == r.counts["host_reads"] + 2  # and int(k), float(res)
    wrappers = [s for s in kids if s.name == "spmv.wrapper"]
    assert len(wrappers) == k + 1 and all(s.counts == {"launches": 0, "x_gathers": 0}
                                          for s in wrappers)
    assert all(r.start_ns <= s.start_ns <= s.end_ns <= r.end_ns for s in kids)


def test_bicgstab_counts_two_spmvs_a_body():
    a = matrix()
    trace.enable()
    _, k, _ = solve.bicgstab(a, rhs(a.nrows), tol=1e-6)
    r = root("solve.bicgstab")
    assert (r.counts["iterations"], r.counts["spmvs"]) == (k, 2 * k + 1)
    assert len(named("spmv.wrapper")) == 2 * k + 1


@pytest.mark.parametrize("iters", [0, 1, 13])
def test_power_iteration_counts(iters):
    a = matrix()
    trace.enable()
    solve.power_iteration(a, iters=iters)
    r = root("solve.power_iteration")
    assert r.counts == {"mode": "eager", "replays": 0, "host_reads": 0,
                        "spmvs": iters + 1, "iterations": iters}
    assert [s.name for s in children(r)].count("solve.read") == 1  # the eigenvalue


def test_enable_and_disable_arm_without_a_profiler():
    trace.enable()
    assert trace.armed()
    a = matrix()
    trace.disable()
    assert not trace.armed()
    a.matvec(np.ones(a.ncols))
    f = root("plan.from_coo")
    assert f.counts == {"nnz": 460, "bytes": a.stream_bytes}
    kids = children(f)
    assert sorted(s.name for s in kids) == ["plan.host", "plan.upload"]
    assert all(s.parent == f.id for s in kids)
    assert {s.name for s in trace.spans()} == {"plan.from_coo", "plan.host", "plan.upload"}


def test_each_call_is_a_request_of_its_own():
    a = matrix()
    trace.enable()
    solve.cg(a, rhs(a.nrows))
    solve.cg(a, rhs(a.nrows, seed=2))
    a.matvec(np.ones(a.ncols))
    roots = [s for s in trace.spans() if s.parent is None]
    assert [s.name for s in roots] == ["solve.cg", "solve.cg", "spmv.wrapper"]
    assert len({s.request for s in roots}) == 3
    assert len({s.id for s in trace.spans()}) == len(trace.spans())


@pytest.mark.parametrize("fmt", FORMATS)
def test_one_wrapper_span_a_pass(fmt):
    """A container's matvec is one wrapper span a plan pass (sym's two
    passes two), never one inside another; launches 0 on the CPU, and no
    x gather on a plan that is not relabelled."""
    a = matrix(fmt)
    trace.enable()
    a.matvec(np.ones(a.ncols))
    wrappers = named("spmv.wrapper")
    assert len(wrappers) == (2 if fmt == "sym" else 1)
    assert all(s.parent is None and s.counts == {"launches": 0, "x_gathers": 0}
               for s in wrappers)


def test_the_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(trace, "_REC", trace.Recorder(bound=4))
    trace.enable()
    for i in range(7):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == ["s3", "s4", "s5", "s6"]
    assert trace.dropped() == 3
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_a_span_is_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.warm"):  # the first range of a process costs more
            pass
        with trace.span("test.sleep") as s:
            time.sleep(0.02)
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.sleep"]
    assert len(ev) == 1
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert abs(s.start_ns - start) < 2e6 and abs(s.end_ns - end) < 2e6
    assert s.end_ns - s.start_ns >= 20e6


NAMES = {"plan.from_coo", "plan.host", "plan.upload", "solve.cg", "solve.bicgstab",
         "solve.power_iteration", "solve.capture", "solve.replay", "solve.read",
         "spmv.wrapper"}


def test_no_span_name_holds_a_launch_counter(cpu_graph):
    trace.enable()
    a = matrix("hyb")
    for _ in range(3):  # eager, capture, replay
        solve.cg(a, rhs(a.nrows))
        solve.bicgstab(a, rhs(a.nrows))
        solve.power_iteration(a, iters=3)
    assert {s.name for s in trace.spans()} == NAMES
    assert set(probes.LAUNCH_KEYS) < set(LAUNCHES)
    assert not [(n, k) for n in NAMES for k in LAUNCHES if k in n]


def run(a, which, b):
    if which == "power_iteration":
        return solve.power_iteration(a, iters=37)
    return getattr(solve, which)(a, b, tol=1e-6)


def check_graph_solve(a, which, b, mode):
    """One solve of ``which`` on the graph loop (``mode``: it captures or
    replays it), and the counts of its spans."""
    trace.clear()
    trace.enable()
    run(a, which, b)
    trace.disable()
    r = root(f"solve.{which}")
    loop = a._graph_loops[which]
    body = 2 if which == "bicgstab" else 1
    assert r.counts["mode"] == mode
    assert (r.counts["replays"], r.counts["host_reads"]) == (loop.replays, loop.host_reads)
    assert r.counts["spmvs"] == 1 + body * loop.replays * loop.chunk
    replays = [s for s in children(r) if s.name == "solve.replay"]
    assert len(replays) == loop.replays and all(s.parent == r.id for s in replays)
    reads = [s for s in children(r) if s.name == "solve.read"]
    captures = [s for s in children(r) if s.name == "solve.capture"]
    assert [s.counts for s in captures] == ([{"bodies": loop.chunk}] if mode == "capture" else [])
    if which == "power_iteration":
        assert r.counts["iterations"] == 37 and loop.replays == math.ceil(37 / loop.chunk)
        assert r.counts["spmvs"] == loop.chunk * math.ceil(37 / loop.chunk) + 1
        assert all(s.counts == {"after_read": 0} for s in replays)
        assert len(reads) == 1  # the eigenvalue
    else:
        assert loop.replays == math.ceil(r.counts["iterations"] / loop.chunk)
        assert all(s.counts == {"after_read": 1} for s in replays)
        assert len(reads) == loop.host_reads + 2  # and int(k), float(res)


@pytest.mark.parametrize("which", ["cg", "bicgstab", "power_iteration"])
def test_graph_loop_spans_on_the_cpu(cpu_graph, which):
    a = matrix()
    b = rhs(a.nrows)
    run(a, which, b)  # the first solve: eager
    for mode in ("capture", "replay", "replay"):
        check_graph_solve(a, which, b, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["cg", "bicgstab", "power_iteration"])
def test_graph_loop_spans_on_the_card(which):
    """The same counts on the card's CUDA graph loop, whose replays run no
    Python; the eager solve's wrapper spans count their launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = matrix(device="cuda", m=40)
    b = rhs(a.nrows)
    trace.enable()
    run(a, which, b)  # the first solve: eager
    assert root(f"solve.{which}").counts["mode"] == "eager"
    assert all(s.counts["launches"] > 0 for s in named("spmv.wrapper"))
    for mode in ("capture", "replay"):
        check_graph_solve(a, which, b, mode)

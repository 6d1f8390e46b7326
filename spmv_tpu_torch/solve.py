"""Krylov solvers over the port's float32 containers: ``cg``, ``bicgstab``
and ``power_iteration``, with the arguments, messages, return values and
numerics of ``spmv_tpu/solve.py`` (float32 state, the stop
``rs > tol²·max(‖b‖², 1e-30)`` or ``k = maxiter``, BiCGSTAB's eps of
1e-30, power iteration's ``rsqrt(w·w + 1e-30)``). Each SpMV is the
container's ``matvec`` (``matmat`` for cg on a block of R columns, 2 ≤ R ≤
``MULTI_RHS_MAX``, one recurrence and stop per column). cg's body after
its SpMV is ``kernels.cg_body.Body``: its kernels on an engine container
on the card, else its PyTorch version; the other solvers' dots and
updates are PyTorch calls.

One loop runs every solver (``_run``). Its body, ``body(*state,
*consts)``, updates the state in place and masks it itself, so a state
whose condition has failed keeps its bits (cg's ``Body`` per column;
``_masking`` wraps the other steps in ``torch.where``). It runs while
``going(*state, *consts)``, or a fixed count of times: eagerly, on copies
of the state, the host reading ``going`` before each body (the CPU, the
sharded containers, the private ``_graph=False``), or on a CUDA container
as a CUDA graph of ``GRAPH_CHUNK`` bodies that ends by writing ``going``
to a flag, one host read per replay (none for a fixed count). A
container's first solve of a kind runs eagerly and leaves its state's
shape under its key in ``a._graph_loops``, since a capture costs more than
a one-shot solve saves; the next of that shape captures the graph and
keeps it there; later ones load their state and constants (tol², maxiter
and the count among them) into it and replay. The graph gives the eager
loop's bits; a capture that fails raises. Where the recorder is armed at
its start, a solve is a span of ``trace`` with its capture, replays and
host reads inside.
"""

from __future__ import annotations

import contextlib
import gc
import math

import numpy as np
import torch

from spmv_tpu_torch import trace
from spmv_tpu_torch.dist.sharded import ColShardedSpmv, RowShardedSpmv, Sharded
from spmv_tpu_torch.kernels import cg_body
from spmv_tpu_torch.kernels.engines import MULTI_RHS_MAX

__all__ = ["cg", "bicgstab", "power_iteration", "GRAPH_CHUNK"]

# Body copies per CUDA graph, from chip_smoke.py phase 7's sweep of C = 1,
# 4, 8, 16, 32 for cg at cant (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): a
# csr solve that reuses its loop took 1.61 ms at C = 8 (1.62-1.64 at 4 and
# 16, 1.85 at 1; 15 iterations, eager 4.20), sym 2.13 (2.20-2.38), and at
# 83 iterations 6.34 (6.38 at 4, 7.14-7.59 at the others; eager 26.86),
# while the capture grows with C. C = 8 replays at most 7 frozen bodies of
# about 60 µs.
GRAPH_CHUNK = 8

_EPS = 1e-30


def _operator(a):
    """``(matvec, device, graphable)`` of a float32 engine container or a
    float32 Row/Col sharded one; ``TypeError`` (``NotImplementedError`` for
    the sharded fp64-grade and BSR forms) for anything else. ``graphable``:
    the loop may run as a CUDA graph (an engine container on the card; a
    sharded one never: its ``matvec`` holds collectives, which a gloo group
    cannot run inside a graph and which would tie a captured NCCL call to
    one communicator)."""
    kind = type(a).__name__
    if isinstance(a, Sharded):
        if not isinstance(a, (RowShardedSpmv, ColShardedSpmv)):
            raise TypeError(
                f"solve requires a jit-composable container (padded_matvec or "
                f"_matvec_traced); {kind} has neither — use "
                f"csr/coo/cmrs/ell/sell/hyb")
        if a.x2 or getattr(a, "_bsr", False):
            raise NotImplementedError(
                "traced composition covers the f32 plan-based shardings")
        return a.matvec, a.device, False
    if getattr(a, "x2", False):
        raise TypeError(
            "solve takes the float32 containers; X2Matrix computes in "
            "float64, which these float32 loops would drop (the JAX "
            "solvers feed it a float32 table it reads as double-single, and "
            "return a wrong x)")
    if kind == "BSRMatrix" or not hasattr(a, "matvec") or not hasattr(a, "dev"):
        raise TypeError(
            f"solve requires an engine container with matvec; {kind} is not "
            f"one — use csr/coo/cmrs/ell/sell/hyb/sym")
    device = a.dev.device
    return a.matvec, device, device.type == "cuda"


def _operand(v, n: int, R: int | None, device, what: str) -> torch.Tensor:
    """``v`` in float32 on ``device``: a vector of n entries where R is
    None (an (n, 1) one is flattened), else a block of shape (n, R)."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.float32))
    t = v.to(device=device, dtype=torch.float32)
    if R is None:
        t = t.reshape(-1)
        if t.numel() != n:
            raise ValueError(f"{what} has {t.numel()} entries, matrix is {n}")
    elif tuple(t.shape) != (n, R):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, the block is ({n}, {R})")
    return t.contiguous()


def _columns(v) -> int | None:
    """R where ``v`` is a block of right-hand sides, of shape (n, R) with R
    other than 1; None for a vector (an (n, 1) one is flattened)."""
    shape = tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)
    return shape[1] if len(shape) == 2 and shape[1] != 1 else None


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u·v: ``torch.dot`` for vectors, a column sum per column of a block."""
    return torch.dot(u, v) if u.dim() == 1 else (u * v).sum(0)


def _tol2(b: torch.Tensor, tol: float) -> torch.Tensor:
    """``tol²·max(b·b, 1e-30)`` in float32, on the device; per column for
    a block b."""
    return float(np.float32(tol) ** 2) * torch.clamp(_dot(b, b), min=_EPS)


class _Untraced:
    """A solve the recorder does not see: ``_Traced``'s calls, each doing
    only the work it is handed."""

    def host(self, cast, t: torch.Tensor):
        return cast(t)

    def replay(self, launch) -> None:
        launch()

    def capture(self):
        return contextlib.nullcontext()

    def loop(self, *counts, **named) -> None:
        pass

    finish = loop


class _Traced:
    """A traced solve: its root span, the SpMVs one loop body makes, and
    whether the host has read a value of the solve since its last graph
    launch (the loops issue nothing else between a read and a replay)."""

    def __init__(self, root: trace.Span, body_spmvs: int):
        self.root, self.body_spmvs, self.read = root, body_spmvs, False

    def host(self, cast, t: torch.Tensor):
        """``cast(t)``, a host read of a device value, as a span."""
        with trace.span("solve.read"):
            v = cast(t)
        self.read = True
        return v

    def replay(self, launch) -> None:
        with trace.span("solve.replay", after_read=int(self.read)):
            launch()
        self.read = False

    def capture(self):
        return trace.span("solve.capture", bodies=GRAPH_CHUNK)

    def loop(self, mode: str, replays: int, host_reads: int, bodies: int) -> None:
        self.root.counts.update(mode=mode, replays=replays, host_reads=host_reads,
                                spmvs=bodies * self.body_spmvs)

    def finish(self, iterations: int, outside: int, **counts) -> None:
        """The solve's counts once it has run: ``outside``, its SpMVs
        outside the loop (cg's r0, power iteration's Rayleigh quotient);
        ``counts``, further counts of the solve's own."""
        self.root.counts["iterations"] = iterations
        self.root.counts["spmvs"] += outside
        self.root.counts.update(counts)


_UNTRACED = _Untraced()


@contextlib.contextmanager
def _solve(name: str, body_spmvs: int):
    """The solve's ``_Traced``, inside its root span ``name``, where the
    recorder is armed at its start; else ``_UNTRACED``."""
    if not trace.armed():
        yield _UNTRACED
        return
    with trace.span(name) as root:
        yield _Traced(root, body_spmvs)


def _masking(step, active):
    """The loop body of a functional ``step(*state, *consts)``, which
    returns the new state: each state tensor rewritten in place through
    ``torch.where`` on ``active`` of the entry state, so an inactive state
    keeps its bits and nothing is read on the host."""
    def body(*args):
        on = active(*args)
        for s, new in zip(args, step(*args)):
            torch.where(on, new, s, out=s)
    return body


def _run(a, solver: str, body, going, state: tuple, consts: tuple, graph: bool,
         tr, count: int | None = None) -> tuple:
    """Run ``body(*state, *consts)``, which updates the state in place and
    masks it, while ``going(*state, *consts)``, or ``count`` times for a
    loop of a fixed count; returns the final state. Eagerly (the host reads
    ``going`` before each body), or with ``graph`` on the container's CUDA
    graph loop for ``solver``: a solve whose state's shape is the one a
    first solve left under the key captures the loop and keeps it on the
    container (``a._graph_loops``), and every later one of that shape loads
    its own state and constants into the loop's tensors and replays it.
    ``tr``, the solve's ``_Traced`` or ``_UNTRACED``, gets the loop's spans
    and counts."""
    loops = a.__dict__.setdefault("_graph_loops", {}) if graph else {}
    held, shape = loops.get(solver), state[0].shape
    if count == 0 or getattr(held, "shape", held) != shape:  # a loop or a mark
        if graph:  # seen once: the next solve of this shape captures
            loops[solver] = shape
        state = tuple(t.clone() for t in state)
        if count is not None:
            for _ in range(count):
                body(*state, *consts)
            steps, reads = count, 0
        else:
            steps = 0
            while tr.host(bool, going(*state, *consts)):
                body(*state, *consts)
                steps += 1
            reads = steps + 1
        tr.loop("eager", 0, reads, steps)
        return state
    if isinstance(held, torch.Size):
        with tr.capture():
            loop = loops[solver] = _GraphLoop(body, going, state, consts)
        mode = "capture"
    else:
        loop, mode = held, "replay"
        loop.load(state, consts)
    state = loop.run(tr, count)
    tr.loop(mode, loop.replays, loop.host_reads, loop.replays * loop.chunk)
    return state


class _GraphLoop:
    """``GRAPH_CHUNK`` copies of a loop body over static state and constant
    tensors of ``shape``, captured as one CUDA graph whose replay ends by
    writing ``going`` to ``flag``. ``replays`` and ``host_reads`` say what
    its last run did."""

    def __init__(self, body, going, state: tuple, consts: tuple):
        self.body, self.going, self.chunk = body, going, GRAPH_CHUNK
        self.shape = state[0].shape
        self.state = tuple(t.clone() for t in state)
        self.consts = tuple(t.clone() for t in consts)
        self.replays = self.host_reads = 0
        self._capture()

    def load(self, state: tuple, consts: tuple) -> None:
        for mine, new in zip(self.state + self.consts, state + consts):
            mine.copy_(new)

    def _chunk(self) -> torch.Tensor:
        for _ in range(self.chunk):
            self.body(*self.state, *self.consts)
        return self.going(*self.state, *self.consts)

    def _capture(self) -> None:
        dev = self.state[0].device
        scratch = tuple(t.clone() for t in self.state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.body(*scratch, *self.consts)  # a warm-up body
            # not ``torch.cuda.graph``, which also synchronizes and empties
            # the caching allocator first: in a process that holds many
            # blocks that costs more than the capture itself. No garbage
            # collection inside the capture: a container and its loops form
            # a reference cycle, and freeing another loop's graph there
            # destroys an executable graph, which invalidates the capture.
            collecting = gc.isenabled()
            gc.disable()
            self.graph.capture_begin()
            try:
                self.flag = self._chunk()
            finally:
                self.graph.capture_end()
                if collecting:
                    gc.enable()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.replay = self.graph.replay

    def run(self, tr, count: int | None = None) -> tuple:
        """Replay until the flag reads false (one host read before the
        first replay and one after each), or, for a loop of a fixed
        ``count``, ``ceil(count / chunk)`` times with no host read; each
        replay and host read through ``tr``."""
        if count is None:
            self.replays, self.host_reads = 0, 1
            going = tr.host(bool, self.going(*self.state, *self.consts))
            while going:
                tr.replay(self.replay)
                self.replays += 1
                self.host_reads += 1
                going = tr.host(bool, self.flag)
        else:
            self.replays, self.host_reads = math.ceil(count / self.chunk), 0
            for _ in range(self.replays):
                tr.replay(self.replay)
        return self.state


def _uses_graph(graphable: bool, graph: bool) -> bool:
    return graph and graphable


def _count(n: int, device) -> torch.Tensor:
    """An iteration bound as a device constant, so one captured loop
    serves every ``maxiter`` (every ``iters``)."""
    return torch.tensor(n, dtype=torch.int64, device=device)


def cg(a, b, *, tol: float = 1e-5, maxiter: int = 1000, x0=None,
       _graph: bool = True):
    """Conjugate gradients for SPD ``A``: returns (x, iterations, residual),
    x a float32 tensor on the container's device. fp32 state (use a
    smallish ``tol`` accordingly).

    For b of shape (n, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``, on an engine
    container: R recurrences, one per column, through one ``matmat`` an
    iteration; returns (X, ks, residuals), X of shape (n, R), ks and
    residuals lists of R ints and floats. ``x0`` is then (n, R) too."""
    return _cg(a, b, tol, maxiter, x0, _graph, kernels=True)


def _cg_active(x, r, p, rs, k, tol2, kmax):
    """cg's condition on its state: a flag, or a mask per column."""
    return (rs > tol2) & (k < kmax)


def _cg_going(*state):
    return _cg_active(*state).any()


def _cg(a, b, tol: float, maxiter: int, x0, graph: bool, kernels: bool):
    """``cg``, whose body runs ``cg_body``'s kernels where ``kernels`` and
    the container allows (``graphable``), else its PyTorch version:
    ``kernels=False`` gives, on the card, a single container's cg with the
    body the sharded containers run (``chip_smoke.py`` phase 9 holds them
    to it)."""
    if a.nrows != a.ncols:
        raise ValueError("cg requires a square matrix")
    mv, device, graphable = _operator(a)
    R = _columns(b)
    if R is not None:
        if isinstance(a, Sharded) or not hasattr(a, "matmat"):
            raise TypeError(
                f"cg on a block of right-hand sides needs an engine container with "
                f"matmat (csr/coo/cmrs/ell/sell/hyb/sym); {type(a).__name__} solves "
                f"one vector at a time")
        if not 2 <= R <= MULTI_RHS_MAX:
            raise ValueError(f"cg takes a block of 2 to MULTI_RHS_MAX = {MULTI_RHS_MAX} "
                             f"right-hand sides, got {R}")
        mv = a.matmat
    with _solve("solve.cg", 1) as tr:
        b = _operand(b, a.nrows, R, device, "b")
        x0 = torch.zeros_like(b) if x0 is None else _operand(x0, a.nrows, R, device, "x0")
        r0 = b - mv(x0)
        state = (x0, r0, r0, _dot(r0, r0),
                 torch.zeros(b.shape[1:], dtype=torch.int32, device=device))
        body = cg_body.Body(b.shape, device, kernels=kernels and graphable)

        def step(x, r, p, rs, k, tol2, kmax):
            body(x, r, p, mv(p), rs, k, tol2, kmax)

        x, _, _, rs, k = _run(a, "cg" if R is None else "cg_rhs", step,
                              _cg_active if R is None else _cg_going, state,
                              (_tol2(b, tol), _count(maxiter, device)),
                              _uses_graph(graphable, graph), tr)
        k, res = tr.host(torch.Tensor.tolist, k), tr.host(torch.Tensor.tolist, torch.sqrt(rs))
        if R is None:
            tr.finish(k, outside=1, rhs=1)  # r0
        else:  # the loop ran to the slowest column; r0
            tr.finish(max(k), outside=1, rhs=R, column_iterations=sum(k))
    return x.clone(), k, res


def bicgstab(a, b, *, tol: float = 1e-5, maxiter: int = 1000, x0=None,
             _graph: bool = True):
    """BiCGSTAB for general (nonsymmetric) square ``A``: returns
    (x, iterations, residual). Two SpMVs per iteration (van der Vorst's
    smoothing step)."""
    if a.nrows != a.ncols:
        raise ValueError("bicgstab requires a square matrix")
    if _columns(b) is not None:
        raise ValueError(f"bicgstab solves one right-hand side; b has shape "
                         f"{tuple(np.shape(b))} (cg takes a block)")
    mv, device, graphable = _operator(a)
    with _solve("solve.bicgstab", 2) as tr:
        b = _operand(b, a.nrows, None, device, "b")
        x0 = torch.zeros_like(b) if x0 is None else _operand(x0, a.nrows, None, device, "x0")
        r0 = b - mv(x0)

        def active(x, r, p, rho, rs, k, rhat, tol2, kmax):
            return (rs > tol2) & (k < kmax)

        def step(x, r, p, rho, rs, k, rhat, tol2, kmax):  # rhat: the fixed shadow residual
            v = mv(p)
            alpha = rho / (torch.dot(rhat, v) + _EPS)
            h = x + alpha * p
            s = r - alpha * v
            t = mv(s)
            omega = torch.dot(t, s) / (torch.dot(t, t) + _EPS)
            x = h + omega * s
            r = s - omega * t
            rho_new = torch.dot(rhat, r)
            beta = (rho_new / (rho + _EPS)) * (alpha / (omega + _EPS))
            p = r + beta * (p - omega * v)
            return x, r, p, rho_new, torch.dot(r, r), k + 1

        rs0 = torch.dot(r0, r0)
        state = (x0, r0, r0, rs0, rs0, torch.zeros((), dtype=torch.int32, device=device))
        x, _, _, _, rs, k = _run(a, "bicgstab", _masking(step, active), active, state,
                                 (r0, _tol2(b, tol), _count(maxiter, device)),
                                 _uses_graph(graphable, _graph), tr)
        k, res = tr.host(int, k), tr.host(float, torch.sqrt(rs))
        tr.finish(k, outside=1)  # r0
    return x.clone(), k, res


def power_iteration(a, *, iters: int = 100, seed: int = 0, _graph: bool = True):
    """Dominant eigenvalue estimate by power iteration; returns
    (eigenvalue, eigenvector). v0 is standard normal from
    ``torch.Generator(device).manual_seed(seed)``: the JAX package's
    ``jax.random`` bits cannot be reproduced, so the two agree on the
    eigenvalue, not on the vector. On the card the graph loop replays
    ``ceil(iters / GRAPH_CHUNK)`` times with no host read."""
    if a.nrows != a.ncols:
        raise ValueError("power_iteration requires a square matrix")
    mv, device, graphable = _operator(a)
    with _solve("solve.power_iteration", 1) as tr:
        gen = torch.Generator(device).manual_seed(seed)
        v0 = torch.randn(a.ncols, generator=gen, device=device, dtype=torch.float32)

        def active(v, k, kmax):
            return k < kmax

        def step(v, k, kmax):
            w = mv(v)
            return w * torch.rsqrt(torch.dot(w, w) + _EPS), k + 1

        state = (v0, torch.zeros((), dtype=torch.int32, device=device))
        v = _run(a, "power_iteration", _masking(step, active), active, state,
                 (_count(iters, device),), _uses_graph(graphable, _graph), tr,
                 count=iters)[0].clone()
        lam = tr.host(float, torch.dot(v, mv(v)))
        tr.finish(iters, outside=1)  # the Rayleigh quotient
    return lam, v

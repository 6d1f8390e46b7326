"""Krylov solvers over the port's float32 containers: ``cg``, ``bicgstab``
and ``power_iteration``.

Counterpart of ``spmv_tpu/solve.py``, with its arguments, messages, return
values and numerics: float32 state, the stopping rule
``rs > tol²·max(‖b‖², 1e-30)`` and ``k < maxiter``, BiCGSTAB's eps of
1e-30 and fixed shadow residual, power iteration's
``rsqrt(w·w + 1e-30)`` normalisation. Every SpMV is the container's
``matvec`` (csr, coo, cmrs, ell, sell, hyb, sym), so the loop runs the
format's kernels; the dot products and vector updates are PyTorch calls
(``torch.dot``, elementwise tensor arithmetic), as ``jnp.vdot`` lies
outside every Pallas kernel. cg's body after its SpMV is
``kernels.cg_body.Body``, which updates the state in place and masks each
column itself, for one vector and for a block alike, in the eager loop
and the graph loop: on an engine container on the card three kernels of
the port's own (p·Ap, then x, r and r·r, then p), elsewhere (the CPU, the
sharded containers) the same arithmetic as PyTorch calls. The kernels
give x, r and p the PyTorch body's bits for the same alpha and beta;
their dots sum in an order of their own, fixed, so graph and eager agree
bit for bit.

JAX runs each loop as one device program (``lax.while_loop``). The port's
counterpart, on a CUDA container, is a CUDA graph of ``GRAPH_CHUNK``
copies of the iteration body, replayed: each copy computes ``active``
(the loop's condition) on the device and updates the state through
``torch.where`` on it (cg's body computes it and masks its own
writes), so once the loop's condition fails the state stays frozen bit
for bit, and the host reads one flag per replay. A
container's first solve of a kind (cg, bicgstab, power_iteration) runs
the eager loop, since a capture costs more than a one-shot solve saves;
the second captures the graph and keeps it on the container
(``a._graph_loops``, one per solver: tol², maxiter and the iteration
count are device constants), and every later solve copies its own
b-derived state and constants into the graph's tensors and replays. The
iteration count and x are the eager loop's bits. A capture that fails
raises; nothing falls back to the eager loop.

The eager loop (the body run call by call, the condition read by the
host before each iteration) is the plain version: the CPU runs it, and
the private ``_graph=False`` selects it on the card for the checks that
hold the graph to it.

Refused, with ``TypeError``: BSR (as JAX's ``_operator`` refuses it) and
``X2Matrix``. JAX's solvers hand an ``X2Matrix`` a float32 x table that
its ``padded_matvec`` reads as a double-single one, and return a wrong x
without an error; the port's ``X2Matrix`` computes in float64, which
these float32 loops would drop.

Each public solve is a span of ``trace`` where the recorder is armed
(``solve.cg``, ``solve.bicgstab``, ``solve.power_iteration``), with its
graph capture, replays and host reads as spans inside it, and its
iterations, SpMVs, replays, host reads and mode as counts (``solve.cg``
also ``fused_bodies``, the bodies ``cg_body``'s kernels ran, 0 where
its PyTorch version ran). A solve
decides once, at its start, whether it is traced; an untraced one takes
the loops below unchanged.

``cg`` also takes a block of right-hand sides, b of shape (n, R) with
2 ≤ R ≤ ``kernels.engines.MULTI_RHS_MAX`` (the load cases of one operator,
as PETSc's ``KSPMatSolve`` takes them): R independent CG recurrences, each
column with its own α, β, stop and iteration count, that share one
``matmat`` an iteration (K8 + K9 on a CSR plan). The body writes each
column only under its own mask, so a stopped column keeps its bits
while the others run, and the loop runs while any column
is active: eagerly, the host reads that before each iteration; in the
graph loop (kept under ``"cg_rhs"``, one per container, made afresh for
another R) the captured chunk ends by writing it to the flag.

The sharded containers (``dist.RowShardedSpmv``, ``dist.ColShardedSpmv``
in float32) solve too, as JAX's solvers take them through
``_matvec_traced``: their ``matvec`` takes the whole x and returns the
whole y on every rank, so every rank runs the same loop on the same
vectors and computes the same dots, the same k and the same x. They run
the eager loop and never capture: their ``matvec`` holds collectives,
which a gloo group cannot run inside a CUDA graph and which would tie a
captured NCCL call to one communicator. The choice is made by type
(``_operator``), never by a capture that fails. cg runs their body as
PyTorch calls (``cg_body``'s plain version), so on the card their k and x
are cg's over the same ``matvec`` with that body, not the bits of the
single container, whose body there runs the kernels. Their fp64-grade and BSR
forms raise JAX's ``NotImplementedError``; ``RingShardedSpmv`` and
``ChunkedRowSpmv``, which JAX's solvers cannot compose either, its
``TypeError``.
"""

from __future__ import annotations

import contextlib
import functools
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
    sharded one never, by design)."""
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


def _float32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(v, dtype=np.float32)).to(device)


def _vector(v, n: int, device, what: str) -> torch.Tensor:
    t = _float32(v, device).reshape(-1).contiguous()
    if t.numel() != n:
        raise ValueError(f"{what} has {t.numel()} entries, matrix is {n}")
    return t


def _columns(v) -> int | None:
    """R where ``v`` is a block of right-hand sides, of shape (n, R) with R
    other than 1; None for a vector (an (n, 1) one is flattened)."""
    shape = tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)
    return shape[1] if len(shape) == 2 and shape[1] != 1 else None


def _block(v, n: int, R: int, device, what: str) -> torch.Tensor:
    t = _float32(v, device)
    if tuple(t.shape) != (n, R):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, the block is ({n}, {R})")
    return t.contiguous()


def _tol2(b: torch.Tensor, tol: float) -> torch.Tensor:
    """``tol²·max(b·b, 1e-30)`` in float32, on the device; per column for
    a block b."""
    bb = torch.dot(b, b) if b.dim() == 1 else (b * b).sum(0)
    return float(np.float32(tol) ** 2) * torch.clamp(bb, min=_EPS)


class _Traced:
    """A traced solve, as the context of its root span: the SpMVs one loop
    body makes, and whether the host has read a value of the solve since
    its last graph launch (the loops issue nothing else between a read and
    a replay)."""

    def __init__(self, name: str, body_spmvs: int):
        self._span, self.body_spmvs, self.read = trace.span(name), body_spmvs, False

    def __enter__(self) -> "_Traced":
        self.root = self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._span.__exit__(*exc)

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

    def loop(self, mode: str, replays: int, host_reads: int, bodies: int) -> None:
        self.bodies = bodies
        self.root.counts.update(mode=mode, replays=replays, host_reads=host_reads,
                                spmvs=bodies * self.body_spmvs)

    def finish(self, iterations: int, outside: int, **counts) -> None:
        """The solve's counts once it has run: ``outside``, its SpMVs
        outside the loop (cg's r0, power iteration's Rayleigh quotient);
        ``counts``, further counts of the solve's own."""
        self.root.counts["iterations"] = iterations
        self.root.counts["spmvs"] += outside
        self.root.counts.update(counts)


def _host(tr: _Traced | None, cast, v: torch.Tensor):
    return cast(v) if tr is None else tr.host(cast, v)


def _solve(name: str, body_spmvs: int):
    """The solve's ``_Traced`` where armed; else a context that gives
    None."""
    return _Traced(name, body_spmvs) if trace.armed() else contextlib.nullcontext()


def _run(a, solver: str, step, active, state: tuple, consts: tuple,
         graph: bool, count: int | None = None, tr: _Traced | None = None,
         going=None, in_place: bool = False) -> tuple:
    """Iterate ``state = step(*state, *consts)`` while ``active(*state,
    *consts)``, or ``count`` times for a loop of a fixed count; returns the
    final state. Eagerly (the host reads ``active`` before each iteration),
    or with ``graph`` on the container's CUDA graph loop for ``solver``:
    the container's first such solve runs eagerly, the second captures the
    loop and keeps it on the container (``a._graph_loops``), and every
    later one loads its own state and constants into the loop's tensors
    and replays it. A one-shot solve so never pays a capture, which costs
    more than the eager loop it would replace. ``tr``, a traced solve,
    gets the loop's spans and counts.

    ``in_place``, for a body that updates the state's tensors in place and
    applies the loop's mask itself (cg's): ``step`` returns the state it
    was given, the graph loop applies no ``torch.where``, and the eager
    loop runs on copies of the state, which may alias (cg's r0 is also its
    p0) or be the caller's.

    ``going``, for such a body over columns, whose ``active`` gives each
    column's mask: the loop runs while ``going(*state, *consts)``, any
    column active. Its graph loop serves one state shape: a solve of
    another shape takes the seen-once rule afresh."""
    loops = a.__dict__.setdefault("_graph_loops", {}) if graph else {}
    if going is not None and _shape(loops.get(solver, state[0].shape)) != state[0].shape:
        del loops[solver]  # made for another shape
    if count != 0 and solver in loops:
        loop, mode = loops[solver], "replay"
        if not isinstance(loop, _GraphLoop):
            capture = trace.span("solve.capture", bodies=GRAPH_CHUNK) if tr else None
            with capture or contextlib.nullcontext():
                loop = loops[solver] = _GraphLoop(step, active, state, consts, going,
                                                  in_place)
            mode = "capture"
        else:
            loop.load(state, consts)
        state = loop.run(count, tr)
        if tr is not None:
            tr.loop(mode, loop.replays, loop.host_reads, loop.replays * loop.chunk)
        return state
    if graph:  # seen once: the next such solve captures
        loops[solver] = None if going is None else state[0].shape
    if count is not None:
        for _ in range(count):
            state = step(*state, *consts)
        steps, reads = count, 0
    else:
        steps = 0
        if in_place:
            state = tuple(t.clone() for t in state)
        while _host(tr, bool, (going or active)(*state, *consts)):
            state = step(*state, *consts)
            steps += 1
        reads = steps + 1
    if tr is not None:
        tr.loop("eager", 0, reads, steps)
    return state


def _masked(step, active, state: tuple, consts: tuple, in_place: bool = False) -> None:
    """One iteration in place, where ``active``: the state is rewritten
    through ``torch.where`` on the device's flag, so an inactive state
    keeps its bits and nothing is read on the host. A body that masks
    itself (``in_place``) runs as it is."""
    if in_place:
        step(*state, *consts)
        return
    on = active(*state, *consts)
    for s, new in zip(state, step(*state, *consts)):
        torch.where(on, new, s, out=s)


class _GraphLoop:
    """``GRAPH_CHUNK`` masked copies of a loop body over static state and
    constant tensors, captured as one CUDA graph whose replay ends by
    writing the loop's condition to ``flag`` (``going`` where given, for
    a loop over columns whose ``active`` is a mask per column; ``in_place``
    for a body that masks itself, as ``_run`` takes it). ``replays`` and
    ``host_reads`` say what its last run did."""

    def __init__(self, step, active, state: tuple, consts: tuple, going=None,
                 in_place: bool = False):
        self.step, self.active, self.chunk = step, active, GRAPH_CHUNK
        self.in_place = in_place
        self.going = going or active
        self.state = tuple(t.clone() for t in state)
        self.consts = tuple(t.clone() for t in consts)
        self.replays = self.host_reads = 0
        self._capture()

    def load(self, state: tuple, consts: tuple) -> None:
        for mine, new in zip(self.state + self.consts, state + consts):
            mine.copy_(new)

    def _chunk(self) -> torch.Tensor:
        for _ in range(self.chunk):
            _masked(self.step, self.active, self.state, self.consts, self.in_place)
        return self.going(*self.state, *self.consts)

    def _capture(self) -> None:
        dev = self.state[0].device
        scratch = tuple(t.clone() for t in self.state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            _masked(self.step, self.active, scratch, self.consts,
                    self.in_place)  # a warm-up body
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

    def run(self, count: int | None = None, tr: _Traced | None = None) -> tuple:
        """Replay until the flag reads false (one host read before the
        first replay and one after each), or, for a loop of a fixed
        ``count``, ``ceil(count / chunk)`` times with no host read. In a
        traced solve ``tr`` each replay and each host read is a span."""
        launch, read = self.replay, bool
        if tr is not None:
            launch, read = functools.partial(tr.replay, launch), functools.partial(tr.host, read)
        if count is None:
            self.replays, self.host_reads = 0, 1
            going = read(self.going(*self.state, *self.consts))
            while going:
                launch()
                self.replays += 1
                self.host_reads += 1
                going = read(self.flag)
        else:
            self.replays, self.host_reads = math.ceil(count / self.chunk), 0
            for _ in range(self.replays):
                launch()
        return self.state


def _shape(held):
    """The state shape a ``_graph_loops`` entry serves: a loop's, or the
    shape a seen-once mark names."""
    return held.state[0].shape if isinstance(held, _GraphLoop) else held


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
    if a.nrows != a.ncols:
        raise ValueError("cg requires a square matrix")
    R = _columns(b)
    if R is not None:
        return _cg_block(a, b, R, tol, maxiter, x0, _graph)
    mv, device, graphable = _operator(a)
    with _solve("solve.cg", 1) as tr:
        b = _vector(b, a.nrows, device, "b")
        x0 = torch.zeros_like(b) if x0 is None else _vector(x0, a.nrows, device, "x0")
        r0 = b - mv(x0)
        state = (x0, r0, r0, torch.dot(r0, r0),
                 torch.zeros((), dtype=torch.int32, device=device))
        x, _, _, rs, k = _cg_loop(a, "cg", mv, state,
                                  (_tol2(b, tol), _count(maxiter, device)),
                                  graphable, _graph, tr)
        k, res = _host(tr, int, k), _host(tr, float, torch.sqrt(rs))
        if tr is not None:
            tr.finish(k, outside=1, rhs=1)  # r0
    return x.clone(), k, res


def _cg_block(a, b, R: int, tol: float, maxiter: int, x0, graph: bool):
    """``cg`` on a block of right-hand sides, b of shape (n, R)."""
    _, device, graphable = _operator(a)
    if isinstance(a, Sharded) or not hasattr(a, "matmat"):
        raise TypeError(
            f"cg on a block of right-hand sides needs an engine container with "
            f"matmat (csr/coo/cmrs/ell/sell/hyb/sym); {type(a).__name__} solves "
            f"one vector at a time")
    if not 2 <= R <= MULTI_RHS_MAX:
        raise ValueError(f"cg takes a block of 2 to MULTI_RHS_MAX = {MULTI_RHS_MAX} "
                         f"right-hand sides, got {R}")
    mm = a.matmat
    with _solve("solve.cg", 1) as tr:
        B = _block(b, a.nrows, R, device, "b")
        X0 = torch.zeros_like(B) if x0 is None else _block(x0, a.nrows, R, device, "x0")
        R0 = B - mm(X0)
        state = (X0, R0, R0, (R0 * R0).sum(0),
                 torch.zeros(R, dtype=torch.int32, device=device))
        x, _, _, rs, k = _cg_loop(a, "cg_rhs", mm, state,
                                  (_tol2(B, tol), _count(maxiter, device)),
                                  graphable, graph, tr)
        ks = _host(tr, torch.Tensor.tolist, k)
        res = _host(tr, torch.Tensor.tolist, torch.sqrt(rs))
        if tr is not None:  # the loop ran to the slowest column; r0
            tr.finish(max(ks), outside=1, rhs=R, column_iterations=sum(ks))
    return x.clone(), ks, res


def _cg_active(x, r, p, rs, k, tol2, kmax):
    """cg's condition on its state: a flag, or a mask per column."""
    return (rs > tol2) & (k < kmax)


def _cg_going(*state):
    return _cg_active(*state).any()


def _cg_loop(a, solver: str, mv, state: tuple, consts: tuple, graphable: bool,
             graph: bool, tr: _Traced | None) -> tuple:
    """cg's iterations from ``state`` = (x, r, p, rs, k) with ``consts`` =
    (tol2, kmax), ``mv`` its SpMV (``matmat`` for an (n, R) block, whose
    loop runs while any column is active). The body after the SpMV is
    ``cg_body.Body``, in place and masked per column: its kernels where
    ``graphable`` (an engine container on the card), else its PyTorch
    version. The traced solve counts the bodies the kernels ran
    (``fused_bodies``)."""
    body = cg_body.Body(state[0].shape, state[0].device, kernels=graphable)

    def step(x, r, p, rs, k, tol2, kmax):
        body(x, r, p, mv(p), rs, k, tol2, kmax)
        return x, r, p, rs, k

    state = _run(a, solver, step, _cg_active, state, consts,
                 _uses_graph(graphable, graph), tr=tr,
                 going=_cg_going if state[0].dim() == 2 else None, in_place=True)
    if tr is not None:
        tr.root.counts["fused_bodies"] = tr.bodies if body.kernels else 0
    return state


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
        b = _vector(b, a.nrows, device, "b")
        x0 = torch.zeros_like(b) if x0 is None else _vector(x0, a.nrows, device, "x0")
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
        x, _, _, _, rs, k = _run(a, "bicgstab", step, active, state,
                                 (r0, _tol2(b, tol), _count(maxiter, device)),
                                 _uses_graph(graphable, _graph), tr=tr)
        k, res = _host(tr, int, k), _host(tr, float, torch.sqrt(rs))
        if tr is not None:
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
        v = _run(a, "power_iteration", step, active, state, (_count(iters, device),),
                 _uses_graph(graphable, _graph), count=iters, tr=tr)[0].clone()
        lam = _host(tr, float, torch.dot(v, mv(v)))
        if tr is not None:
            tr.finish(iters, outside=1)  # the Rayleigh quotient
    return lam, v

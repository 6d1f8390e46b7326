"""cg's fused body (``spmv_tpu_torch.kernels.cg_body``): its plain version
against the PyTorch body it replaces, the solver loop's in-place path, and
on a card the three kernels against the plain version.

The plain version must be the PyTorch body and its ``torch.where``
rewrite bit for bit (``parent_step`` below is that body as ``solve.cg``
ran it before the fused body). On a card the kernels must give x, r and p
the plain version's bits for the alpha and beta they computed, keep a
frozen column's bits and repeat bitwise. Their dots reduce in another
order than ``torch.dot`` and the column sums: both are trees of depth at
most about 30 over float32 products that are positive or nearly so
(p·Ap with A SPD, r·r), so they differ by a few units in the last place
of the sum; alpha and rs are held within 1e-5 relative (about 2^7 ulp).

The ``gpu`` tests run with ``--noconftest`` on the card, as
``test_solve_rhs.py``'s: this file imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from spmv_tpu_torch import solve, trace
from spmv_tpu_torch.kernels import cg_body
from spmv_tpu_torch.kernels import engines as E

from _torch_loops import cpu_graph  # noqa: F401  (the fixture, with CpuLoop)
from test_solve_rhs import block, container, stencil

TOL = 1e-6


def parent_step(mv, x, r, p, rs, k, tol2, kmax):
    """The body ``solve.cg`` ran before the fused body, for a vector and
    for a block, as written there."""
    ap = mv(p)
    if x.dim() == 1:
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
    else:
        alpha = rs / (p * ap).sum(0)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum(0)
    p = r + (rs_new / rs) * p
    return x, r, p, rs_new, k + 1


def parent_masked(mv, state, consts):
    """The solver loop's mask as it ran that body: each state tensor
    rewritten through ``torch.where`` on the mask of the entry state."""
    x, r, p, rs, k = state
    tol2, kmax = consts
    on = (rs > tol2) & (k < kmax)
    for s, new in zip(state, parent_step(mv, *state, *consts)):
        torch.where(on, new, s, out=s)


def start(a, B, R, device="cpu"):
    """cg's entry state for b = B (a vector for R = 1) from x0 = 0: the
    clones the in-place body needs (r0 is also p0)."""
    mv = a.matvec if R == 1 else a.matmat
    b = B[:, 0].contiguous() if R == 1 else B
    x = torch.zeros_like(b)
    r = b - mv(x)
    rs = torch.dot(r, r) if R == 1 else (r * r).sum(0)
    k = torch.zeros(() if R == 1 else R, dtype=torch.int32, device=device)
    return mv, (x, r, r.clone(), rs, k)


def constants(rs, tol, stop_early=None):
    """tol2 = tol²·rs0 per column (b's norm, as x0 = 0), with a column
    ``stop_early`` given tol 0.5, so it stops after a few bodies."""
    tol2 = float(np.float32(tol) ** 2) * torch.clamp(rs, min=1e-30)
    if stop_early is not None:
        tol2 = tol2.clone()
        tol2.view(-1)[stop_early] = 0.25 * rs.view(-1)[stop_early]
    return tol2


@pytest.mark.parametrize("case", ["R1-running", "R1-frozen", "R2", "R4", "R8"])
def test_the_plain_body_is_the_parent_step_and_its_where(case):
    """Body after body, the plain version's state is the parent's body and
    ``torch.where`` rewrite bit for bit: column 0 of a block is zero, so
    frozen from the start; column 1 stops midway on its loose tolerance;
    the vector runs, or has b = 0 and is frozen."""
    R = 1 if case.startswith("R1") else int(case[1:])
    n, r_, c_, v_ = stencil(6)
    a = container("csr", n, r_, c_, v_)
    B = torch.from_numpy(block(n, R, seed=21))
    if case == "R1-frozen" or R > 1:
        B[:, 0] = 0
    mv, state = start(a, B, R)
    consts = (constants(state[3], 1e-5, stop_early=1 if R > 1 else None),
              torch.tensor(400, dtype=torch.int64))
    mine = tuple(t.clone() for t in state)
    for _ in range(8):
        parent_masked(mv, state, consts)
        cg_body.body_reference(mine[0], mine[1], mine[2], mv(mine[2]), *mine[3:], *consts)
        for got, want in zip(mine, state):
            assert torch.equal(got, want)
    k = state[4].view(-1)
    if case == "R1-frozen" or R > 1:
        assert k[0] == 0 and not state[0].view(n, -1)[:, 0].any()
    if R > 1:
        assert 0 < k[1] < 8 and bool((k[2:] == 8).all()), k
    elif case == "R1-running":
        assert k[0] == 8


def test_the_body_refuses_what_its_kernels_do_not_take():
    n = 10
    with pytest.raises(ValueError, match="1 to 8 columns"):
        cg_body.Body((n, 9), "cpu")
    body = cg_body.Body((n, 3), "cpu")
    z = torch.zeros((n, 3))
    rs, k = torch.ones(3), torch.zeros(3, dtype=torch.int32)
    tol2, kmax = torch.zeros(3), torch.tensor(5)
    body(z.clone(), z.clone(), z.clone(), z.clone(), rs.clone(), k.clone(), tol2, kmax)
    with pytest.raises(ValueError, match="state of shape"):
        body(torch.zeros(n), z, z, z, rs, k, tol2, kmax)
    with pytest.raises(ValueError, match="k: expected torch.int32"):
        body(z, z, z, z, rs, k.long(), tol2, kmax)
    with pytest.raises(ValueError, match="kmax: expected torch.int64"):
        body(z, z, z, z, rs, k, tol2, kmax.int())
    with pytest.raises(ValueError, match="ap must be contiguous"):
        body(z, z, z, torch.zeros((3, n)).t(), rs, k, tol2, kmax)


def root_span():
    roots = [s for s in trace.spans() if s.name == "solve.cg"]
    assert len(roots) == 1
    return roots[0]


def traced(fn):
    trace.clear()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    s = root_span()
    trace.clear()
    return out, s


@pytest.mark.parametrize("R", [1, 3])
def test_the_cpu_runs_the_pytorch_body_and_counts_no_fused_one(R):
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    B = block(n, R)
    before = dict(cg_body.LAUNCHES)
    out, s = traced(lambda: solve.cg(a, B[:, 0] if R == 1 else B, tol=TOL))
    assert s.counts["iterations"] > 0 and "fused_bodies" not in s.counts
    assert cg_body.LAUNCHES == before


def parent_cg(a, b, x0, tol, maxiter=1000):
    """``solve.cg``'s eager loop as it ran before the fused body: for a
    vector ``parent_step`` while the solve's condition holds, for a block
    ``parent_masked`` while any column's does. Returns (x, k, residual)
    as ``solve.cg`` does."""
    mv = a.matvec if b.dim() == 1 else a.matmat
    r0 = b - mv(x0)
    rs = torch.dot(r0, r0) if b.dim() == 1 else (r0 * r0).sum(0)
    state = (x0.clone(), r0, r0.clone(), rs, torch.zeros(rs.shape, dtype=torch.int32))
    consts = (solve._tol2(b, tol), torch.tensor(maxiter, dtype=torch.int64))
    while bool(((state[3] > consts[0]) & (state[4] < consts[1])).any()):
        if b.dim() == 1:
            state = parent_step(mv, *state, *consts)
        else:
            parent_masked(mv, state, consts)
    x, _, _, rs, k = state
    if b.dim() == 1:
        return x, int(k), float(torch.sqrt(rs))
    return x, k.tolist(), torch.sqrt(rs).tolist()


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("R", [1, 4])
def test_the_in_place_loop_gives_the_pytorch_loops_bits(cpu_graph, monkeypatch, R, chunk):
    """The solver loop's in-place path (on the CPU with the body's plain
    version) gives the parent's PyTorch loop's x, k and residual bit for
    bit, eagerly, at capture and at replay; it runs one SpMV a body and no
    kernel, leaves the caller's x0 as it was and writes r0 and p0 apart."""
    monkeypatch.setattr(solve, "GRAPH_CHUNK", chunk)
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    B, X0 = block(n, R, seed=9), block(n, R, seed=10) * 0.1
    if R > 1:
        B[:, 0] = X0[:, 0] = 0  # frozen from the start
    b = torch.from_numpy(B[:, 0].copy() if R == 1 else B)
    x0 = torch.from_numpy(X0).reshape(b.shape)
    kept = x0.clone()
    want = parent_cg(a, b, x0, TOL)
    launched = dict(cg_body.LAUNCHES)
    for mode, graph in (("eager", False), ("eager", True), ("capture", True),
                        ("replay", True)):
        (x, k, res), s = traced(lambda: solve.cg(a, b, x0=x0, tol=TOL, _graph=graph))
        assert torch.equal(x, want[0]) and (k, res) == want[1:], mode
        assert s.counts["mode"] == mode
        loop = getattr(a, "_graph_loops", {}).get("cg" if R == 1 else "cg_rhs")
        bodies = (max(k) if R > 1 else k) if mode == "eager" else loop.replays * chunk
        assert s.counts["spmvs"] == bodies + 1  # and r0's
        assert cg_body.LAUNCHES == launched
        assert torch.equal(x0, kept)
    assert isinstance(loop, solve._GraphLoop) and loop.state[0].shape == b.shape


@pytest.mark.parametrize("kernels", [False, True])
def test_a_body_on_the_cpu_is_the_plain_version_and_allocates_nothing(kernels):
    """Off a card the body is the plain version whatever ``kernels`` says,
    and the kernels' scratch is never allocated."""
    n, R = 50, 3
    g = torch.Generator().manual_seed(3)
    state = [torch.randn((n, R), generator=g) for _ in range(4)]
    rs, k = (state[1] ** 2).sum(0), torch.tensor([0, 5, 1], dtype=torch.int32)
    tol2, kmax = torch.tensor([0.0, 0.0, 1e30]), torch.tensor(5)
    want = [t.clone() for t in (*state[:3], rs, k)]
    cg_body.body_reference(*want[:3], state[3], *want[3:], tol2, kmax)
    body = cg_body.Body((n, R), "cpu", kernels=kernels)
    got = [t.clone() for t in (*state[:3], rs, k)]
    body(*got[:3], state[3], *got[3:], tol2, kmax)
    assert not body.kernels and body.partials is None
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    assert torch.equal(got[4], torch.tensor([1, 5, 1], dtype=torch.int32))


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.gpu
@pytest.mark.parametrize("m", [15, 72])
@pytest.mark.parametrize("R", [1, 3, 4, 8])
def test_the_kernels_are_the_plain_body_on_the_card(cuda, R, m):
    """Twelve bodies on HPCG's stencil (m = 15: 3,375 rows, rows past the
    last whole unit; m = 72: 373,248 rows, the grid at its cap for R ≥ 4),
    each held to the plain version: the mask of the entry state; x, r and p
    the plain arithmetic's bits for the kernels' alpha and beta; alpha and
    rs within 1e-5 of the plain dots; beta = rs_new / rs exactly; k + 1
    where on; frozen columns (a zero column, one stopping midway)
    untouched; a second run of the same body the same bits."""
    n, r_, c_, v_ = stencil(m)
    a = container("csr", n, r_, c_, v_, device=cuda)
    B = torch.from_numpy(block(n, max(R, 2), seed=31)).to(cuda)
    if R > 1:
        B[:, 0] = 0
    mv, state = start(a, B[:, :R] if R > 1 else B, R, device=cuda)
    consts = (constants(state[3], 1e-5, stop_early=1 if R > 1 else None),
              torch.tensor(1000, dtype=torch.int64, device=cuda))
    body = cg_body.Body(state[0].shape, cuda)
    launches = dict(cg_body.LAUNCHES)
    for it in range(12):
        x, r, p, rs, k = (t.clone() for t in state)
        ap = mv(state[2])
        body(*state[:3], ap, *state[3:], *consts)
        on = (rs > consts[0]) & (k < consts[1])
        assert torch.equal(body.mask.view(on.shape).bool(), on)
        alpha = body.alpha.view(rs.shape)
        beta = body.beta.view(rs.shape)
        xw = torch.where(on, x + alpha * p, x)
        rw = torch.where(on, r - alpha * ap, r)
        pw = torch.where(on, rw + beta * p, p)
        for got, want in zip(state[:3], (xw, rw, pw)):
            assert torch.equal(bits(got), bits(want)), it
        dot = torch.dot if R == 1 else (lambda u, w: (u * w).sum(0))
        rs_plain = dot(rw, rw)
        pap = dot(p, ap)
        live = on.view(-1)
        rel_a = ((alpha - rs / pap).abs() / (rs / pap).abs()).view(-1)[live]
        rel_rs = ((state[3] - rs_plain).abs() / rs_plain).view(-1)[live]
        assert bool((rel_a < 1e-5).all()) and bool((rel_rs < 1e-5).all()), (rel_a, rel_rs)
        assert torch.equal(bits(torch.where(on, state[3] / rs, beta)), bits(beta))
        assert torch.equal(bits(torch.where(on, state[3], rs)), bits(state[3]))
        assert torch.equal(state[4], k + on.int())
        again = tuple(t.clone() for t in (x, r, p, rs, k))
        cg_body.Body(x.shape, cuda)(*again[:3], ap, *again[3:], *consts)
        for got, want in zip(again, state):
            assert torch.equal(bits(got), bits(want))
    assert {key: cg_body.LAUNCHES[key] - launches[key] for key in launches} == {
        "cg_body_pap": 24, "cg_body_xr": 24, "cg_body_p": 24}
    if R > 1:  # column 0 frozen from the start, column 1 stopped midway
        k = state[4]
        assert k[0] == 0 and 0 < k[1] < 12 and bool((k[2:] == 12).all()), k
        assert not state[0][:, 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 4])
def test_the_solve_on_the_card_counts_fused_bodies_and_keeps_its_launches(cuda, R):
    """Eagerly, at capture and at replay: each body run from the host is
    three launches of ``cg_body``, one of each kernel (the capture's
    warm-up body and chunk among them; a replay launches none from the
    host), and ``engines.LAUNCHES`` counts one SpMV's kernels per body and
    r0's, as before the fused body; graph = eager."""
    n, r, c, v = stencil(16)
    a = container("csr", n, r, c, v, device=cuda)
    B = torch.from_numpy(block(n, max(R, 2), seed=5)).to(cuda)
    b = B[:, 0].contiguous() if R == 1 else B[:, :R].contiguous()
    mv = a.matvec if R == 1 else a.matmat
    before = sum(E.LAUNCHES.values())
    mv(b)
    per = sum(E.LAUNCHES.values()) - before
    want = solve.cg(a, b, tol=TOL, _graph=False)
    for mode in ("eager", "capture", "replay"):
        before, mine = sum(E.LAUNCHES.values()), dict(cg_body.LAUNCHES)
        (x, k, res), s = traced(lambda: solve.cg(a, b, tol=TOL))
        spent = sum(E.LAUNCHES.values()) - before
        fused = {key: cg_body.LAUNCHES[key] - mine[key] for key in mine}
        assert torch.equal(x, want[0]) and (k, res) == want[1:]
        kmax = k if R == 1 else max(k)
        loop = a._graph_loops.get("cg" if R == 1 else "cg_rhs")
        assert s.counts["mode"] == mode
        assert "fused_bodies" not in s.counts
        if mode == "eager":
            assert spent == (kmax + 1) * per and set(fused.values()) == {kmax}
        elif mode == "capture":
            assert spent == (solve.GRAPH_CHUNK + 2) * per
            assert set(fused.values()) == {solve.GRAPH_CHUNK + 1}
        else:
            assert loop.replays == math.ceil(kmax / loop.chunk)
            assert loop.state[0].shape == b.shape
            assert spent == per and set(fused.values()) == {0}

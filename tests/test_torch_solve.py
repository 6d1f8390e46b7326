"""The port's Krylov solvers (``spmv_tpu_torch.solve``) against the JAX
package's (``spmv_tpu.solve``, interpret mode on the CPU, as
``tests/test_solve.py`` runs them) on the same seeded numpy systems.

Tolerances: cg and bicgstab reach x within 1e-3 relative of the fp64
truth (``test_solve.py``'s bound for an fp32 solve), and their iteration
counts differ from JAX's by at most 2 (the two packages round the SpMV
differently, so the last iteration may fall either way); power iteration's
eigenvalue lies within 1e-3 relative of JAX's (the start vectors differ:
``jax.random`` bits cannot be reproduced).

The CUDA graph loop needs a card (``test_torch_gpu.py``); here its chunked,
masked iteration runs on the CPU without a graph (``CpuLoop``) and must
give the eager loop's bits."""

import math

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu import solve as ref_solve
from spmv_tpu_torch import solve

FORMATS = ["csr", "coo", "cmrs", "ell", "sell", "hyb", "sym"]


def spd(n=260, seed=5, density=0.02):
    """test_solve.py's SPD matrix: BᵀB + n·I."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    B = np.zeros((n, n))
    B[r, c] += rng.standard_normal(nnz)
    A = B.T @ B + n * np.eye(n)
    rr, cc = np.nonzero(A)
    return n, rr, cc, A[rr, cc], A


def laplacian(m=14, shift=0.05):
    """The 5-point Laplacian on an m×m grid plus shift·I: SPD, with a
    condition number of about 1600, so cg takes tens of iterations."""
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
    return n, rr, cc, A[rr, cc], A


def nonsymmetric(n=160):
    """test_solve.py's diagonally dominant nonsymmetric band."""
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:], i[:-2]])
    cols = np.concatenate([i, i[1:], i[:-1], i[2:]])
    vals = np.concatenate([np.full(n, 5.0), np.full(n - 1, -1.3),
                           np.full(n - 1, 0.7), np.full(n - 2, 0.4)])
    A = np.zeros((n, n))
    A[rows, cols] = vals
    return n, rows, cols, vals, A


def build(fmt, n, r, c, v, jax=False):
    if fmt == "sym":  # the stored lower triangle
        keep = r >= c
        r, c, v = r[keep], c[keep], v[keep]
    if jax:
        return spmv_tpu.from_coo(fmt, n, n, r, c, v)
    return spmv_tpu_torch.from_coo(fmt, n, n, r, c, v, device="cpu")


SYSTEMS = {"spd_260": spd, "laplacian_196": laplacian}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_cg_matches_jax_and_the_fp64_truth(system, fmt):
    n, r, c, v, A = SYSTEMS[system]()
    xtrue = np.random.default_rng(0).standard_normal(n)
    b = A @ xtrue
    x, k, res = solve.cg(build(fmt, n, r, c, v), b, tol=1e-6, maxiter=500)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
    assert x.shape == (n,) and isinstance(k, int) and isinstance(res, float)
    assert 0 < k < 500
    assert np.linalg.norm(x.numpy() - xtrue) / np.linalg.norm(xtrue) < 1e-3
    if fmt in ("csr", "sym"):  # JAX's own run, one per engine path
        _, k_jax, _ = ref_solve.cg(build(fmt, n, r, c, v, jax=True), b,
                                   tol=1e-6, maxiter=500)
        assert abs(k - k_jax) <= 2, (k, k_jax)


@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb", "cmrs"])
def test_bicgstab_matches_jax_and_the_fp64_truth(fmt):
    n, r, c, v, A = nonsymmetric()
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    x, k, res = solve.bicgstab(build(fmt, n, r, c, v), b, tol=1e-6, maxiter=400)
    assert 0 < k < 400
    assert np.linalg.norm(A @ x.numpy().astype(np.float64) - b) < 1e-3
    xtrue = np.linalg.solve(A, b.astype(np.float64))
    assert np.linalg.norm(x.numpy() - xtrue) / np.linalg.norm(xtrue) < 1e-3
    if fmt == "csr":
        _, k_jax, res_jax = ref_solve.bicgstab(build(fmt, n, r, c, v, jax=True), b,
                                               tol=1e-6, maxiter=400)
        assert abs(k - k_jax) <= 2, (k, k_jax)


@pytest.mark.parametrize("fmt", ["csr", "sym"])
def test_bicgstab_on_an_spd_system(fmt):
    n, r, c, v, A = laplacian()
    xtrue = np.random.default_rng(2).standard_normal(n)
    x, k, _ = solve.bicgstab(build(fmt, n, r, c, v), A @ xtrue, tol=1e-6, maxiter=500)
    assert 0 < k < 500
    assert np.linalg.norm(x.numpy() - xtrue) / np.linalg.norm(xtrue) < 1e-3


def spiked(n=200, seed=7):
    """test_solve.py's power-iteration matrix: an SPD matrix plus a
    dominant rank-1 spike."""
    n, _, _, _, A = spd(n=n, seed=seed)
    u = np.random.default_rng(3).standard_normal(n)
    u /= np.linalg.norm(u)
    A = A + 5 * n * np.outer(u, u)
    rr, cc = np.nonzero(A)
    return n, rr, cc, A[rr, cc], A


@pytest.mark.parametrize("fmt", ["csr", "ell", "sym"])
def test_power_iteration_matches_jax(fmt):
    n, r, c, v, A = spiked()
    lam, vec = solve.power_iteration(build(fmt, n, r, c, v), iters=200)
    lam_jax, _ = ref_solve.power_iteration(build("csr", n, r, c, v, jax=True), iters=200)
    assert abs(lam - lam_jax) / abs(lam_jax) < 1e-3, (lam, lam_jax)
    lam_true = np.linalg.eigvalsh(A)[-1]
    assert abs(lam - lam_true) / lam_true < 1e-3
    assert isinstance(vec, torch.Tensor) and vec.shape == (n,)
    assert abs(float(torch.linalg.vector_norm(vec)) - 1) < 1e-5


def test_power_iteration_seeds_a_torch_generator():
    n, r, c, v, _ = spiked(n=60)
    a = build("csr", n, r, c, v)
    l1, v1 = solve.power_iteration(a, iters=5, seed=3)
    l2, v2 = solve.power_iteration(a, iters=5, seed=3)
    _, v3 = solve.power_iteration(a, iters=5, seed=4)
    assert l1 == l2 and torch.equal(v1, v2) and not torch.equal(v1, v3)
    lam0, v0 = solve.power_iteration(a, iters=0, seed=3)
    gen = torch.Generator("cpu").manual_seed(3)
    assert torch.equal(v0, torch.randn(n, generator=gen))
    assert lam0 == pytest.approx(float(v0 @ a.matvec(v0)))


@pytest.mark.parametrize("which", ["cg", "bicgstab", "power_iteration"])
def test_rectangular_matrices_are_refused_as_jax_refuses_them(which):
    call = {"cg": lambda s, a: s.cg(a, np.ones(4)),
            "bicgstab": lambda s, a: s.bicgstab(a, np.ones(4)),
            "power_iteration": lambda s, a: s.power_iteration(a)}[which]
    with pytest.raises(ValueError) as ref:
        call(ref_solve, spmv_tpu.from_coo("csr", 4, 6, [0], [1], [1.0]))
    with pytest.raises(ValueError) as mine:
        call(solve, spmv_tpu_torch.from_coo("csr", 4, 6, [0], [1], [1.0], device="cpu"))
    assert str(mine.value) == str(ref.value) == f"{which} requires a square matrix"


@pytest.mark.parametrize("which", ["cg", "bicgstab"])
def test_a_wrong_length_of_b_is_refused_as_jax_refuses_it(which):
    n, r, c, v, _ = spd(n=30)
    with pytest.raises(ValueError) as ref:
        getattr(ref_solve, which)(build("csr", n, r, c, v, jax=True), np.ones(n + 1))
    with pytest.raises(ValueError) as mine:
        getattr(solve, which)(build("csr", n, r, c, v), np.ones(n + 1))
    assert str(mine.value) == str(ref.value) == f"b has {n + 1} entries, matrix is {n}"


@pytest.mark.parametrize("which", ["cg", "bicgstab", "power_iteration"])
def test_bsr_is_refused_with_type_error_as_in_jax(which):
    n, r, c, v, _ = spd(n=40)
    args = {} if which == "power_iteration" else {"b": np.ones(n)}
    with pytest.raises(TypeError):
        getattr(ref_solve, which)(spmv_tpu.from_coo("bsr", n, n, r, c, v), **args)
    with pytest.raises(TypeError, match="use csr/coo/cmrs/ell/sell/hyb/sym"):
        getattr(solve, which)(build("bsr", n, r, c, v), **args)


def test_x2matrix_is_refused_where_jax_returns_a_wrong_x():
    """JAX's solvers hand an ``X2Matrix`` a float32 x table that its
    ``padded_matvec`` reads as a double-single table: cg returns a
    "converged" x whose true residual is far from tol (ROADMAP.md queue C,
    a fault of the reference that is not ported). The port refuses."""
    n, r, c, v, A = spd(n=64, seed=1)
    b = np.random.default_rng(0).standard_normal(n)
    ref = spmv_tpu.X2Matrix.from_coo("csr", n, n, r, c, v)
    x, k, res = ref_solve.cg(ref, b, tol=1e-6, maxiter=200)
    rel = np.linalg.norm(A @ np.asarray(x, np.float64) - b) / np.linalg.norm(b)
    assert k < 200 and res < 1e-3 and rel > 0.1, (k, res, rel)
    a = spmv_tpu_torch.X2Matrix.from_coo("csr", n, n, r, c, v, device="cpu")
    for which, args in (("cg", (b,)), ("bicgstab", (b,)), ("power_iteration", ())):
        with pytest.raises(TypeError, match="X2Matrix"):
            getattr(solve, which)(a, *args)


def test_zero_b_and_an_exact_x0_take_no_iteration():
    n, r, c, v, A = spd(n=50)
    a = build("csr", n, r, c, v)
    for fn in (solve.cg, solve.bicgstab):
        x, k, res = fn(a, np.zeros(n))
        assert k == 0 and res == 0.0 and not x.any()
    xtrue = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    b = a.matvec(xtrue)
    x, k, _ = solve.cg(a, b, x0=xtrue, tol=1e-3)
    assert k == 0 and np.array_equal(x.numpy(), xtrue)


def test_maxiter_stops_the_loop():
    n, r, c, v, A = laplacian()
    b = np.ones(n)
    x, k, res = solve.cg(build("csr", n, r, c, v), b, tol=1e-12, maxiter=7)
    _, k_jax, res_jax = ref_solve.cg(build("csr", n, r, c, v, jax=True), b,
                                     tol=1e-12, maxiter=7)
    assert k == k_jax == 7
    assert res == pytest.approx(res_jax, rel=1e-3)


class CpuLoop(solve._GraphLoop):
    """The graph loop's chunked, masked iteration without a graph: each
    "replay" runs ``chunk`` masked copies of the body on the CPU."""

    def _capture(self):
        def replay():
            self.flag = self._chunk()
        self.replay = replay


@pytest.fixture
def cpu_graph(monkeypatch):
    monkeypatch.setattr(solve, "_GraphLoop", CpuLoop)
    monkeypatch.setattr(solve, "_uses_graph", lambda device, graph: graph)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
@pytest.mark.parametrize("which", ["cg", "bicgstab"])
def test_chunked_masked_loop_gives_the_eager_bits(cpu_graph, monkeypatch, which,
                                                  chunk):
    """The first solve on a container runs the eager loop and captures
    nothing; the second captures the loop, whose chunked replays give the
    eager loop's bits with one host read per replay and one before."""
    monkeypatch.setattr(solve, "GRAPH_CHUNK", chunk)
    n, r, c, v, A = laplacian(m=10)
    a = build("csr", n, r, c, v)
    b = np.random.default_rng(6).standard_normal(n)
    fn = getattr(solve, which)
    x0, k0, res0 = fn(a, b, tol=1e-6, _graph=False)
    assert not hasattr(a, "_graph_loops")  # the private eager loop marks nothing
    first = fn(a, b, tol=1e-6)
    assert a._graph_loops == {which: None}  # seen, not captured
    assert torch.equal(x0, first[0]) and first[1:] == (k0, res0)
    x1, k1, res1 = fn(a, b, tol=1e-6)
    assert torch.equal(x0, x1) and k0 == k1 and res0 == res1
    loop = a._graph_loops[which]
    assert (loop.chunk, loop.replays, loop.host_reads) == (
        chunk, math.ceil(k1 / chunk), math.ceil(k1 / chunk) + 1)


@pytest.mark.parametrize("which", ["cg", "bicgstab"])
def test_a_later_solve_reuses_the_loop_with_its_own_inputs(cpu_graph, which):
    """The loop is captured once per container and solver; a later solve
    loads its own b, tol, x0 and maxiter into it and still gives the eager
    loop's bits. The x it returned before stays as it was."""
    n, r, c, v, A = laplacian(m=10)
    a = build("csr", n, r, c, v)
    fn = getattr(solve, which)
    rng = np.random.default_rng(8)
    fn(a, rng.standard_normal(n), tol=1e-6)  # eager: the first solve
    first = fn(a, rng.standard_normal(n), tol=1e-6)
    kept = first[0].clone()
    loop = a._graph_loops[which]
    for b, tol, x0, maxiter in ((rng.standard_normal(n), 1e-4, None, 1000),
                                (rng.standard_normal(n), 1e-6, rng.standard_normal(n), 1000),
                                (rng.standard_normal(n), 1e-12, None, 5)):
        eager = fn(a, b, tol=tol, x0=x0, maxiter=maxiter, _graph=False)
        again = fn(a, b, tol=tol, x0=x0, maxiter=maxiter)
        assert torch.equal(eager[0], again[0]) and eager[1:] == again[1:]
    assert again[1] == 5  # the last maxiter stopped it
    assert torch.equal(first[0], kept)
    assert a._graph_loops == {which: loop}  # one loop, whatever the maxiter


@pytest.mark.parametrize("chunk", [1, 7, 16, 100])
def test_chunked_power_iteration_gives_the_eager_bits(cpu_graph, monkeypatch, chunk):
    monkeypatch.setattr(solve, "GRAPH_CHUNK", chunk)
    n, r, c, v, _ = spiked(n=80)
    a = build("sym", n, r, c, v)
    lam0, v0 = solve.power_iteration(a, iters=30, _graph=False)
    solve.power_iteration(a, iters=30)  # eager: the first solve
    lam1, v1 = solve.power_iteration(a, iters=30)
    assert lam0 == lam1 and torch.equal(v0, v1)
    loop = a._graph_loops["power_iteration"]
    assert (loop.replays, loop.host_reads) == (math.ceil(30 / chunk), 0)
    for iters, seed in ((30, 5), (11, 2)):  # the loop reused, another count too
        lam2, v2 = solve.power_iteration(a, iters=iters, seed=seed)
        lam_e, v_e = solve.power_iteration(a, iters=iters, seed=seed, _graph=False)
        assert lam2 == lam_e and torch.equal(v2, v_e)
    assert a._graph_loops == {"power_iteration": loop}


def test_the_cpu_never_takes_the_graph_loop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(solve, "_GraphLoop", refuse)
    n, r, c, v, A = spd(n=40)
    a = build("csr", n, r, c, v)
    solve.cg(a, np.ones(n))
    solve.bicgstab(a, np.ones(n))
    solve.power_iteration(a, iters=3)

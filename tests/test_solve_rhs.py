"""``solve.cg`` on a block of right-hand sides, b of shape (n, R): R
independent CG recurrences through one ``matmat`` an iteration, each
column with its own stop, held to the benchmark's plain float64 reference
(``benchmark/reference/plain.py``) column by column and to the port's own
vector ``cg``.

Tolerances: each column stops where its float32 recursive residual falls
below tol·‖b_j‖ (tol = 1e-6 here), so its x_j lies within about cond(A)·tol
of the exact solution, as does the float64 reference's, which stops by the
same rule. Both systems have cond(A) below 10 (HPCG's stencil at 8³: its
eigenvalues lie in about [3.1, 29]; BᵀB + n·I: in [n, n + ‖B‖²]), so x_j and
the reference's agree within 1e-4 relative, with room for float32's
rounding over the iterations. The block's dots reduce a column in another
order than the vector solve's ``torch.dot``, so the two round differently
and the last iteration may fall either way: k_j lies within 1 of the
vector solve's.

The tests marked ``gpu`` run the CUDA graph loop on a card and skip
without one; here its chunked, masked iteration runs on the CPU without a
graph (``CpuLoop``, the ``cpu_graph`` fixture).
"""

import math

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from benchmark.reference import plain
from spmv_tpu_torch import solve, trace
from spmv_tpu_torch.kernels import engines as E

from _torch_loops import cpu_graph  # noqa: F401  (the fixture, with CpuLoop)

FORMATS = ["csr", "coo", "cmrs", "ell", "sell", "hyb", "sym"]
WIDTHS = [2, 4, 8]
TOL = 1e-6


def stencil(m=8):
    """HPCG's matrix (``GenerateProblem_ref.cpp``) on an m³ grid: the
    27-point stencil, 26 on the diagonal, -1 elsewhere; SPD."""
    n = m ** 3
    idx = np.arange(n)
    ix, iy, iz = idx % m, (idx // m) % m, idx // (m * m)
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                inside = (jx >= 0) & (jx < m) & (jy >= 0) & (jy < m) & (jz >= 0) & (jz < m)
                rows.append(idx[inside])
                cols.append(((jz * m + jy) * m + jx)[inside])
    r, c = np.concatenate(rows), np.concatenate(cols)
    return n, r, c, np.where(r == c, 26.0, -1.0)


def random_spd(n=300, seed=7, density=0.02):
    """A seeded random SPD matrix, BᵀB + n·I."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    B = np.zeros((n, n))
    B[rng.integers(0, n, nnz), rng.integers(0, n, nnz)] += rng.standard_normal(nnz)
    A = B.T @ B + n * np.eye(n)
    r, c = np.nonzero(A)
    return n, r, c, A[r, c]


SYSTEMS = {"hpcg_8": stencil, "random_spd_300": random_spd}


def container(fmt, n, r, c, v, device="cpu"):
    if fmt == "sym":  # the stored lower triangle
        keep = r >= c
        r, c, v = r[keep], c[keep], v[keep]
    return spmv_tpu_torch.from_coo(fmt, n, n, r, c, v, device=device)


def block(n, R, seed=3):
    return np.random.default_rng(seed).standard_normal((n, R)).astype(np.float32)


def reference(n, r, c, v):
    return plain.Operator(n, r, c, v, dtype=torch.float64, device="cpu")


def rel(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


_SOLVED = {}  # (system, format or "float64", column) -> (x, k): each solved once


def column_solve(system, fmt, j):
    """Column j of the widest block solved alone: by the port's vector
    ``cg`` on ``fmt``, or by the plain reference in float64."""
    key = (system, fmt, j)
    if key not in _SOLVED:
        n, r, c, v = SYSTEMS[system]()
        b = block(n, E.MULTI_RHS_MAX)[:, j]
        if fmt == "float64":
            x, k = plain.cg(reference(n, r, c, v), torch.from_numpy(b).double(),
                            tol=TOL, maxiter=500)
        else:
            x, k, _ = solve.cg(container(fmt, n, r, c, v), b, tol=TOL, maxiter=500)
        _SOLVED[key] = (x, k)
    return _SOLVED[key]


@pytest.mark.parametrize("R", WIDTHS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_each_column_is_the_float64_reference_and_the_vector_solve(system, fmt, R):
    n, r, c, v = SYSTEMS[system]()
    a = container(fmt, n, r, c, v)
    B = block(n, E.MULTI_RHS_MAX)[:, :R]  # the columns every width shares
    X, ks, res = solve.cg(a, B, tol=TOL, maxiter=500)
    assert isinstance(X, torch.Tensor) and X.dtype == torch.float32 and X.shape == (n, R)
    assert len(ks) == len(res) == R
    assert all(isinstance(k, int) and 0 < k < 500 for k in ks)
    assert all(isinstance(x, float) for x in res)
    for j in range(R):
        x_ref, _ = column_solve(system, "float64", j)
        assert rel(X[:, j], x_ref) < 1e-4, (j, rel(X[:, j], x_ref))
        x1, k1 = column_solve(system, fmt, j)
        assert abs(ks[j] - k1) <= 1, (j, ks[j], k1)
        assert rel(X[:, j], x1) < 1e-4
        assert res[j] <= TOL * np.linalg.norm(B[:, j]) * (1 + 1e-5)


@pytest.mark.parametrize("mode", ["eager", "graph"])
@pytest.mark.parametrize("fmt", ["csr", "sell", "sym"])
def test_a_zero_column_and_a_solved_one_stay_frozen(request, mode, fmt):
    """A zero b_j and a column whose x0 already solves it are inactive from
    the start: k_j = 0 and their x, and residual, keep their bits, while
    the other columns run to their own stops."""
    if mode == "graph":
        request.getfixturevalue("cpu_graph")
    n, r, c, v = stencil(6)
    a = container(fmt, n, r, c, v)
    B = block(n, 4, seed=11)
    B[:, 1] = 0
    A = np.zeros((n, n))
    A[r, c] = v
    X0 = np.zeros((n, 4), np.float32)
    X0[:, 3] = np.linalg.solve(A, B[:, 3].astype(np.float64))  # solved, to float32
    for _ in range(3 if mode == "graph" else 1):  # eager, capture, replay
        X, ks, res = solve.cg(a, B, x0=X0, tol=1e-5, maxiter=500)
        assert ks[1] == ks[3] == 0 and ks[0] > 0 and ks[2] > 0, ks
        assert torch.equal(X[:, 1], torch.zeros(n)) and res[1] == 0.0
        assert torch.equal(X[:, 3], torch.from_numpy(X0[:, 3]))
    op = reference(n, r, c, v)
    for j in (0, 2):
        x_ref, _ = plain.cg(op, torch.from_numpy(B[:, j]).double(), tol=1e-5, maxiter=500)
        assert rel(X[:, j], x_ref) < 1e-3


@pytest.mark.parametrize("fmt", ["csr", "hyb"])
def test_x0_as_a_block(fmt):
    """x0 of shape (n, R) starts each column where its own x0 says: each
    column is the vector solve from that column's x0."""
    n, r, c, v = stencil(6)
    a = container(fmt, n, r, c, v)
    B = block(n, 3, seed=5)
    X0 = np.random.default_rng(6).standard_normal((n, 3)).astype(np.float32)
    X, ks, res = solve.cg(a, torch.from_numpy(B), x0=torch.from_numpy(X0), tol=TOL)
    for j in range(3):
        x1, k1, _ = solve.cg(a, B[:, j], x0=X0[:, j], tol=TOL)
        assert abs(ks[j] - k1) <= 1 and rel(X[:, j], x1) < 1e-4
    zero_start = solve.cg(a, B, tol=TOL)
    assert not torch.equal(zero_start[0], X)


def test_an_n_by_1_b_is_a_vector_solve():
    """b of shape (n, 1) keeps the vector solve (flattened), as before."""
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    b = block(n, 1)
    x, k, res = solve.cg(a, b, tol=TOL)
    assert x.shape == (n,) and isinstance(k, int)
    x1, k1, res1 = solve.cg(a, b[:, 0], tol=TOL)
    assert torch.equal(x, x1) and (k, res) == (k1, res1)


@pytest.mark.parametrize("R", [0, E.MULTI_RHS_MAX + 1, 16])
def test_a_block_outside_2_to_8_columns_is_refused(R):
    n, r, c, v = stencil(4)
    a = container("csr", n, r, c, v)
    with pytest.raises(ValueError, match=f"MULTI_RHS_MAX = {E.MULTI_RHS_MAX}"):
        solve.cg(a, np.ones((n, R), np.float32))


def test_a_block_x0_of_another_shape_is_refused():
    n, r, c, v = stencil(4)
    a = container("csr", n, r, c, v)
    with pytest.raises(ValueError, match="x0 has shape"):
        solve.cg(a, np.ones((n, 3), np.float32), x0=np.zeros((n, 2), np.float32))
    with pytest.raises(ValueError, match="x0 has shape"):
        solve.cg(a, np.ones((n, 3), np.float32), x0=np.zeros(n, np.float32))


def test_a_sharded_container_refuses_a_block():
    from spmv_tpu_torch.dist import mesh as M
    from spmv_tpu_torch.dist.sharded import ColShardedSpmv, RowShardedSpmv

    n, r, c, v = stencil(4)
    mesh = M.Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    for cls in (RowShardedSpmv, ColShardedSpmv):
        a = cls("csr", n, n, r, c, v, mesh)
        with pytest.raises(TypeError, match="one vector at a time"):
            solve.cg(a, np.ones((n, 2), np.float32))


def test_x2matrix_and_bsr_refuse_a_block():
    n, r, c, v = stencil(4)
    x2 = spmv_tpu_torch.X2Matrix.from_coo("csr", n, n, r, c, v, device="cpu")
    with pytest.raises(TypeError, match="X2Matrix"):
        solve.cg(x2, np.ones((n, 2), np.float32))
    bsr = spmv_tpu_torch.from_coo("bsr", n, n, r, c, v, device="cpu")
    with pytest.raises(TypeError):
        solve.cg(bsr, np.ones((n, 2), np.float32))


def test_bicgstab_and_power_iteration_take_no_block():
    n, r, c, v = stencil(4)
    a = container("csr", n, r, c, v)
    with pytest.raises(ValueError, match="bicgstab solves one right-hand side"):
        solve.bicgstab(a, np.ones((n, 2), np.float32))
    # power iteration draws its start vector from its seed: there is none
    # to give, so a block is refused as any unknown argument is
    with pytest.raises(TypeError):
        solve.power_iteration(a, iters=3, v0=np.ones((n, 2), np.float32))


def stopping_apart(n, R, seed):
    """A block whose columns stop at different iterations: column 0 is
    zero (no iteration), the others random."""
    B = block(n, R, seed=seed)
    B[:, 0] = 0
    return B


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_the_block_graph_loop_gives_the_eager_bits(cpu_graph, monkeypatch, chunk):
    """The block's loop follows the vector loop's rule under its own key:
    the first solve eager, the second captures, later ones replay; every
    one gives the eager loop's X, ks and residuals bit for bit, one host
    read per replay and one before."""
    monkeypatch.setattr(solve, "GRAPH_CHUNK", chunk)
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    B = stopping_apart(n, 4, seed=9)
    eager = solve.cg(a, B, tol=TOL, _graph=False)
    assert not hasattr(a, "_graph_loops")
    first = solve.cg(a, B, tol=TOL)
    assert a._graph_loops == {"cg_rhs": (n, 4)}  # seen at R = 4, not captured
    for _ in range(2):
        X, ks, res = solve.cg(a, B, tol=TOL)
        assert torch.equal(X, eager[0]) and (ks, res) == eager[1:]
    assert torch.equal(first[0], eager[0]) and first[1:] == eager[1:]
    assert ks[0] == 0 and max(ks) > 0
    loop = a._graph_loops["cg_rhs"]
    assert (loop.chunk, loop.replays, loop.host_reads) == (
        chunk, math.ceil(max(ks) / chunk), math.ceil(max(ks) / chunk) + 1)


def test_a_later_block_solve_reuses_the_loop_with_its_own_inputs(cpu_graph):
    """One loop serves every b, x0, tol and maxiter of its width, with the
    eager loop's bits; an X it returned before stays as it was."""
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    B = stopping_apart(n, 4, seed=9)
    solve.cg(a, B, tol=TOL)  # eager: the first solve
    first = solve.cg(a, B, tol=TOL)
    kept = first[0].clone()
    loop = a._graph_loops["cg_rhs"]
    B2 = block(n, 4, seed=10)
    for kw in ({"tol": 1e-4}, {"x0": block(n, 4, seed=12)}, {"maxiter": 5}):
        again = solve.cg(a, B2, **{"tol": TOL, **kw})
        plain_loop = solve.cg(a, B2, _graph=False, **{"tol": TOL, **kw})
        assert torch.equal(again[0], plain_loop[0]) and again[1:] == plain_loop[1:]
    assert again[1] == [5, 5, 5, 5]  # the last maxiter stopped every column
    assert torch.equal(first[0], kept)
    assert a._graph_loops == {"cg_rhs": loop}


def test_another_width_replaces_the_block_loop_and_not_the_vector_one(cpu_graph):
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    b = block(n, 1)[:, 0]
    for _ in range(2):
        solve.cg(a, b, tol=TOL)
        solve.cg(a, block(n, 4), tol=TOL)
    vector, four = a._graph_loops["cg"], a._graph_loops["cg_rhs"]
    assert isinstance(vector, solve._GraphLoop) and isinstance(four, solve._GraphLoop)
    B2 = block(n, 2)
    eager = solve.cg(a, B2, tol=TOL, _graph=False)
    got = solve.cg(a, B2, tol=TOL)  # R = 2 seen once: eager, the R = 4 loop dropped
    assert a._graph_loops == {"cg": vector, "cg_rhs": (n, 2)}
    got = solve.cg(a, B2, tol=TOL)  # captured at R = 2
    two = a._graph_loops["cg_rhs"]
    assert two is not four and two.state[0].shape == (n, 2)
    assert torch.equal(got[0], eager[0]) and got[1:] == eager[1:]
    assert a._graph_loops["cg"] is vector
    solve.cg(a, b, tol=TOL)
    assert a._graph_loops == {"cg": vector, "cg_rhs": two}


def root_span():
    roots = [s for s in trace.spans() if s.name == "solve.cg"]
    assert len(roots) == 1
    return roots[0]


@pytest.mark.parametrize("graph", [False, True])
def test_the_spans_count_columns_and_their_iterations(request, graph):
    """The root span of a block solve counts ``rhs``, the loop's
    ``iterations`` (the slowest column's), ``column_iterations`` (Σ k_j)
    and ``spmvs`` (R0's SpMM and every masked body run); a vector solve
    counts ``rhs`` 1."""
    if graph:
        request.getfixturevalue("cpu_graph")
    n, r, c, v = stencil(6)
    a = container("csr", n, r, c, v)
    B = stopping_apart(n, 3, seed=4)
    runs = ("eager", "capture", "replay") if graph else ("eager",)
    try:
        for mode in runs:
            trace.clear()
            trace.enable()
            X, ks, res = solve.cg(a, B, tol=TOL)
            trace.disable()
            s = root_span()
            assert s.counts["mode"] == mode and s.counts["rhs"] == 3
            assert s.counts["iterations"] == max(ks) and ks[0] == 0
            assert s.counts["column_iterations"] == sum(ks)
            if mode == "eager":
                assert s.counts["spmvs"] == max(ks) + 1
                assert s.counts["host_reads"] == max(ks) + 1
            else:
                loop = a._graph_loops["cg_rhs"]
                assert s.counts["spmvs"] == 1 + loop.replays * loop.chunk
                assert s.counts["replays"] == loop.replays == math.ceil(max(ks) / loop.chunk)
        trace.clear()
        trace.enable()
        _, k, _ = solve.cg(a, B[:, 0], tol=TOL)
        trace.disable()
        s = root_span()
        assert s.counts["rhs"] == 1 and "column_iterations" not in s.counts
        assert s.counts["iterations"] == k
    finally:
        trace.disable()
        trace.clear()


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def launches() -> int:
    return sum(E.LAUNCHES.values())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["csr", "sym", "sell"])
def test_the_block_graph_loop_on_the_card_is_the_eager_bits(cuda, fmt):
    n, r, c, v = stencil(16)
    a = container(fmt, n, r, c, v, device=cuda)
    for R in (4, 2):  # each width: eager, capture, replay
        B = torch.from_numpy(stopping_apart(n, R, seed=R)).to(cuda)
        X0, k0, res0 = solve.cg(a, B, tol=TOL, _graph=False)
        for _ in range(3):
            X, ks, res = solve.cg(a, B, tol=TOL)
            assert torch.equal(X, X0) and ks == k0 and res == res0, (ks, k0)
        loop = a._graph_loops["cg_rhs"]
        assert loop.state[0].shape == (n, R) and loop.replays == math.ceil(max(ks) / loop.chunk)
        assert ks[0] == 0 and 0 < max(ks) < 1000
    op = reference(n, r, c, v)
    for j in range(1, B.shape[1]):
        x_ref, _ = plain.cg(op, B[:, j].cpu().double(), tol=TOL, maxiter=1000)
        assert rel(X[:, j].cpu(), x_ref) < 1e-4


@pytest.mark.gpu
def test_a_second_width_on_the_card_leaves_the_vector_loop(cuda):
    n, r, c, v = stencil(16)
    a = container("csr", n, r, c, v, device=cuda)
    b = torch.from_numpy(block(n, 1)[:, 0]).to(cuda)
    for _ in range(2):
        solve.cg(a, b, tol=TOL)
        solve.cg(a, torch.from_numpy(block(n, 4)).to(cuda), tol=TOL)
    vector, four = a._graph_loops["cg"], a._graph_loops["cg_rhs"]
    B2 = torch.from_numpy(block(n, 8)).to(cuda)
    for _ in range(2):
        got = solve.cg(a, B2, tol=TOL)
    assert a._graph_loops["cg"] is vector and a._graph_loops["cg_rhs"] is not four
    assert a._graph_loops["cg_rhs"].state[0].shape == (n, 8)
    eager = solve.cg(a, B2, tol=TOL, _graph=False)
    assert torch.equal(got[0], eager[0]) and got[1:] == eager[1:]
    x, k, res = solve.cg(a, b, tol=TOL)
    assert a._graph_loops["cg"] is vector and k > 0


@pytest.mark.gpu
def test_a_vector_solve_keeps_its_launches_and_bits(cuda):
    """A vector solve runs the vector loop alone: its eager solve launches
    one ``matvec``'s kernels per iteration and r0's, its capture one
    chunk's and r0's, its replay r0's alone, no K8; the graph's x, k and
    residual are the eager loop's bits."""
    n, r, c, v = stencil(16)
    a = container("csr", n, r, c, v, device=cuda)
    b = torch.from_numpy(block(n, 1)[:, 0]).to(cuda)
    before = launches()
    a.matvec(b)
    per = launches() - before
    assert per > 0
    x0, k0, res0 = solve.cg(a, b, tol=TOL, _graph=False)
    counts = []
    for _ in range(3):  # eager, capture, replay
        before, k8 = launches(), E.LAUNCHES["seg_spmm_tiles"]
        x, k, res = solve.cg(a, b, tol=TOL)
        counts.append(launches() - before)
        assert E.LAUNCHES["seg_spmm_tiles"] == k8
        assert torch.equal(x, x0) and (k, res) == (k0, res0)
    assert counts == [(k0 + 1) * per, (solve.GRAPH_CHUNK + 2) * per, per]
    assert set(a._graph_loops) == {"cg"}


@pytest.mark.gpu
def test_the_block_spans_on_the_card(cuda):
    n, r, c, v = stencil(16)
    a = container("csr", n, r, c, v, device=cuda)
    B = torch.from_numpy(stopping_apart(n, 4, seed=2)).to(cuda)
    try:
        for mode in ("eager", "capture", "replay"):
            trace.clear()
            trace.enable()
            X, ks, res = solve.cg(a, B, tol=TOL)
            trace.disable()
            s = root_span()
            assert s.counts["mode"] == mode and s.counts["rhs"] == 4
            assert ks[0] == 0 and max(ks) > 0
            assert s.counts["iterations"] == max(ks)
            assert s.counts["column_iterations"] == sum(ks)
            if mode == "eager":
                assert s.counts["spmvs"] == max(ks) + 1
            else:
                loop = a._graph_loops["cg_rhs"]
                assert s.counts["spmvs"] == 1 + loop.replays * loop.chunk
    finally:
        trace.disable()
        trace.clear()

"""The port's symmetric container (``spmv_tpu_torch.sym``) against the JAX
package's ``SymmetricMatrix`` and the fp64 oracle on the expanded
triplets, on the CPU (the port's plain versions; JAX in interpret mode, as
``tests/test_sym.py`` runs it).

Tolerance: each y within its own engine's bound of the oracle on the
expanded matrix, and port against JAX within the sum of both bounds
(ROADMAP.md, queue C's rule): the port's ``1e-5 + fp32_rel_tol(k)·Σ|v||x|``
(k the longest expanded row; the two passes and their add stay inside it)
and JAX's ``1e-5 + engine_rel_tol(k)·container_scale``, which adds the
127-slot window magnitudes of both of its plans."""

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu.sym import SymmetricMatrix as RefSym
from spmv_tpu_torch import SymmetricMatrix, synth
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.oracle import KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv, row_scale


def triangle(n=300, seed=3, nnz_row=12, band=60):
    """Lower triangle of a symmetrized FEM-proxy matrix (test_sym.py's)."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=nnz_row,
                                         bandwidth=band, seed=seed)
    keep = r >= c
    return n, r[keep], c[keep], v[keep]


def expand(r, c, v):
    s = r > c
    return (np.concatenate([r, c[s]]), np.concatenate([c, r[s]]),
            np.concatenate([v, v[s]]))


def diagonal(n=40):
    d = np.arange(n)
    return n, d, d, np.linspace(1, 2, n)


def edge_triangle(name):
    info, r, c, v = synth.edge_case(name)
    keep = r >= c
    return info.nrows, r[keep], c[keep], v[keep]


SQUARE_EDGES = sorted(n for n in synth.EDGE_CASES
                      if synth.edge_case(n)[0].nrows == synth.edge_case(n)[0].ncols)

TRIANGLES = {
    "cant_300": lambda: triangle(),
    "cant_500_wide": lambda: triangle(n=500, seed=5, nnz_row=20, band=200),
    "diagonal_only": diagonal,
    "empty": lambda: (5, np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)),
    "one_row": lambda: (1, np.array([0]), np.array([0]), np.array([2.5])),
    **{f"edge_{n}": (lambda n=n: edge_triangle(n)) for n in SQUARE_EDGES},
}


def bounds(n, r, c, v, x, ref):
    """(port bound, JAX bound) per row of y = A·x on the expanded matrix."""
    er, ec, ev = expand(r, c, v)
    k = int(np.bincount(er, minlength=max(n, 1)).max()) if er.size else 1
    row_abs = row_scale(n, er, ec, ev, x)
    return (KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs,
            KERNEL_TOL_ABS + engine_rel_tol(k) * container_scale(ref, x, row_abs))


@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
@pytest.mark.parametrize("name", sorted(TRIANGLES))
def test_matvec_matches_jax_and_the_expanded_oracle(name, upper):
    n, r, c, v = TRIANGLES[name]()
    if upper:  # given as the upper triangle: both fold it onto the lower
        r, c = c, r
    ref = RefSym.from_coo(n, n, r, c, v)
    a = spmv_tpu_torch.from_coo("sym", n, n, r, c, v, device="cpu")
    assert isinstance(a, SymmetricMatrix)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y, y_jax = a.matvec(x), np.asarray(ref.matvec(x), np.float64)
    assert y.dtype == torch.float32 and y.shape == (n,)
    lo, hi = (r, c) if not upper else (c, r)
    expected = golden_spmv(n, *expand(lo, hi, v), x)
    port_bound, jax_bound = bounds(n, lo, hi, v, x, ref)
    y = y.numpy().astype(np.float64)
    assert (np.abs(y - expected) <= port_bound).all()
    assert (np.abs(y_jax - expected) <= jax_bound).all()
    assert (np.abs(y - y_jax) <= port_bound + jax_bound).all()
    assert (a.nnz, a.stored_nnz, a.spill_nnz) == (ref.nnz, ref.stored_nnz, ref.spill_nnz)
    for mine, theirs in zip((a.tri_rows, a.tri_cols, a.tri_vals),
                            (ref.tri_rows, ref.tri_cols, ref.tri_vals)):
        assert np.array_equal(mine, theirs)


@pytest.mark.parametrize("R", [1, 2, 4, 8, 9])
@pytest.mark.parametrize("name", ["cant_300", "diagonal_only", "edge_dense_small"])
def test_spmm_matches_jax_and_the_expanded_oracle(name, R):
    """R = 2..8 runs K8 + K9 on both plans (plain versions here) then one
    add, as JAX's ``_spmm_fused`` takes the transpose as a second part;
    R = 1 and 9 run one ``matvec`` per column, as JAX does."""
    n, r, c, v = TRIANGLES[name]()
    ref = RefSym.from_coo(n, n, r, c, v)
    a = spmv_tpu_torch.from_coo("sym", n, n, r, c, v, device="cpu")
    X = np.random.default_rng(R).standard_normal((n, R)).astype(np.float32)
    Y, Y_jax = spmv_tpu_torch.spmm(a, X), np.asarray(spmv_tpu.spmm(ref, X), np.float64)
    assert Y.shape == (n, R) and Y.dtype == torch.float32
    for j in range(R):
        port_bound, jax_bound = bounds(n, r, c, v, X[:, j], ref)
        expected = golden_spmv(n, *expand(r, c, v), X[:, j])
        y = Y[:, j].numpy().astype(np.float64)
        assert (np.abs(y - expected) <= port_bound).all()
        assert (np.abs(y - Y_jax[:, j]) <= port_bound + jax_bound).all()


def test_matmat_runs_the_multi_rhs_engine_on_both_plans(monkeypatch):
    n, r, c, v = triangle()
    a = SymmetricMatrix.from_coo(n, n, r, c, v, device="cpu")
    seen = []
    real = E.segmented_spmv_multi
    import spmv_tpu_torch.sym as S

    monkeypatch.setattr(S, "segmented_spmv_multi",
                        lambda dev, X: seen.append(dev) or real(dev, X))
    spmv_tpu_torch.spmm(a, np.ones((n, 4), np.float32))
    assert seen == [a.dev, a.dev_spill]


def test_diagonal_only_skips_the_transpose_pass(monkeypatch):
    n, r, c, v = diagonal()
    a = SymmetricMatrix.from_coo(n, n, r, c, v, device="cpu")
    assert a.spill_nnz == 0 and a.dev_spill.nnz == 0
    seen = []
    import spmv_tpu_torch.sym as S

    real = S.segmented_spmv
    monkeypatch.setattr(S, "segmented_spmv",
                        lambda dev, x: seen.append(dev) or real(dev, x))
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(a.matvec(x).numpy(), np.linspace(1, 2, n) * x, rtol=1e-6)
    assert seen == [a.dev]


def test_plans_are_lower_plus_diagonal_and_the_swapped_strict_triangle():
    n, r, c, v = triangle(n=200, seed=9)
    a = SymmetricMatrix.from_coo(n, n, c, r, v, device="cpu")  # upper given
    assert (a.tri_rows >= a.tri_cols).all()
    lower = spmv_tpu_torch.from_coo("csr", n, n, r, c, v, device="cpu")
    strict = r > c
    upper = spmv_tpu_torch.from_coo("csr", n, n, c[strict], r[strict], v[strict],
                                    device="cpu")
    for mine, csr in ((a.plan, lower.plan), (a.spill_plan, upper.plan)):
        for f in ("ptr", "cols", "vals", "tile_row0", "carry_rows"):
            assert np.array_equal(getattr(mine, f), getattr(csr, f))
    assert a.stream_bytes == lower.stream_bytes + upper.stream_bytes


def test_to_coo_expands_and_returns_fresh_copies():
    n, r, c, v = triangle(n=300, seed=7)
    a = SymmetricMatrix.from_coo(n, n, r, c, v, device="cpu")
    ref = RefSym.from_coo(n, n, r, c, v)
    for mine, theirs in zip(a.to_coo(), ref.to_coo()):
        assert np.array_equal(mine, theirs)
    rows, cols, vals = a.to_coo()
    A = np.zeros((n, n))
    A[rows, cols] = vals
    assert (A == A.T).all()
    rows[:] = -1
    vals[:] = 0
    assert (a.to_coo()[0] >= 0).all() and (a.tri_rows >= 0).all()


def test_refuses_a_rectangular_matrix_as_jax_does():
    with pytest.raises(ValueError) as ref:
        RefSym.from_coo(4, 6, [0], [0], [1.0])
    with pytest.raises(ValueError) as mine:
        spmv_tpu_torch.from_coo("sym", 4, 6, [0], [0], [1.0], device="cpu")
    assert str(mine.value) == str(ref.value) == "symmetric storage requires a square matrix"


def test_from_reference_carries_the_stored_triangle():
    n, r, c, v = triangle(n=250, seed=11)
    ref = spmv_tpu.from_coo("sym", n, n, c, r, v)
    a = spmv_tpu_torch.from_reference(ref, device="cpu")
    assert isinstance(a, SymmetricMatrix)
    assert (a.nrows, a.stored_nnz, a.nnz) == (ref.nrows, ref.stored_nnz, ref.nnz)
    for mine, theirs in zip((a.tri_rows, a.tri_cols, a.tri_vals),
                            (ref.tri_rows, ref.tri_cols, ref.tri_vals)):
        assert np.array_equal(mine, theirs)
        assert not np.shares_memory(mine, theirs)


def test_load_of_a_missing_file_folds_the_synthesized_matrix_like_jax(tmp_path):
    """The synthesized cant proxy is not symmetric; ``load(…, "sym")`` reads
    it as a stored triangle and folds its upper entries (ROADMAP.md queue C
    keeps this for parity), in both packages."""
    path = str(tmp_path / "cant.mtx")
    a = spmv_tpu_torch.load(path, "sym", device="cpu", synth=dict(n=512, seed=1))
    ref = spmv_tpu.load(path, "sym", synth=dict(n=512, seed=1))
    for mine, theirs in zip((a.tri_rows, a.tri_cols, a.tri_vals),
                            (ref.tri_rows, ref.tri_cols, ref.tri_vals)):
        assert np.array_equal(mine, theirs)
    x = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    r, c, v = a.tri_rows, a.tri_cols, a.tri_vals
    port_bound, jax_bound = bounds(512, r, c, v, x, ref)
    assert (np.abs(a.matvec(x).numpy() - np.asarray(ref.matvec(x)))
            <= port_bound + jax_bound).all()


def test_load_reads_a_symmetric_file_unexpanded(tmp_path):
    path = tmp_path / "s.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                    "4 4 5\n1 1 2.0\n2 1 -1.5\n3 2 4.25\n4 4 1e-3\n4 1 7\n")
    a = spmv_tpu_torch.load(str(path), "sym", device="cpu")
    ref = spmv_tpu.load(str(path), "sym")
    assert a.stored_nnz == ref.stored_nnz == 5 and a.nnz == ref.nnz == 8
    csr = spmv_tpu_torch.load(str(path), "csr", device="cpu")  # expanded
    x = np.arange(4, dtype=np.float32)
    np.testing.assert_allclose(a.matvec(x).numpy(), csr.matvec(x).numpy(), rtol=1e-6)


def test_sym_stays_out_of_f32x2_and_the_cli_as_in_jax(capsys):
    from spmv_tpu import cli as ref_cli
    from spmv_tpu_torch import cli

    assert "sym" not in spmv_tpu_torch.X2_FORMATS
    assert "sym" not in cli.FORMATS and "sym" not in cli.SOLVE_FORMATS
    with pytest.raises(ValueError, match="f32x2 supports"):
        spmv_tpu_torch.X2Matrix.from_coo("sym", 3, 3, [0], [0], [1.0], device="cpu")
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["run", "--format", "sym"])
        assert e.value.code == 2
    capsys.readouterr()

"""The PyTorch port's ``spmm`` (Y = A·X) and its BSR container against the
JAX package, on the same seeded triplets and X.

JAX runs as its own tests run it (Pallas interpret mode on the CPU); the
port's wrappers get CPU tensors and run their plain PyTorch versions (the
CUDA kernels K8-K11 are held against those on the card,
``test_torch_gpu.py``). Every column of Y is held to the bound of
``test_torch_formats.py`` for one SpMV: against the fp64 oracle by the
port's ``kernel_check``, and against JAX's column within the sum of both
engines' tolerances.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.formats.bsr import BSRMatrix as JaxBSR
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu_torch import cli, synth
from spmv_tpu_torch.device import DevCsr, DevPanel, X_to_device, Y_to_numpy
from spmv_tpu_torch.errors import ReturnCode
from spmv_tpu_torch.formats import split as S
from spmv_tpu_torch.formats.base import (TILE_COLS, TILE_NNZ, build_csr_plan,
                                         build_panel_plan, csr_ptr)
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)
from spmv_tpu_torch.probes.common import PANEL_SHAPES, TILE_SHAPES
from test_torch_panel import CASES, row_ordered

EXAMPLE_MTX = str(Path(__file__).resolve().parents[1] / "databases" / "example.mtx")

# bench.py's pure-panel builds: the format and its construction arguments
VARIANTS = {"ell_pure": ("ell", {"split": False}),
            "sell_pure": ("sell", {"split": False})}
# R = 2 over every container (and the pure panels, since this matrix
# spills everything under the split); R = MULTI_RHS_MAX on one format of
# each engine, as tests/test_spmm.py:79-83 does
JAX_CASES = ([(2, f) for f in ("csr", "coo", "cmrs", "ell", "sell", "hyb",
                               "ell_pure", "sell_pure")]
             + [(8, "csr"), (8, "ell")])


@functools.cache
def power_law():
    return synth.power_law(n=2048, avg_nnz_per_row=12, bandwidth=256, seed=2)


def make(fmt, info, r, c, v, jax=False):
    name, kwargs = VARIANTS.get(fmt, (fmt, {}))
    if jax:
        return spmv_tpu.from_coo(name, info.nrows, info.ncols, r, c, v, **kwargs)
    return spmv_tpu_torch.from_coo(name, info.nrows, info.ncols, r, c, v,
                                   device="cpu", **kwargs)


def max_row(nrows, r):
    return int(np.bincount(r, minlength=max(nrows, 1)).max()) if r.size else 1


def check_columns(Y, Y_jax, a_jax, info, r, c, v, X):
    """Every column against the oracle, and against JAX's within the sum of
    both tolerances (``test_torch_formats.py:165-169``)."""
    k = max_row(info.nrows, r)
    for j in range(X.shape[1]):
        x = X[:, j]
        row_abs = row_scale(info.nrows, r, c, v, x)
        expected = golden_spmv(info.nrows, r, c, v, x)
        rep = kernel_check(expected, Y[:, j], row_abs, k)
        assert rep.ok, f"column {j}: {rep}"
        if Y_jax is not None:
            bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
                     + engine_rel_tol(k) * container_scale(a_jax, x, row_abs))
            assert (np.abs(Y[:, j].astype(np.float64) - Y_jax[:, j]) <= bound).all(), j


def count_calls(monkeypatch, module, names, calls=None):
    """Record the calls of ``module``'s functions ``names``, by name, in
    ``calls`` (a new list when None), and return it."""
    calls = [] if calls is None else calls
    for fn in names:
        orig = getattr(module, fn)
        monkeypatch.setattr(module, fn,
                            lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    return calls


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("R,fmt", JAX_CASES)
def test_spmm_matches_jax(R, fmt):
    info, r, c, v = power_law()
    X = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(np.float32)
    a_jax = make(fmt, info, r, c, v, jax=True)
    Y_jax = np.asarray(spmv_tpu.spmm(a_jax, X))
    a = make(fmt, info, r, c, v)
    Yt = spmv_tpu_torch.spmm(a, X)
    assert isinstance(Yt, torch.Tensor) and Yt.device.type == "cpu"
    assert Yt.dtype == torch.float32 and Yt.shape == (info.nrows, R)
    check_columns(Yt.numpy(), Y_jax, a_jax, info, r, c, v, X)


# K8's extreme tiles (csr) and K10's ownership and walk cases (ell, whole):
# the shapes the card's tests run the tile kernels on, here on their plain
# versions
SHAPE_CASES = ([("csr", n) for n in sorted(TILE_SHAPES)]
               + [("ell_pure", n) for n in sorted(PANEL_SHAPES)])


@pytest.mark.parametrize("R", [3, 4])
@pytest.mark.parametrize("fmt,shape", SHAPE_CASES)
def test_spmm_on_tile_and_panel_shapes_matches_jax(fmt, shape, R):
    """``spmm`` on each of ``TILE_SHAPES`` (csr) and ``PANEL_SHAPES`` (ell
    without the split), column by column against the fp64 oracle and
    against JAX's ``spmm`` (interpret mode) on the same triplets and X,
    within the sum of both engines' tolerances."""
    info, r, c, v = {**TILE_SHAPES, **PANEL_SHAPES}[shape]()
    X = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(np.float32)
    a_jax = make(fmt, info, r, c, v, jax=True)
    Y = spmv_tpu_torch.spmm(make(fmt, info, r, c, v), X)
    assert Y.shape == (info.nrows, R) and Y.dtype == torch.float32
    check_columns(Y.numpy(), np.asarray(spmv_tpu.spmm(a_jax, X)), a_jax, info, r, c,
                  v, X)


@pytest.mark.parametrize("fmt", ["ell", "sell", "hyb"])
def test_spmm_over_panel_and_spill_matches_jax(monkeypatch, fmt):
    """Both parts at once (the ``hyb`` shape, which the dispatch price keeps
    off small matrices): the panel's and the spill's Y add (in sorted row
    space for SELL) to JAX's and the oracle's, column by column."""
    monkeypatch.setattr(S, "_DISPATCH_S", 0.0)
    info, r, c, v = synth.power_law(n=2048, seed=7)
    a = make(fmt, info, r, c, v)
    assert a.shape == "hyb" and a.panel_nnz and a.spill_nnz
    calls = count_calls(monkeypatch, E, ["segmented_spmv_multi_partials"])
    count_calls(monkeypatch, P, ["panel_spmv_multi_partials"], calls)
    X = np.random.default_rng(9).standard_normal((info.ncols, 3)).astype(np.float32)
    Y = spmv_tpu_torch.spmm(a, X).numpy()
    assert sorted(calls) == ["panel_spmv_multi_partials",
                             "segmented_spmv_multi_partials"]
    a_jax = make(fmt, info, r, c, v, jax=True)
    check_columns(Y, np.asarray(spmv_tpu.spmm(a_jax, X)), a_jax, info, r, c, v, X)


# ---------------------------------------------------------------- the envelope


@pytest.mark.parametrize("R", [1, 2, 8, 9])
@pytest.mark.parametrize("fmt", ["csr", "sell_pure"])
def test_multi_path_only_inside_the_envelope(monkeypatch, fmt, R):
    """2 ≤ R ≤ MULTI_RHS_MAX runs one multi-RHS pass; R = 1 and R = 9 run
    one ``matvec`` per column, and never reach the multi wrappers."""
    assert E.MULTI_RHS_MAX == 8
    info, r, c, v = CASES["band_1024"]()
    a = make(fmt, info, r, c, v)
    multi = count_calls(monkeypatch, E, ["segmented_spmv_multi_partials"])
    count_calls(monkeypatch, P, ["panel_spmv_multi_partials"], multi)
    single = count_calls(monkeypatch, type(a), ["matvec"])
    X = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(np.float32)
    Y = spmv_tpu_torch.spmm(a, X).numpy()
    if 2 <= R <= E.MULTI_RHS_MAX:
        assert len(multi) == 1 and not single
    else:
        assert not multi and len(single) == R
    check_columns(Y, None, None, info, r, c, v, X)


# ---------------------------------------------------------------- plain kernels


def csr_dev(trip, tile):
    info, r, c, v = row_ordered(trip)
    return DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols,
                                           csr_ptr(r, info.nrows), c, v,
                                           tile=tile), "cpu")


def panel_dev(trip, tile):
    info, r, c, v = row_ordered(trip)
    return DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                               tile=tile), "cpu")


def columns_of(X):
    return [X[:, j].contiguous() for j in range(X.shape[1])]


@pytest.mark.parametrize("tile", [TILE_NNZ, 3, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k8_k9_are_k1_k2_per_column(case, tile):
    """Plain K8 and K9 give, column by column, what plain K1 and K2 give
    for that column alone — the partials, the carries and Y, bit for bit."""
    trip = CASES[case]()
    dev = csr_dev(trip, tile)
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (trip[0].ncols, 3)).astype(np.float32))
    before = dict(E.LAUNCHES)
    Y, carry = E.segmented_spmv_multi_partials(dev, X)
    assert Y.shape == (dev.nrows, 3) and carry.shape == (2 * dev.ntiles, 3)
    for j, x in enumerate(columns_of(X)):
        y1, c1 = E.segmented_spmv_partials_reference(dev, x)
        assert torch.equal(Y[:, j], y1) and torch.equal(carry[:, j], c1)
    Y = E.carry_fixup_multi(dev, Y, carry)
    assert E.LAUNCHES == before  # CPU tensors: the plain versions ran
    for j, x in enumerate(columns_of(X)):
        assert torch.equal(Y[:, j], E.carry_fixup_reference(
            dev, *E.segmented_spmv_partials_reference(dev, x)))
    info, r, c, v = trip
    check_columns(Y.numpy(), None, None, info, r, c, v.astype(np.float32), X.numpy())


@pytest.mark.parametrize("tile", [TILE_COLS, 3, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k10_k11_are_k4_k5_per_column(case, tile):
    """Plain K10 and K11 give, column by column, what plain K4 and K5 give
    for that column alone, bit for bit."""
    trip = CASES[case]()
    dev = panel_dev(trip, tile)
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (trip[0].ncols, 5)).astype(np.float32))
    before = dict(E.LAUNCHES)
    Y, part = P.panel_spmv_multi_partials(dev, X)
    assert Y.shape == (dev.nrows, 5) and part.shape == (2 * dev.ntiles, 32, 5)
    for j, x in enumerate(columns_of(X)):
        y4, p4 = P.panel_spmv_partials_reference(dev, x)
        assert torch.equal(Y[:, j], y4) and torch.equal(part[..., j], p4)
    Y = P.panel_fixup_multi(dev, Y, part)
    assert E.LAUNCHES == before
    for j, x in enumerate(columns_of(X)):
        assert torch.equal(Y[:, j], P.panel_fixup_reference(
            dev, *P.panel_spmv_partials_reference(dev, x)))
    info, r, c, v = trip
    check_columns(Y.numpy(), None, None, info, r, c, v.astype(np.float32), X.numpy())


def test_inverse_permute_gathers_rows_of_R():
    info, r, c, v = CASES["power_law_2048"]()
    a = make("sell_pure", info, r, c, v)
    assert a.sorted_rows
    Ys = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (a.invperm_dev.numel(), 4)).astype(np.float32))
    Y = P.inverse_permute(a.invperm_dev, Ys, info.nrows)
    assert Y.shape == (info.nrows, 4)
    for j in range(4):
        assert torch.equal(Y[:, j], P.inverse_permute(
            a.invperm_dev, Ys[:, j].contiguous(), info.nrows))
    with pytest.raises(ValueError, match="do not match"):
        P.inverse_permute(a.invperm_dev, Ys[:-1], info.nrows)


def test_wrappers_refuse_mismatched_inputs():
    trip = CASES["edge_ragged"]()
    dev, pdev = csr_dev(trip, TILE_NNZ), panel_dev(trip, TILE_COLS)
    n = dev.ncols
    for d, fn in ((dev, E.segmented_spmv_multi_partials),
                  (pdev, P.panel_spmv_multi_partials)):
        with pytest.raises(ValueError, match="X must be"):
            fn(d, torch.ones(n + 1, 2))
        with pytest.raises(ValueError, match="X must be"):
            fn(d, torch.ones(n))
        for R in (1, E.MULTI_RHS_MAX + 1):
            with pytest.raises(ValueError, match="R ≤ 8"):
                fn(d, torch.ones(n, R))
        with pytest.raises(ValueError, match="float32"):
            fn(d, torch.ones(n, 2, dtype=torch.float64))
        with pytest.raises(ValueError, match="contiguous"):
            fn(d, torch.ones(2, n).t())
    Y, carry = E.segmented_spmv_multi_partials(dev, torch.ones(n, 2))
    with pytest.raises(ValueError, match="does not match"):
        E.carry_fixup_multi(dev, Y, carry[:, :1])
    Y, part = P.panel_spmv_multi_partials(pdev, torch.ones(n, 2))
    with pytest.raises(ValueError, match="does not match"):
        P.panel_fixup_multi(pdev, Y[:-1], part)


# ---------------------------------------------------------------- X and Y


def test_X_to_device_makes_row_major_float32():
    X = np.arange(24, dtype=np.float64).reshape(4, 6)
    for given in (X, np.asfortranarray(X), X.T.copy().T, torch.from_numpy(X)):
        Xt = X_to_device(given, 4, "cpu")
        assert Xt.dtype == torch.float32 and Xt.is_contiguous()
        assert Xt.shape == (4, 6) and (Xt.numpy() == X).all()
    sliced = X_to_device(X[:, 1::2], 4, "cpu")
    assert sliced.is_contiguous() and (sliced.numpy() == X[:, 1::2]).all()
    for bad in (X[:3], X[:, 0], X[None]):
        with pytest.raises(ValueError, match=r"X must be \(4, R\)"):
            X_to_device(bad, 4, "cpu")
    Y = torch.zeros(3, 2)
    assert Y_to_numpy(Y, 3, 2).shape == (3, 2)
    with pytest.raises(ValueError, match="Y must be"):
        Y_to_numpy(Y, 3, 3)


@pytest.mark.parametrize("fmt", ["csr", "sell", "bsr"])
def test_spmm_takes_any_layout_and_refuses_a_wrong_shape(fmt):
    info, r, c, v = CASES["random_500x300"]()
    a = make(fmt, info, r, c, v)
    X = np.random.default_rng(2).standard_normal((info.ncols, 8))
    ref = spmv_tpu_torch.spmm(a, X[:, 1::2])
    assert torch.equal(spmv_tpu_torch.spmm(a, np.asfortranarray(X)[:, 1::2]), ref)
    check_columns(ref.numpy(), None, None, info, r, c, v, X[:, 1::2])
    with pytest.raises(ValueError, match=rf"X must be \({info.ncols}, R\)"):
        spmv_tpu_torch.spmm(a, X[:-1])
    with pytest.raises(ValueError, match=rf"X must be \({info.ncols}, R\)"):
        spmv_tpu_torch.spmm(a, X[:, 0])


# ---------------------------------------------------------------- BSR


def dense_case(nrows=300, ncols=260, nnz=6000, seed=2):
    """tests/test_spmm.py's matrix: random triplets with duplicates."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, nrows, nnz)
    c = rng.integers(0, ncols, nnz)
    v = rng.standard_normal(nnz)
    A = np.zeros((nrows, ncols))
    np.add.at(A, (r, c), v)  # duplicates sum, like the format
    return r, c, v, A


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_bsr_from_reference_matches_jax_and_dense(precision):
    r, c, v, A = dense_case()
    ref = JaxBSR.from_coo(*A.shape, r, c, v, precision=precision)
    a = spmv_tpu_torch.from_reference(ref, device="cpu")
    assert isinstance(a, spmv_tpu_torch.BSRMatrix) and a.precision == precision
    # to_coo gives the operator (duplicates summed), so the port counts fewer
    # nonzeros than the input list; the tiles and their places are the same
    assert a.tiles.shape == np.asarray(ref.tiles).shape
    assert a.fill == pytest.approx(a.tiles.shape[0] * 128 * 128 / a.nnz)
    assert np.array_equal(a.tile_blk.numpy(), np.asarray(ref.tile_blk))
    assert np.array_equal(a.tile_stp.numpy(), np.asarray(ref.tile_stp))
    X = np.random.default_rng(1).standard_normal((A.shape[1], 16)).astype(np.float32)
    Y = a.matmat(X).numpy()
    assert torch.equal(a.matmat(X), a.matmat(X))  # a fixed order: same bits
    if precision == "highest":  # the JAX test's own tolerance
        np.testing.assert_allclose(Y, A @ X, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(Y, np.asarray(ref.matmat(X)), rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(np.asarray(a.tiles), np.asarray(ref.tiles))
    else:  # bf16 operands: each rounds by at most 2^-9 relative
        assert torch.equal(a.tiles, a.tiles.bfloat16().float())
        scale = np.abs(A) @ np.abs(X)
        assert (np.abs(Y - A @ X) <= 1e-5 + 2 * 2.0**-8 * scale).all()
        assert np.abs(Y - A @ X).max() > 1e-4  # it is not float32


def test_bsr_matvec_operator_and_api():
    r, c, v, A = dense_case(nnz=4000)
    a = spmv_tpu_torch.from_coo("bsr", *A.shape, r, c, v, device="cpu")
    x = np.random.default_rng(3).standard_normal(A.shape[1]).astype(np.float32)
    y = a.matvec(x)
    assert y.shape == (A.shape[0],) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(spmv_tpu_torch.spmv(a, x).numpy(), A @ x,
                               rtol=2e-4, atol=2e-4)
    assert (a @ x.reshape(-1, 1)).shape == (A.shape[0], 1)
    for R in (1, 5, 33):  # BSR takes every R through its one matmul
        X = np.random.default_rng(R).standard_normal((A.shape[1], R)).astype(np.float32)
        np.testing.assert_allclose(spmv_tpu_torch.spmm(a, X).numpy(), A @ X,
                                   rtol=2e-4, atol=2e-4)
    rows, cols, vals = a.to_coo()
    B2 = np.zeros_like(A)
    np.add.at(B2, (rows, cols), vals)
    np.testing.assert_allclose(B2, A, rtol=1e-6, atol=1e-6)
    assert a.stream_bytes == (a.tiles.numel() * 4 + 2 * 4 * a.tile_blk.numel()
                              + 8 * a.blk_tiles.numel())


def test_bsr_fill_guard_as_in_jax():
    n = 128 * 300  # one nonzero per diagonal tile: about 1.9 GB dense
    diag = np.arange(0, n, 128)
    with pytest.raises(ValueError, match="block density"):
        spmv_tpu_torch.BSRMatrix.from_coo(n, n, diag, diag, np.ones(diag.size),
                                          max_fill=64.0, device="cpu")
    # tiny matrices are admitted whatever their fill
    a = spmv_tpu_torch.BSRMatrix.from_coo(1000, 1000, [0, 400, 900], [0, 400, 900],
                                          [1.0, 1.0, 1.0], device="cpu")
    y = a.matvec(np.ones(1000, np.float32))
    assert y[0] == 1.0 and y[400] == 1.0 and y[900] == 1.0 and y.sum() == 3.0
    with pytest.raises(ValueError, match="precision"):
        spmv_tpu_torch.BSRMatrix.from_coo(3, 3, [0], [0], [1.0], precision="tf32",
                                          device="cpu")


def test_bsr_empty_matrix():
    a = spmv_tpu_torch.BSRMatrix.from_coo(10, 10, [], [], [], device="cpu")
    ref = JaxBSR.from_coo(10, 10, [], [], [])
    y = a.matvec(np.ones(10, np.float32))
    assert y.shape == (10,) and not y.any()
    assert np.asarray(ref.matvec(np.ones(10, np.float32))).shape == (10,)
    assert a.to_coo()[0].size == 0
    assert spmv_tpu_torch.spmm(a, np.ones((10, 3))).shape == (10, 3)


def test_bsr_matmul_runs_without_tf32_and_restores_the_setting(monkeypatch):
    """The product runs with float32 matmuls in full precision, and the
    caller's setting comes back afterwards (ROADMAP §C: TF32 left on reads
    as a ~1e-3 mismatch)."""
    m = torch.backends.cuda.matmul
    seen = []
    orig = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda *a: seen.append(
        m.fp32_precision if hasattr(m, "fp32_precision") else m.allow_tf32)
        or orig(*a))
    on = "tf32" if hasattr(m, "fp32_precision") else True
    r, c, v, A = dense_case(nnz=500)
    a = spmv_tpu_torch.from_coo("bsr", *A.shape, r, c, v, device="cpu")
    if hasattr(m, "fp32_precision"):
        monkeypatch.setattr(m, "fp32_precision", on)
    else:
        monkeypatch.setattr(m, "allow_tf32", on)
    a.matmat(np.ones((A.shape[1], 2)))
    assert seen == (["ieee"] if on == "tf32" else [False])
    assert (m.fp32_precision if hasattr(m, "fp32_precision") else m.allow_tf32) == on


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("fmt", ["csr", "ell", "sell", "hyb", "bsr"])
def test_run_rhs_on_the_cpu_route(capsys, fmt):
    rc = cli.main(["run", "--format", fmt, "--rhs", "3", "--x", "random",
                   "--matrix", EXAMPLE_MTX, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert "result is ok" in out and "[3 right-hand sides]" in out


def test_run_bsr_one_vector(capsys):
    rc = cli.main(["run", "--format", "bsr", "--matrix", EXAMPLE_MTX,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert "bsr: 64 x 64, nnz 565" in out and "fill" in out
    assert "result is ok" in out and "CPU:" in out


def test_run_rhs_reports_the_first_failing_column(capsys, monkeypatch):
    good = spmv_tpu_torch.spmm

    def spoiled(a, X):
        Y = good(a, X).clone()
        Y[3, 1:] += 1.0  # columns 1 and 2 go wrong
        return Y

    monkeypatch.setattr(spmv_tpu_torch, "spmm", spoiled)
    rc = cli.main(["run", "--format", "csr", "--rhs", "3", "--matrix",
                   EXAMPLE_MTX, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.VALIDATION_FAILED
    assert "[column 1 of 3 right-hand sides]" in out and "result is ok" not in out

"""The PyTorch port's format containers (CSR, COO, CMRS, ELL, SELL-C-σ,
HYB, and ELL/SELL without the panel/spill split) against the JAX package's
containers and the fp64 oracle — the slices as a whole, from triplets
through the plans to y (the plain PyTorch versions on the CPU).

JAX runs as the JAX tests run it (Pallas interpret mode on the CPU). Port
and JAX agree within the sum of both tolerances (see
``test_torch_engines.py``)."""

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu import synth as ref_synth
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu_torch import synth
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)

FORMATS = ["csr", "coo", "cmrs", "ell", "sell", "sell_c_sigma", "hyb",
           "ell_pure", "sell_pure"]
# bench.py's pure-panel builds: the format and its construction arguments
VARIANTS = {"ell_pure": ("ell", {"split": False}),
            "sell_pure": ("sell", {"split": False})}
EDGES = sorted(ref_synth.EDGE_CASES)


def make(fmt, nrows, ncols, r, c, v, jax=False):
    """The port's (or with ``jax`` the JAX package's) container of ``fmt``,
    a format name or one of ``VARIANTS``."""
    name, kwargs = VARIANTS.get(fmt, (fmt, {}))
    if jax:
        return spmv_tpu.from_coo(name, nrows, ncols, r, c, v, **kwargs)
    return spmv_tpu_torch.from_coo(name, nrows, ncols, r, c, v, device="cpu",
                                   **kwargs)


def max_row(nrows, r):
    return int(np.bincount(r, minlength=max(nrows, 1)).max()) if r.size else 1


def run_both(fmt, info, r, c, v, x=None, seed=99):
    """y from the port and from the JAX container on the same triplets and
    x; both checked against the oracle and against each other."""
    if x is None:
        x = np.random.default_rng(seed).standard_normal(info.ncols)
    x = np.asarray(x, np.float32)
    a_jax = make(fmt, info.nrows, info.ncols, r, c, v, jax=True)
    y_jax = np.asarray(a_jax.matvec(x))
    a = make(fmt, info.nrows, info.ncols, r, c, v)
    y_t = a.matvec(x)
    assert isinstance(y_t, torch.Tensor) and y_t.device.type == "cpu"
    y = y_t.numpy()
    k = max_row(info.nrows, r)
    row_abs = row_scale(info.nrows, r, c, v, x)
    expected = golden_spmv(info.nrows, r, c, v, x)
    rep = kernel_check(expected, y, row_abs, k)
    assert rep.ok, f"{fmt}: {rep}"
    jax_bound = KERNEL_TOL_ABS + engine_rel_tol(k) * container_scale(a_jax, x, row_abs)
    assert (np.abs(y_jax - expected) <= jax_bound).all()
    port_bound = KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
    assert (np.abs(y.astype(np.float64) - y_jax) <= port_bound + jax_bound).all()
    return a, a_jax, y


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("edge", EDGES)
def test_edge_cases(fmt, edge):
    run_both(fmt, *synth.edge_case(edge))


@pytest.mark.parametrize("fmt", FORMATS)
def test_random_medium(fmt):
    run_both(fmt, *synth.random_coo(500, 300, 4000, seed=3))


@pytest.mark.parametrize("fmt", FORMATS)
def test_band_matrix(fmt):
    run_both(fmt, *synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                        bandwidth=60, seed=5))


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_x_vector(fmt):
    # x[i] = i (coo.c:88-92), handed over as float64 like the CLI's default
    info, r, c, v = synth.random_coo(200, 200, 1500, seed=11)
    run_both(fmt, info, r, c, v, x=spmv_tpu_torch.default_x(info.ncols))


@pytest.mark.parametrize("fmt", FORMATS)
def test_duplicates_sum(fmt):
    info, r, c, v = synth.random_coo(40, 30, 900, seed=8, allow_duplicates=True)
    assert np.unique(r * 30 + c).size < r.size  # there are duplicates
    run_both(fmt, info, r, c, v)
    a = make(fmt, 3, 3, np.array([1, 1, 0]), np.array([2, 2, 0]),
             np.array([3.0, 4.0, 1.0]))
    assert a.matvec(np.array([1.0, 1.0, 2.0])).tolist() == [1.0, 14.0, 0.0]


@pytest.mark.parametrize("fmt", FORMATS)
def test_unsorted_input_gives_the_same_bits(fmt):
    info, r, c, v = synth.random_coo(300, 200, 3000, seed=4)
    perm = np.random.default_rng(1).permutation(r.size)
    x = np.random.default_rng(2).standard_normal(info.ncols)
    a = make(fmt, info.nrows, info.ncols, r, c, v)
    b = make(fmt, info.nrows, info.ncols, r[perm], c[perm], v[perm])
    assert torch.equal(a.matvec(x), b.matvec(x))
    run_both(fmt, info, r[perm], c[perm], v[perm], x=x)


def test_csr_from_csr_and_to_coo_roundtrip():
    info, r, c, v = synth.random_coo(120, 90, 800, seed=6)
    a = spmv_tpu_torch.CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v,
                                          device="cpu")
    b = spmv_tpu_torch.CSRMatrix.from_csr(info.nrows, info.ncols, a.ptr,
                                          a.cols, a.vals, device="cpu")
    x = np.random.default_rng(0).standard_normal(info.ncols)
    assert torch.equal(a.matvec(x), b.matvec(x))
    ref = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    for mine, theirs in zip(a.to_coo(), ref.to_coo()):
        assert np.array_equal(mine, theirs) and mine.dtype == theirs.dtype


def test_cmrs_arrays_match_jax_and_from_cmrs_ingest():
    info, r, c, v = synth.edge_case("ragged")  # 13 rows: a partial last strip
    a = spmv_tpu_torch.from_coo("cmrs", info.nrows, info.ncols, r, c, v,
                                device="cpu")
    ref = spmv_tpu.from_coo("cmrs", info.nrows, info.ncols, r, c, v)
    assert a.height == ref.height == 8 and a.nstrips == ref.nstrips
    assert np.array_equal(a.strip_ptr, ref.strip_ptr)
    assert np.array_equal(a.row_in_strip, ref.row_in_strip)
    assert np.array_equal(a.cols, ref.cols)
    # ingest the format's own arrays, with entries shuffled inside strips
    perm = np.concatenate([np.random.default_rng(s).permutation(
        np.arange(a.strip_ptr[s], a.strip_ptr[s + 1])) for s in range(a.nstrips)])
    b = spmv_tpu_torch.CMRSMatrix.from_cmrs(
        info.nrows, info.ncols, a.strip_ptr, a.row_in_strip[perm], a.cols[perm],
        a.vals[perm], device="cpu")
    x = np.random.default_rng(3).standard_normal(info.ncols)
    assert torch.equal(a.matvec(x), b.matvec(x))
    with pytest.raises(ValueError, match="height"):
        spmv_tpu_torch.CMRSMatrix.from_coo(3, 3, r[:0], c[:0], v[:0], height=0,
                                           device="cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_from_reference_carries_a_jax_container_across(fmt):
    info, r, c, v = synth.random_coo(150, 170, 1200, seed=9, allow_duplicates=True)
    ref = make(fmt, info.nrows, info.ncols, r, c, v, jax=True)
    a = spmv_tpu_torch.from_reference(ref, device="cpu")
    assert type(a).__name__ == type(ref).__name__
    assert (a.nrows, a.ncols, a.nnz) == (ref.nrows, ref.ncols, ref.nnz)
    mine, theirs = a.to_coo(), ref.to_coo()
    if fmt == "hyb":  # JAX's order follows its TPU layout: compare the sets
        mine, theirs = ([t[np.lexsort(trip[::-1])] for t in trip]
                        for trip in (mine, theirs))
    for m, t in zip(mine, theirs):
        assert np.array_equal(m, t)
    if fmt.startswith("sell"):
        assert a.sigma == ref.sigma
    x = np.random.default_rng(4).standard_normal(info.ncols).astype(np.float32)
    y, y_jax = a.matvec(x).numpy(), np.asarray(ref.matvec(x))
    k = max_row(info.nrows, r)
    row_abs = row_scale(info.nrows, r, c, v, x)
    bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
             + engine_rel_tol(k) * container_scale(ref, x, row_abs))
    assert (np.abs(y.astype(np.float64) - y_jax) <= bound).all()


def test_unported_formats_say_so():
    """Every JAX format is ported (sym was the last), and so is the tiled
    container (a real JAX ``TiledSpmv`` goes through ``from_reference``); a
    JAX container with no counterpart still says so, and an unknown format
    name is refused."""
    from spmv_tpu.big import TiledSpmv as RefTiled

    info, r, c, v = synth.edge_case("dense_small")
    sym = spmv_tpu.from_coo("sym", info.nrows, info.ncols, r[r >= c], c[r >= c],
                            v[r >= c])
    assert type(spmv_tpu_torch.from_reference(sym, device="cpu")).__name__ == \
        "SymmetricMatrix"
    assert spmv_tpu_torch.api.NOT_PORTED == ()
    assert sorted(spmv_tpu_torch.FORMATS) == sorted(spmv_tpu.api.FORMATS)
    ref = RefTiled("csr", info.nrows, info.ncols, r, c, v, slab_rows=128,
                   panel_cols=128)
    tiled = spmv_tpu_torch.from_reference(ref, device="cpu")
    assert isinstance(tiled, spmv_tpu_torch.TiledSpmv)
    assert (tiled.DR, tiled.DC, tiled.n_tiles) == (ref.DR, ref.DC, ref.n_tiles)
    x = np.random.default_rng(4).standard_normal(info.ncols).astype(np.float32)
    rep = kernel_check(golden_spmv(info.nrows, r, c, v, x), tiled.matvec(x).numpy(),
                       row_scale(info.nrows, r, c, v, x), max_row(info.nrows, r))
    assert rep.ok, str(rep)

    class RingShardedSpmv:  # a JAX container that needs a mesh, not triplets
        pass

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        spmv_tpu_torch.from_reference(RingShardedSpmv(), device="cpu")
    with pytest.raises(ValueError, match="unknown format"):
        spmv_tpu_torch.from_coo("nope", info.nrows, info.ncols, r, c, v,
                                device="cpu")


def test_load_synthesizes_a_missing_file_like_jax(tmp_path):
    path = str(tmp_path / "cant.mtx")
    a = spmv_tpu_torch.load(path, "csr", device="cpu", synth=dict(n=700, seed=2))
    ref = spmv_tpu.load(path, "csr", synth=dict(n=700, seed=2))
    for mine, theirs in zip(a.to_coo(), ref.to_coo()):
        assert np.array_equal(mine, theirs)
    assert spmv_tpu_torch.spmv(a, np.ones(a.ncols)).shape == (700,)


def test_to_coo_returns_copies():
    info, r, c, v = synth.random_coo(30, 30, 100, seed=1)
    for fmt in FORMATS:
        a = make(fmt, info.nrows, info.ncols, r, c, v)
        x = np.ones(info.ncols)
        y0 = a.matvec(x).clone()
        rows, cols, vals = a.to_coo()
        vals[:] = 0
        assert torch.equal(a.matvec(x), y0)
        assert (a @ x).shape == (info.nrows,)
        with pytest.raises(ValueError, match="entries"):
            a.matvec(np.ones(info.ncols + 1))

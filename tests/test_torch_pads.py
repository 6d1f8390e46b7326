"""Pad slots and row checks of the PyTorch port's panel formats.

A panel pads every row of a 32-row slice to the slice's longest row. Pad
slots hold value 0 and column ``formats.base.PAD_COL`` (-1), and every
panel kernel and its plain version skips them, so a non-finite x entry
reaches only the rows that read its column, as in ``golden_spmv`` and the
port's CSR-plan formats. ELL, SELL and HYB (and the fp64-grade ones)
refuse a row outside the matrix with the plain message of the other
formats before they count row lengths.

The containers run their plain PyTorch versions here (CPU tensors); the
CUDA kernels are held to the same rule on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch import cache, synth
from spmv_tpu_torch.device import DevPanel
from spmv_tpu_torch.formats.base import PAD_COL, SLICE_ROWS, PanelPlan, build_panel_plan
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv, row_scale
from spmv_tpu_torch.probes.common import PANEL_SHAPES, unread_column

FLOAT_BUILDS = [("ell", {}), ("ell", {"split": False}), ("sell", {}),
                ("sell", {"split": False}), ("hyb", {})]
X2_BUILDS = [("ell", {}), ("ell", {"split": False}), ("sell", {}),
             ("sell", {"split": False}), ("hyb", {})]
BAD = {"nan": float("nan"), "inf": float("inf"), "-inf": float("-inf")}


def bad_x(trip, where: str, bad: str, dtype=np.float32, seed=3):
    """x from a seed with one non-finite entry: at x[0] (a column no row
    of ``unread_column`` reads) or at a column some row reads; and the
    same x with that entry finite, for the row scale."""
    info = trip[0]
    x = np.random.default_rng(seed).standard_normal(info.ncols).astype(dtype)
    fine = x.copy()
    x[0 if where == "x0" else int(trip[2][-1])] = BAD[bad]  # the last nonzero's column
    return x, fine


def same_as_oracle(got: np.ndarray, want: np.ndarray, scale: np.ndarray, atol, rtol):
    """NaN exactly where the oracle has NaN, the same infinities, and the
    finite entries within atol + rtol·scale."""
    got = np.asarray(got, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    assert np.array_equal(np.isinf(got), inf) and np.array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= atol + rtol * scale[fin]).all()


def test_the_matrix_pads_rows_that_do_not_read_column_0():
    """The unread-column matrix: no entry in column 0, row 0 with 6
    nonzeros and every other row 1, so its whole ELL panel pads 31 rows of
    the first slice; the reader column is read by some row."""
    trip = unread_column()
    info, r, c, v = trip
    assert (info.nrows, info.ncols, r.size) == (300, 300, 305)
    assert c.min() >= 1
    a = spmv_tpu_torch.from_coo("ell", 300, 300, r, c, v, split=False, device="cpu")
    pads = int((a.dev.cols == PAD_COL).sum())
    assert a.dev.max_width == 6 and pads == a.dev.nslots - r.size
    assert pads == (6 * 32 - 37) + (320 - 300)  # the first slice, the rows past 300


@pytest.mark.parametrize("bad", sorted(BAD))
@pytest.mark.parametrize("where", ["x0", "read"])
@pytest.mark.parametrize("fmt,kw", FLOAT_BUILDS,
                         ids=[f"{f}{'_whole' if k else ''}" for f, k in FLOAT_BUILDS])
def test_float32_formats_match_the_oracle_with_a_non_finite_x(fmt, kw, where, bad):
    trip = unread_column()
    info, r, c, v = trip
    x, fine = bad_x(trip, where, bad)
    a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **kw)
    v32 = v.astype(np.float32)
    want = golden_spmv(info.nrows, r, c, v32, x)
    if where == "x0":
        assert not np.isnan(want).any()
    same_as_oracle(a.matvec(x).numpy(), want, row_scale(info.nrows, r, c, v32, fine),
                   KERNEL_TOL_ABS, fp32_rel_tol(6))


@pytest.mark.parametrize("where", ["x0", "read"])
@pytest.mark.parametrize("fmt,kw", FLOAT_BUILDS,
                         ids=[f"{f}{'_whole' if k else ''}" for f, k in FLOAT_BUILDS])
def test_spmm_matches_the_oracle_with_a_non_finite_column(fmt, kw, where):
    """spmm at R = 3 (K10's plain version on the panel), a NaN in column 0
    of X and an inf in column 2, column 1 finite."""
    trip = unread_column()
    info, r, c, v = trip
    x_nan, fine = bad_x(trip, where, "nan")
    x_inf, _ = bad_x(trip, where, "inf")
    X = np.stack([x_nan, fine, x_inf], axis=1)
    a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **kw)
    Y = spmv_tpu_torch.spmm(a, X).numpy()
    v32 = v.astype(np.float32)
    scale = row_scale(info.nrows, r, c, v32, fine)
    for j in range(3):
        same_as_oracle(Y[:, j], golden_spmv(info.nrows, r, c, v32, X[:, j]), scale,
                       KERNEL_TOL_ABS, fp32_rel_tol(6))


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("where", ["x0", "read"])
@pytest.mark.parametrize("fmt,kw", X2_BUILDS,
                         ids=[f"{f}{'_whole' if k else ''}" for f, k in X2_BUILDS])
def test_x2_formats_match_the_oracle_with_a_non_finite_x(fmt, kw, where, bad):
    trip = unread_column()
    info, r, c, v = trip
    x, fine = bad_x(trip, where, bad, np.float64)
    a = spmv_tpu_torch.X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v,
                                         device="cpu", **kw)
    same_as_oracle(a.matvec(x).numpy(), golden_spmv(info.nrows, r, c, v, x),
                   row_scale(info.nrows, r, c, v, fine), 1e-6, 1e-9)


@pytest.mark.parametrize("tile", [32, 3, 1])
def test_plain_panel_kernels_leave_pads_out(tile):
    """Plain K4 (its y and the partials), K4 + K7's identity mode, and
    plain K6 in each mode on the unread-column matrix's whole panel, with a
    NaN at x[0]: no NaN anywhere; at a column the last row reads, NaN in
    that row only."""
    trip = unread_column()
    info, r, c, v = trip
    dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                              tile=tile), "cpu")
    for where in ("x0", "read"):
        x, _ = bad_x(trip, where, "nan")
        xt = torch.from_numpy(x)
        y4, part = P.panel_spmv_partials_reference(dev, xt)
        outs = [P.panel_fixup_reference(dev, y4.clone(), part),
                P.panel_spmv_fused_reference(dev, xt, 0),
                P.panel_spmv_fused_reference(dev, xt, 1)]
        want = np.isnan(golden_spmv(info.nrows, r, c, v, x))
        assert want.sum() == (0 if where == "x0" else 2)
        for y in outs:
            assert np.array_equal(np.isnan(y.numpy()), want)
        if where == "x0":
            assert not torch.isnan(part).any() and not torch.isnan(y4).any()


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_every_pad_slot_holds_pad_col_and_zero(name):
    """Each slot that holds no element of the matrix has column -1 and
    value 0; every element's slot has its own column (≥ 0)."""
    info, r, c, v = PANEL_SHAPES[name](0)
    p = build_panel_plan(info.nrows, info.ncols, r, c, v)
    held = np.zeros(p.nslots, bool)
    starts = np.searchsorted(r, np.arange(info.nrows))
    k = np.arange(r.size) - starts[r]
    held[p.slice_ptr[r // SLICE_ROWS] + r % SLICE_ROWS + SLICE_ROWS * k] = True
    assert (p.cols[~held] == PAD_COL).all() and (p.vals[~held] == 0).all()
    assert (p.cols[held] >= 0).all()
    assert held.sum() == p.nnz


def test_a_plan_cached_under_the_old_namespace_is_not_read(tmp_path, monkeypatch):
    """A panel plan of the old layout (pads at column 0), stored under the
    namespace ``torch-v1``, is found under that namespace but not under the
    current one: the build misses, and its plan's pads are -1."""
    info, r, c, v = PANEL_SHAPES["cut_last_slice"](0)
    key = ("panel", (r, c, v), info.nrows, info.ncols, {"tile": 32, "dtype": "float32"})
    fresh = build_panel_plan(info.nrows, info.ncols, r, c, v)
    old = dataclasses.replace(fresh, cols=np.where(fresh.cols < 0, 0, fresh.cols))
    with cache.plan_cache(str(tmp_path)):
        with monkeypatch.context() as m:
            m.setattr(cache, "NAMESPACE", "torch-v1")
            cache.plan_store(*key, old)
            assert (cache.plan_lookup(*key, PanelPlan).cols == old.cols).all()
        assert cache.NAMESPACE != "torch-v1"
        assert cache.plan_lookup(*key, PanelPlan) is None
        p = build_panel_plan(info.nrows, info.ncols, r, c, v)
        assert len(list(tmp_path.iterdir())) == 2
    assert np.array_equal(p.cols, fresh.cols) and (p.cols == PAD_COL).any()


def test_a_panel_over_zero_columns_gives_zeros():
    """Rows but no columns: nothing to read, and y is zeros through every
    panel wrapper and container (no guard against an empty x is left)."""
    dev = DevPanel.from_plan(build_panel_plan(40, 0, [], [], []), "cpu")
    x = torch.zeros(0)
    assert dev.nslots == 0 and dev.nrows == 40
    assert not P.panel_spmv(dev, x).any() and P.panel_spmv(dev, x).shape == (40,)
    assert not P.panel_spmv_fused(dev, x).any()
    assert not P.panel_fixup(dev, *P.panel_spmv_partials(dev, x)).any()
    for fmt in ("ell", "sell", "hyb"):
        a = spmv_tpu_torch.from_coo(fmt, 40, 0, [], [], [], device="cpu")
        assert a.matvec(np.zeros(0)).tolist() == [0.0] * 40


# ---------------------------------------------------------------- row checks

FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb", "bsr", "sym"]
X2_FORMATS = ["coo", "csr", "ell", "sell", "cmrs", "hyb"]


def out_of_range(axis: str, bad: int):
    """The unread-column matrix with entry 3's row or column set to
    ``bad``."""
    info, r, c, v = unread_column()
    r, c = r.copy(), c.copy()
    (r if axis == "row" else c)[3] = bad
    return info, r, c, v


@pytest.mark.parametrize("bad", [-1, 300])
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_every_format_refuses_an_index_out_of_range(fmt, axis, bad):
    info, r, c, v = out_of_range(axis, bad)
    # sym folds an upper entry into the lower triangle, so a row of -1
    # reaches its check as a column; BSR names both
    with pytest.raises(ValueError, match="index out of bounds"):
        spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")


@pytest.mark.parametrize("bad", [-1, 300])
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("fmt", X2_FORMATS)
def test_every_x2_format_refuses_an_index_out_of_range(fmt, axis, bad):
    info, r, c, v = out_of_range(axis, bad)
    with pytest.raises(ValueError, match=f"^{'row' if axis == 'row' else 'column'} "
                                         "index out of bounds$"):
        spmv_tpu_torch.X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v,
                                         device="cpu")


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("bad", [-1, 300])
@pytest.mark.parametrize("fmt", ["ell", "sell", "hyb"])
def test_panel_formats_refuse_a_row_before_counting_lengths(fmt, bad, split):
    """The plain message, not numpy's from a row-length count: a negative
    row would fail ``np.bincount``, a row at the bound a broadcast."""
    info, r, c, v = out_of_range("row", bad)
    kw = {} if fmt == "hyb" else {"split": split}
    with pytest.raises(ValueError, match="^row index out of bounds$"):
        spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **kw)


def test_launch_counts_stay_zero_on_the_cpu():
    trip = unread_column()
    info, r, c, v = trip
    before = dict(E.LAUNCHES)
    for fmt, kw in FLOAT_BUILDS:
        spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu",
                                **kw).matvec(np.ones(info.ncols, np.float32))
    assert E.LAUNCHES == before


def test_a_synthetic_panel_keeps_its_values_with_pads_left_out():
    """On a power-law panel (most slots pads), plain K4 + K7 and plain K6
    in each mode agree with the oracle on finite x."""
    info, r, c, v = synth.power_law(n=512, seed=4)
    a = spmv_tpu_torch.from_coo("ell", info.nrows, info.ncols, r, c, v, split=False,
                                device="cpu")
    dev = a.dev
    assert (dev.cols == PAD_COL).float().mean() > 0.5
    x = np.random.default_rng(1).standard_normal(info.ncols).astype(np.float32)
    xt = torch.from_numpy(x)
    k = int(np.bincount(r, minlength=info.nrows).max())
    scale = row_scale(info.nrows, r, c, v, x)
    want = golden_spmv(info.nrows, r, c, v.astype(np.float32), x)
    for y in (P.panel_fixup_reference(dev, *P.panel_spmv_partials_reference(dev, xt)),
              P.panel_spmv_fused_reference(dev, xt, 0),
              P.panel_spmv_fused_reference(dev, xt, 1)):
        assert (np.abs(y.numpy() - want) <= KERNEL_TOL_ABS + fp32_rel_tol(k) * scale).all()

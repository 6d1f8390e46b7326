"""The PyTorch port's fp64-grade mode (``spmv_tpu_torch.X2Matrix``, the
fp64 kernels' plain versions) against the JAX package's f32x2 mode
(``spmv_tpu.x2.X2Matrix``), on the same seeded triplets.

JAX runs as its own tests run it (``tests/test_x2.py``: Pallas interpret
mode on the CPU); the port's wrappers get CPU tensors and run their plain
PyTorch versions (K12-K15 are held against those on the card,
``test_torch_gpu.py``). Tolerances, each per row with Σ|v||x| its scale:

* port against JAX: ``1e-6 + 1e-9·Σ|v||x|``, JAX's ``_run_x2`` criterion
  (``oracle.x2_check``), since JAX's double-single result errs by about
  window·2⁻³⁸;
* port against a dense fp64 ``A @ x``: below 1e-8 absolute, as
  ``test_x2.py:33`` holds JAX (the fp32 engines land near 1e-4 there);
* port against ``golden_spmv``: ``k·2⁻⁵⁰·Σ|v||x|`` with k the longest row,
  since the port and the oracle both sum a row in fp64 (each within about
  k·2⁻⁵³·Σ|v||x| of the exact sum).

Every case carries values and an x with content below f32's mantissa, so
a float32 cast anywhere on the path fails the 1e-8 check.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu.formats import split as jax_split
from spmv_tpu.x2 import X2Matrix as JaxX2
from spmv_tpu_torch import X2_FORMATS, X2Matrix, cli, synth
from spmv_tpu_torch.device import DevCsr, DevPanel
from spmv_tpu_torch.errors import ReturnCode
from spmv_tpu_torch.formats import split as S
from spmv_tpu_torch.formats.base import (TILE_COLS, TILE_NNZ, build_csr_plan,
                                         build_panel_plan, csr_ptr)
from spmv_tpu_torch.io.mmio import MMInfo
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import golden_spmv, row_scale, x2_check
from spmv_tpu_torch.probes.common import TILE_SHAPES
from test_torch_panel import CASES, row_ordered

EXAMPLE = str(Path(__file__).resolve().parents[1] / "databases" / "example.mtx")
FORMATS6 = ("csr", "coo", "cmrs", "ell", "sell", "hyb")


def cant_case(n=1024, seed=5):
    """``test_x2.py:_case``: values with fp64-only mantissa content."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=16,
                                         bandwidth=60, seed=seed)
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size))
    x = np.random.default_rng(seed + 1).standard_normal(info.ncols)
    return info, r, c, v, x


def power_law_case():
    """``test_x2.py:48-59``: scattered columns, the SELL epilogue."""
    info, r, c, v = synth.power_law(n=2048, avg_nnz_per_row=10,
                                    bandwidth=600, seed=3)
    v = np.asarray(v, np.float64) * (1 + 1e-10 * np.arange(v.size))
    return info, r, c, v, np.random.default_rng(4).standard_normal(info.ncols)


def two_part_case():
    """``test_x2.py:69-104``: block-dense stripes plus hub rows, a genuine
    panel + spill partition once the dispatch term is zeroed."""
    n = 512
    rows_d = np.repeat(np.arange(n), 32)
    cols_d = (rows_d // 128) * 128 + np.tile(np.arange(32), n)
    rng = np.random.default_rng(11)
    hubs = rng.choice(n, 16, replace=False)
    rows_s = np.repeat(hubs, 250)
    cols_s = rng.integers(0, n, rows_s.size)
    rows = np.concatenate([rows_d, rows_s])
    cols = np.concatenate([cols_d, cols_s])
    _, first = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[first], cols[first]
    v = rng.standard_normal(rows.size) * (1 + 1e-9 * np.arange(rows.size))
    x = rng.standard_normal(n)
    info = MMInfo("matrix", "coordinate", "real", "general", n, n, rows.size)
    return info, rows, cols, v, x


MATRICES = {"cant_1024": cant_case, "power_law_2048": power_law_case}


@functools.cache
def case(name):
    return MATRICES[name]()


@functools.cache
def jax_y(name, fmt):
    info, r, c, v, x = case(name)
    return JaxX2.from_coo(fmt, info.nrows, info.ncols, r, c, v).matvec(x)


def dense(info, r, c, v, x):
    A = np.zeros((info.nrows, info.ncols))
    np.add.at(A, (r, c), v)
    return A @ x


def fp64_bound(info, r, c, v, x):
    """``k·2⁻⁵⁰·Σ|v||x|`` per row, k the longest row."""
    k = int(np.bincount(r, minlength=max(info.nrows, 1)).max()) if r.size else 1
    return k * 2.0 ** -50 * row_scale(info.nrows, r, c, v, x)


def check_port(y, info, r, c, v, x, y_jax=None):
    """The three tolerances of the module docstring."""
    assert y.dtype == torch.float64 and y.shape == (info.nrows,)
    y = y.numpy()
    assert np.abs(y - dense(info, r, c, v, x)).max() < 1e-8
    err = np.abs(y - golden_spmv(info.nrows, r, c, v, x))
    assert (err <= fp64_bound(info, r, c, v, x)).all(), err.max()
    if y_jax is not None:
        rep = x2_check(y_jax, y, row_scale(info.nrows, r, c, v, x))
        assert rep.ok, rep


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("fmt, split", [(f, True) for f in FORMATS6]
                         + [("sell_c_sigma", True), ("ell", False), ("sell", False)])
def test_x2_matches_jax_on_the_band_case(fmt, split):
    """Every format; ``split=False`` keeps ell and sell whole in the panel,
    the shape JAX's x2 ell and sell always take."""
    info, r, c, v, x = case("cant_1024")
    before = dict(E.LAUNCHES)
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu",
                          split=split)
    assert a.x2 and a.format == fmt and a.nnz == r.size
    check_port(a.matvec(x), info, r, c, v, x, jax_y("cant_1024", fmt))
    assert E.LAUNCHES == before  # CPU tensors: the plain versions ran
    if fmt.startswith("sell"):  # the port sorts this matrix (JAX may not)
        assert a.sorted_rows and a.shape == "panel"
    if not split:
        assert a.shape == "panel" and a.dev_spill is None and a.panel_nnz == r.size


@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_x2_matches_jax_on_the_power_law_case(fmt):
    info, r, c, v, x = case("power_law_2048")
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    check_port(a.matvec(x), info, r, c, v, x, jax_y("power_law_2048", fmt))


@pytest.mark.parametrize("shape", sorted(TILE_SHAPES))
def test_x2_tile_shapes_match_jax(shape):
    """Plain K12 + K13 on the extremes of K12's row-offset stage (a tile of
    1024 one-nonzero rows, tiles over the stage's cap through runs of empty
    rows, a hub row over six tiles) against JAX's ``X2Matrix`` csr, a dense
    fp64 product and the oracle, with the module's tolerances."""
    info, r, c, v = TILE_SHAPES[shape](seed=5)
    v = v * (1 + 1e-9 * np.arange(v.size))
    x = np.random.default_rng(6).standard_normal(info.ncols)
    before = dict(E.LAUNCHES)
    a = X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cpu")
    y_jax = JaxX2.from_coo("csr", info.nrows, info.ncols, r, c, v).matvec(x)
    check_port(a.matvec(x), info, r, c, v, x, np.asarray(y_jax))
    assert E.LAUNCHES == before


@pytest.mark.parametrize("fmt", ["hyb", "ell", "sell"])
def test_x2_two_part_split_matches_jax(monkeypatch, fmt):
    monkeypatch.setattr(S, "_DISPATCH_S", 0.0)
    monkeypatch.setattr(jax_split, "_DISPATCH_S", 0.0)
    info, r, c, v, x = two_part_case()
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    assert a.shape == "hyb" and a.dev_spill is not None
    assert 0 < a.spill_nnz < a.nnz and a.panel_nnz + a.spill_nnz == a.nnz
    ref = JaxX2.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    if fmt == "hyb":
        assert ref.dev_spill is not None
    check_port(a.matvec(x), info, r, c, v, x, ref.matvec(x))


def test_x2_error_is_a_hundredth_of_f32s():
    info, r, c, v, x = cant_case(seed=9)
    yref = dense(info, r, c, v, x)
    a32 = spmv_tpu_torch.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cpu")
    ax2 = X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cpu")
    e32 = np.abs(a32.matvec(x.astype(np.float32)).double().numpy() - yref).max()
    ex2 = np.abs(ax2.matvec(x).numpy() - yref).max()
    assert ex2 < e32 / 100, (ex2, e32)


def test_x2_refuses_bsr_and_unknown_formats():
    with pytest.raises(ValueError, match="f32x2 supports.*not 'bsr'"):
        X2Matrix.from_coo("bsr", 8, 8, [0], [0], [1.0], device="cpu")
    with pytest.raises(ValueError, match="not 'nope'"):
        X2Matrix.from_coo("nope", 8, 8, [0], [0], [1.0], device="cpu")
    assert set(X2_FORMATS) == set(FORMATS6) | {"sell_c_sigma"}
    with pytest.raises(ValueError):
        JaxX2.from_coo("bsr", 8, 8, [0], [0], [1.0])


def test_from_reference_refuses_a_jax_x2_container():
    info, r, c, v, _ = case("cant_1024")
    with pytest.raises(NotImplementedError, match="same triplets"):
        spmv_tpu_torch.from_reference(
            JaxX2.from_coo("csr", info.nrows, info.ncols, r, c, v), device="cpu")


@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb"])
def test_spmm_on_an_x2_container_keeps_fp64(fmt):
    info, r, c, v, _ = case("cant_1024")
    Xh = np.random.default_rng(12).standard_normal((info.ncols, 3))
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    Y = spmv_tpu_torch.spmm(a, Xh)
    assert Y.dtype == torch.float64 and Y.shape == (info.nrows, 3)
    for j in range(3):
        check_port(Y[:, j].contiguous(), info, r, c, v, Xh[:, j])
    # a float32 X is taken as it is, not cut again
    Y32 = spmv_tpu_torch.spmm(a, torch.from_numpy(Xh.astype(np.float32)))
    assert Y32.dtype == torch.float64


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("case_name", sorted(CASES))
def test_fp64_plans_keep_the_float32_pattern(case_name):
    info, r, c, v = row_ordered(CASES[case_name]())
    v = np.asarray(v, np.float64) * (1 + 1e-12)
    ptr = csr_ptr(r, info.nrows)
    p32 = build_csr_plan(info.nrows, info.ncols, ptr, c, v, tile=3)
    p64 = build_csr_plan(info.nrows, info.ncols, ptr, c, v, tile=3, dtype=np.float64)
    for f in ("ptr", "cols", "tile_row0", "carry_rows"):
        assert getattr(p64, f).tobytes() == getattr(p32, f).tobytes(), f
    assert p64.vals.dtype == np.float64 and p64.vals.tobytes() == v.tobytes()
    q32 = build_panel_plan(info.nrows, info.ncols, r, c, v, tile=3)
    q64 = build_panel_plan(info.nrows, info.ncols, r, c, v, tile=3, dtype=np.float64)
    for f in ("slice_ptr", "widths", "cols", "tile_slice0", "split_slices"):
        assert getattr(q64, f).tobytes() == getattr(q32, f).tobytes(), f
    assert q64.vals.dtype == np.float64
    assert np.array_equal(q64.vals.astype(np.float32), q32.vals)
    dev = DevCsr.from_plan(p64, "cpu")
    assert dev.vals.dtype == torch.float64
    assert dev.stream_bytes == sum(a.nbytes for a in (
        p64.ptr, p64.cols, p64.vals, p64.tile_row0, p64.carry_rows))


# ---------------------------------------------------------------- plain K12-K15


@pytest.mark.parametrize("tile", [3, 1])
@pytest.mark.parametrize("case_name", sorted(CASES))
def test_plain_x2_versions_agree_across_tiles(case_name, tile):
    """Plain K12 + K13 and K14 + K15 on tiles of 1 and 3 (many tile
    boundaries, ``wide_rows``' slices over hundreds of tiles) against the
    default tiles and the oracle, within the fp64 bound."""
    info, r, c, v = row_ordered(CASES[case_name]())
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size))
    xh = np.random.default_rng(13).standard_normal(info.ncols)
    x = torch.from_numpy(xh)
    bound = fp64_bound(info, r, c, v, xh)
    expected = golden_spmv(info.nrows, r, c, v, xh)
    ptr = csr_ptr(r, info.nrows)
    ys = {}
    for t in (tile, TILE_NNZ):
        dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, ptr, c, v,
                                              tile=t, dtype=np.float64), "cpu")
        ys[("seg", t)] = X.segmented_spmv_x2(dev, x)
    for t in (tile, TILE_COLS):
        dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                                  tile=t, dtype=np.float64), "cpu")
        ys[("panel", t)] = X.panel_spmv_x2(dev, x)
    for key, y in ys.items():
        assert y.dtype == torch.float64 and y.shape == (info.nrows,), key
        assert (np.abs(y.numpy() - expected) <= bound).all(), key
    for kind, t0 in (("seg", TILE_NNZ), ("panel", TILE_COLS)):
        d = np.abs(ys[(kind, tile)].numpy() - ys[(kind, t0)].numpy())
        assert (d <= bound).all(), kind


def test_wide_row_partials_sum_over_a_tile_range_in_fp64():
    info, r, c, v = row_ordered(CASES["wide_rows"]())
    dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols,
                                          csr_ptr(r, info.nrows), c, v, tile=4,
                                          dtype=np.float64), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(info.ncols))
    y, carry = X.segmented_spmv_x2_partials(dev, x)
    assert y.dtype == carry.dtype == torch.float64
    assert 100 in dev.carry_rows.tolist() and y[100] == 0  # left to K13
    y = X.carry_fixup_x2(dev, y, carry)
    exact = (v * x.numpy()[c])[r == 100]
    assert abs(float(y[100]) - exact.sum()) <= exact.size * 2.0 ** -50 * np.abs(exact).sum()


# Sha-256 prefixes of the float32 plain K1 + K2 and K4 + K5 outputs (one
# vector and three columns, tile 3) on three cases, recorded from the plain
# versions as they were before they took the plan's dtype.
F32_DIGESTS = {
    "band_1024": ("06f861e018399a0e", "858091da466a31ed"),
    "wide_rows": ("3b2389f562f57693", "b8ceb4297e97697b"),
    "power_law_2048": ("b74b3732bf324d9b", "115054f8c9c1578a"),
}


@pytest.mark.parametrize("case_name", sorted(F32_DIGESTS))
def test_float32_plain_versions_keep_their_bits(case_name):
    import hashlib

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            assert t.dtype == torch.float32
            h.update(t.numpy().tobytes())
        return h.hexdigest()[:16]

    info, r, c, v = row_ordered(CASES[case_name]())
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        info.ncols).astype(np.float32))
    Xm = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (info.ncols, 3)).astype(np.float32))
    d = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols,
                                        csr_ptr(r, info.nrows), c, v, tile=3), "cpu")
    y, carry = E.segmented_spmv_partials_reference(d, x)
    Y, C = E.segmented_spmv_partials_reference(d, Xm)
    seg = digest(y, carry, E.carry_fixup_reference(d, y.clone(), carry),
                 Y, C, E.carry_fixup_reference(d, Y.clone(), C))
    p = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                            tile=3), "cpu")
    yp, part = P.panel_spmv_partials_reference(p, x)
    Yp, Pp = P.panel_spmv_partials_reference(p, Xm)
    panel = digest(yp, part, P.panel_fixup_reference(p, yp.clone(), part),
                   Yp, Pp, P.panel_fixup_reference(p, Yp.clone(), Pp))
    assert (seg, panel) == F32_DIGESTS[case_name]


def test_wrappers_refuse_the_other_dtype():
    """An fp64 plan into a float32 kernel's wrapper, a float32 plan or x
    into an fp64 one: a ValueError before any launch, on the CPU too."""
    info, r, c, v = row_ordered(CASES["band_1024"]())
    ptr = csr_ptr(r, info.nrows)
    c32 = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, ptr, c, v), "cpu")
    c64 = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, ptr, c, v,
                                          dtype=np.float64), "cpu")
    p32 = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v), "cpu")
    p64 = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                              dtype=np.float64), "cpu")
    x32 = torch.ones(info.ncols)
    x64 = torch.ones(info.ncols, dtype=torch.float64)
    X32 = torch.ones(info.ncols, 2)
    y32, k32 = E.segmented_spmv_partials(c32, x32)
    y64, k64 = X.segmented_spmv_x2_partials(c64, x64)
    q32, s32 = P.panel_spmv_partials(p32, x32)
    q64, s64 = X.panel_spmv_x2_partials(p64, x64)
    before = dict(E.LAUNCHES)
    f32_calls = [
        lambda: E.segmented_spmv_partials(c64, x32),
        lambda: E.carry_fixup(c64, y32, k32),
        lambda: E.segmented_spmv_fused(c64, x32),
        lambda: E.segmented_spmv_multi_partials(c64, X32),
        lambda: P.panel_spmv_partials(p64, x32),
        lambda: P.panel_fixup(p64, q32, s32),
        lambda: P.panel_spmv_fused(p64, x32),
        lambda: P.panel_spmv_multi_partials(p64, X32),
    ]
    for call in f32_calls:
        with pytest.raises(ValueError, match="plan holds torch.float64"):
            call()
    for call in (lambda: X.segmented_spmv_x2_partials(c32, x64),
                 lambda: X.carry_fixup_x2(c32, y64, k64),
                 lambda: X.panel_spmv_x2_partials(p32, x64),
                 lambda: X.panel_fixup_x2(p32, q64, s64)):
        with pytest.raises(ValueError, match="plan holds torch.float32"):
            call()
    for call in (lambda: X.segmented_spmv_x2_partials(c64, x32),
                 lambda: X.carry_fixup_x2(c64, y32, k32),
                 lambda: X.panel_spmv_x2_partials(p64, x32),
                 lambda: X.panel_fixup_x2(p64, q32, s32),
                 lambda: E.segmented_spmv_partials(c32, x64),
                 lambda: P.panel_spmv_partials(p32, x64)):
        with pytest.raises(ValueError, match="expected contiguous"):
            call()
    with pytest.raises(ValueError, match="expected contiguous torch.float64"):
        X.inverse_permute_x2(torch.arange(4, dtype=torch.int32), torch.ones(4), 4)
    assert E.LAUNCHES == before


def test_plain_fp64_gather_is_a_bit_copy():
    info, r, c, v, x = case("cant_1024")
    a = X2Matrix.from_coo("sell", info.nrows, info.ncols, r, c, v, device="cpu")
    assert a.sorted_rows and a.invperm_dev.dtype == torch.int32
    # doubles over the whole exponent range, denormals and -0.0 included
    rng = np.random.default_rng(5)
    yh = rng.standard_normal(a.dev.nrows) * 2.0 ** rng.integers(-1070, 1000, a.dev.nrows)
    yh[::97] = -0.0
    y_sorted = torch.from_numpy(yh)
    want = y_sorted[a.invperm_dev[:info.nrows].long()]
    for fn in (X.inverse_permute_x2, X.inverse_permute_x2_reference):
        got = fn(a.invperm_dev, y_sorted, info.nrows)
        assert got.dtype == torch.float64 and got.shape == (info.nrows,)
        assert got.numpy().tobytes() == want.numpy().tobytes()
    # and the container's matvec is the sorted-space product, gathered
    y_plain = X.panel_and_spill_spmv_x2(a.dev, a.dev_spill, torch.from_numpy(x))
    assert torch.equal(a.matvec(x), y_plain[a.invperm_dev[:info.nrows].long()])


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("fmt", FORMATS6)
def test_run_f32x2_on_the_cpu_route(capsys, fmt):
    rc = cli.main(["run", "--format", fmt, "--dtype", "f32x2", "--matrix",
                   EXAMPLE, "--x", "random", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert "result is ok" in out and "[f32x2]" in out and "tol_abs=1.0e-06" in out


@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_run_f32x2_with_several_right_hand_sides(capsys, fmt):
    rc = cli.main(["run", "--format", fmt, "--dtype", "f32x2", "--rhs", "3",
                   "--matrix", EXAMPLE, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert "result is ok" in out and "[f32x2, 3 right-hand sides]" in out


def test_run_f32x2_refuses_bsr_with_jaxs_code(capsys):
    rc = cli.main(["run", "--format", "bsr", "--dtype", "f32x2", "--matrix",
                   EXAMPLE, "--device", "cpu"])
    assert rc == ReturnCode.PROGRAM_ERROR == 2
    assert "f32x2 supports" in capsys.readouterr().err


def test_run_f32x2_keeps_sub_f32_content(capsys, tmp_path):
    """Values that float32 cannot hold: a cast anywhere on the CLI's path
    would show as an error far above 1e-8."""
    info, r, c, v, _ = cant_case(n=300, seed=2)
    path = tmp_path / "m.mtx"
    lines = [f"{i + 1} {j + 1} {val:.17g}" for i, j, val in zip(r, c, v)]
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    f"{info.nrows} {info.ncols} {r.size}\n" + "\n".join(lines) + "\n")
    rc = cli.main(["run", "--format", "csr", "--dtype", "f32x2", "--matrix",
                   str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    err = float(out.split("max_abs_err=")[1].split(",")[0])
    assert err < 1e-8, out

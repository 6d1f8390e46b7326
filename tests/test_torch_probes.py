"""The probes of the PyTorch port (``spmv_tpu_torch.kernels.probes`` and
``spmv_tpu_torch.probes``) on the CPU, where every wrapper runs its plain
version.

* The u16-column and tile-128/512/2048 variants of K1 + K2 against the JAX
  engine's ``segmented_spmv_partials`` (its ``_seg_kernel`` and
  ``_window_scatter``, Pallas in interpret mode, as ``tests/conftest.py``
  runs them), within the sum of both tolerances (the port's ``1e-5 +
  fp32_rel_tol(k)·Σ|v||x|`` and JAX's ``1e-5 + engine_rel_tol(k)·
  container_scale``), and both against the fp64 oracle.
* The stage cuts against independent numpy definitions.
* Refusals, the CLI on the CPU, and the byte counts of the bounds.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spmv_tpu
from spmv_tpu import synth as ref_synth
from spmv_tpu.device import x_to_table, y_from_padded
from spmv_tpu.kernels.engines import segmented_spmv_partials as jax_partials
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu_torch import CSRMatrix, X2Matrix, from_coo
from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.errors import ReturnCode
from spmv_tpu_torch.formats.base import build_csr_plan, csr_ptr
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)
from spmv_tpu_torch.probes import PROBES, bounds, timing
from spmv_tpu_torch.probes.__main__ import main as probes_main

REPO = Path(__file__).resolve().parents[1]

MATRICES = {
    "empty_rows": lambda: ref_synth.edge_case("empty_rows"),
    "ragged": lambda: ref_synth.edge_case("ragged"),
    "all_empty": lambda: ref_synth.edge_case("all_empty"),
    "rectangular": lambda: ref_synth.edge_case("rectangular"),
    "random_500x300": lambda: ref_synth.random_coo(500, 300, 4000, seed=3),
    "band_1024": lambda: ref_synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                                  bandwidth=60, seed=5),
    "power_law_2048": lambda: ref_synth.power_law(n=2048, seed=7),
}
F32, F64 = torch.float32, torch.float64


@functools.cache
def reference(name):
    """Triplets, x, the JAX engine's y (B1 + B2 in interpret mode) and its
    bound, and the longest row."""
    info, r, c, v = MATRICES[name]()
    x = np.random.default_rng(17).standard_normal(info.ncols).astype(np.float32)
    a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    y_jax = np.asarray(y_from_padded(jax_partials(a.dev, x_to_table(x, info.ncols)),
                                     info.nrows))
    k = int((np.bincount(r, minlength=info.nrows) if r.size else np.zeros(1)).max() or 1)
    jax_bound = (KERNEL_TOL_ABS + engine_rel_tol(k)
                 * container_scale(a, x, row_scale(info.nrows, r, c, v, x)))
    return info, r, c, v, x, y_jax, jax_bound, k


def plan(name, dtype=F32) -> DevCsr:
    """The port's CSR plan of a matrix on the CPU, in ``dtype``."""
    info, r, c, v = reference(name)[:4]
    if dtype == F64:
        return X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cpu").dev
    return CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="cpu").dev


def triplets_in_order(name):
    info, r, c, v = reference(name)[:4]
    order = np.lexsort((c, r))
    return info, r[order], c[order], np.asarray(v)[order]


def check_against_jax(name, y_port):
    info, r, c, v, x, y_jax, jax_bound, k = reference(name)
    row_abs = row_scale(info.nrows, r, c, v, x)
    port_bound = KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
    assert y_port.shape == y_jax.shape == (info.nrows,)
    err = np.abs(y_port.astype(np.float64) - y_jax)
    assert (err <= port_bound + jax_bound).all(), err.max()
    expected = golden_spmv(info.nrows, r, c, v, x)
    assert kernel_check(expected, y_port, row_abs, k).ok
    assert (np.abs(y_jax - expected) <= jax_bound).all()


# ---------------------------------------------------------------- against JAX


@pytest.mark.parametrize("variant", ["u16", "t128", "t512", "t2048"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_probe_variants_of_k1_k2_match_jax(name, variant):
    """Plain K1 + K2 with 16-bit columns, or at another tile, against
    ``segmented_spmv_partials`` (B1 + B2)."""
    x = torch.from_numpy(reference(name)[4])
    dev = plan(name)
    before = dict(E.LAUNCHES)
    if variant == "u16":
        y, carry = KP.segmented_spmv_partials_u16(dev, KP.cols16(dev), x)
        y = E.carry_fixup(dev, y, carry)
    else:
        dt = KP.retile(dev, int(variant[1:]))
        assert dt.tile == int(variant[1:]) and dt.nnz == dev.nnz
        y = KP.carry_fixup_at(dt, *KP.segmented_spmv_partials_at(dt, x))
    assert E.LAUNCHES == before  # CPU tensors: the plain versions ran
    check_against_jax(name, y.numpy())


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_u16_columns_give_k1s_plain_bits(name, dtype):
    dev = plan(name, dtype)
    x = torch.from_numpy(reference(name)[4]).to(dtype)
    c16 = KP.cols16(dev)
    assert c16.dtype == torch.int16 and c16.shape == (dev.nnz,)
    assert torch.equal((c16.to(torch.int32) & 0xFFFF), dev.cols)
    got = KP.segmented_spmv_partials_u16(dev, c16, x)
    want = E.segmented_spmv_partials_reference(dev, x)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == dtype and a.numpy().tobytes() == b.numpy().tobytes()


def test_u16_columns_keep_the_top_half_of_the_range():
    """Columns 32768-65535 survive the int16 storage."""
    n = 65536
    cols = np.array([0, 32767, 32768, 65535], np.int64)
    dev = DevCsr.from_plan(build_csr_plan(1, n, [0, 4], cols, np.ones(4)), "cpu")
    c16 = KP.cols16(dev)
    assert (c16.to(torch.int32) & 0xFFFF).tolist() == cols.tolist()
    x = torch.zeros(n)
    x[cols] = torch.tensor([1.0, 2.0, 4.0, 8.0])
    y, _ = KP.segmented_spmv_partials_u16(dev, c16, x)
    assert y.tolist() == [15.0]


# ---------------------------------------------------------------- stage cuts


def xtilde_np(ncols):
    return (np.arange(ncols) & 1023) * 2.0 ** -10


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_nogather_is_k1_on_xtilde(name, dtype):
    """nogather against numpy's y = A·x̃: per row within the port's bound in
    float32, k·2⁻⁵⁰·Σ|v||x̃| in float64; and bit for bit plain K1 on x̃."""
    info, r, c, v = triplets_in_order(name)
    dev = plan(name, dtype)
    y, carry = KP.ablate_nogather(dev)
    xt = KP.xtilde(info.ncols, dtype, "cpu")
    assert np.array_equal(xt.numpy(), xtilde_np(info.ncols).astype(xt.numpy().dtype))
    for a, b in zip((y, carry), E.segmented_spmv_partials_reference(dev, xt), strict=True):
        assert torch.equal(a, b)
    y = E.carry_fixup_reference(dev, y, carry).double().numpy()
    vv = np.asarray(v, np.float64 if dtype == F64 else np.float32)
    want = golden_spmv(info.nrows, r, c, vv, xtilde_np(info.ncols))
    scale = row_scale(info.nrows, r, c, vv, xtilde_np(info.ncols))
    k = max(dev.max_row_nnz, 1)
    bound = (KERNEL_TOL_ABS + fp32_rel_tol(k) * scale if dtype == F32
             else k * 2.0 ** -50 * scale)
    assert (np.abs(y - want) <= bound).all()


def tile_sums_np(terms):
    starts = np.arange(0, terms.size, 1024)
    if not terms.size:
        return np.zeros(0), np.zeros(0)
    return np.add.reduceat(terms, starts), np.add.reduceat(np.abs(terms), starts)


def tile_bound(dtype, scale):
    """1024 terms summed in another order than numpy's: the port's fp32
    bound at k = 1024, or 1024·2⁻⁵⁰ of Σ|term| in float64."""
    return (KERNEL_TOL_ABS + fp32_rel_tol(1024) * scale if dtype == F32
            else 1024 * 2.0 ** -50 * scale)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_noseg_is_a_sum_per_tile(name, dtype):
    dev = plan(name, dtype)
    x = torch.from_numpy(reference(name)[4]).to(dtype)
    out = KP.ablate_noseg(dev.vals, dev.cols, x)
    assert out.shape == (dev.ntiles,) and out.dtype == dtype
    want, scale = tile_sums_np(dev.vals.double().numpy() * x.double().numpy()[dev.cols.numpy()])
    assert (np.abs(out.double().numpy() - want) <= tile_bound(dtype, scale)).all()


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dma_is_a_sum_of_values_and_columns_per_tile(name, dtype):
    """Per tile Σ (v + x̃(c)): both streams weigh in, so a sum that
    dropped either would leave the bound."""
    dev = plan(name, dtype)
    out = KP.ablate_dma(dev.vals, dev.cols)
    assert out.shape == (dev.ntiles,) and out.dtype == dtype
    v, xt = dev.vals.double().numpy(), xtilde_np(dev.ncols)[dev.cols.numpy()]
    want, scale = tile_sums_np(v + xt)
    bound = tile_bound(dtype, scale)
    assert (np.abs(out.double().numpy() - want) <= bound).all()
    for part in (v, xt):  # a dma that read only one stream
        alone = tile_sums_np(part)[0]
        assert not dev.nnz or (np.abs(alone - want) > bound).any()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_x32_is_fp64_products_over_a_float32_x(name):
    """x32 against numpy's fp64 y = A·x with x rounded to float32: per row
    within k·2⁻⁵⁰·Σ|v||x| (both sum in fp64, in other orders)."""
    info, r, c, v = triplets_in_order(name)
    dev = plan(name, F64)
    xh = np.random.default_rng(2).standard_normal(info.ncols)
    x32 = torch.from_numpy(xh.astype(np.float32))
    y, carry = KP.ablate_x32(dev, x32)
    assert y.dtype == F64
    y = E.carry_fixup_reference(dev, y, carry).numpy()
    xr = xh.astype(np.float32).astype(np.float64)
    vv = np.asarray(v, np.float64)
    want = golden_spmv(info.nrows, r, c, vv, xr)
    scale = row_scale(info.nrows, r, c, vv, xr)
    assert (np.abs(y - want) <= max(dev.max_row_nnz, 1) * 2.0 ** -50 * scale).all()
    if info.nrows and np.abs(xh - xr).max() > 0 and np.abs(want).max() > 0:
        full = golden_spmv(info.nrows, r, c, vv, xh)
        assert not np.array_equal(want, full)  # the float32 x is felt


def test_synthetic_stream_tiles_and_sums():
    vals, cols = timing.synthetic_stream(2**20, F32, "cpu", ncols=70000)
    assert vals.numel() % 1024 == 0 and vals.numel() * 8 <= 2**20
    assert 0 <= int(cols.min()) and int(cols.max()) < 70000
    assert timing.synthetic_stream(0, F32, "cpu")[0].numel() == 1024  # one tile at least
    v, xt = vals.double().numpy(), xtilde_np(70000)[cols.numpy()]
    want, scale = tile_sums_np(v + xt)
    bound = tile_bound(F32, scale)
    out = KP.ablate_dma(vals, cols)
    assert (np.abs(out.double().numpy() - want) <= bound).all()
    for part in (v, xt):  # on the ceiling's stream too, each stream is felt
        assert (np.abs(tile_sums_np(part)[0] - want) > bound).all()


# ---------------------------------------------------------------- refusals


def wide_plan():
    n = 70_000
    return DevCsr.from_plan(build_csr_plan(2, n, [0, 1, 2], [5, n - 1], [1.0, 2.0]), "cpu")


def test_cols16_refuses_more_than_65536_columns():
    dev = wide_plan()
    with pytest.raises(ValueError, match="16-bit"):
        KP.cols16(dev)
    with pytest.raises(ValueError, match="16-bit"):
        KP.segmented_spmv_partials_u16(dev, torch.zeros(2, dtype=torch.int16),
                                       torch.zeros(dev.ncols))


def test_probe_wrappers_refuse_wrong_types():
    dev = plan("ragged")
    x = torch.from_numpy(reference("ragged")[4])
    c16 = KP.cols16(dev)
    with pytest.raises(ValueError, match="float32"):
        KP.segmented_spmv_partials_u16(dev, c16, x.double())
    with pytest.raises(ValueError, match="int16"):
        KP.segmented_spmv_partials_u16(dev, dev.cols, x)
    with pytest.raises(ValueError, match="float64 plan"):
        KP.ablate_x32(dev, x)
    with pytest.raises(ValueError, match="float32"):
        KP.ablate_x32(plan("ragged", F64), x.double())
    with pytest.raises(ValueError, match="int32"):
        KP.ablate_dma(dev.vals, dev.cols.long())
    with pytest.raises(ValueError, match="float32 or float64"):
        KP.ablate_nogather(dataclasses.replace(dev, vals=dev.vals.half()))
    with pytest.raises(ValueError, match="shape"):
        KP.segmented_spmv_partials_at(KP.retile(dev, 128), x[:-1])


def test_probe_wrappers_refuse_devices_other_than_cpu_and_cuda():
    info, r, c, v = reference("ragged")[:4]
    dev = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="meta").dev
    x = torch.zeros(info.ncols, device="meta")
    for call in (lambda: KP.ablate_nogather(dev),
                 lambda: KP.ablate_noseg(dev.vals, dev.cols, x),
                 lambda: KP.ablate_dma(dev.vals, dev.cols),
                 lambda: KP.segmented_spmv_partials_at(dev, x)):
        with pytest.raises(ValueError, match="unsupported device meta"):
            call()


def test_timing_refuses_the_cpu():
    m = timing.Member("dma", lambda: None, 1, 1, F32, lambda out: "")
    with pytest.raises(ValueError, match="CUDA device only"):
        timing.measure([m], "cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        timing.card_line("cpu")


# ---------------------------------------------------------------- bounds


def test_byte_counts_follow_the_plan():
    dev = plan("power_law_2048")
    dt = KP.retile(dev, 128)
    ptr = dt.ptr.numpy().astype(np.int64)
    slots = sum((ptr[r + 1] - 1) // 128 - ptr[r] // 128 + 1 for r in dt.carry_rows.numpy())
    assert bounds.fixup_bytes(dt) == slots * 4 + dt.ncarry * (12 + 4)
    assert (bounds.seg_tiles_bytes(dev) - bounds.seg_tiles_bytes(dev, cols=KP.cols16(dev))
            == 2 * dev.nnz)
    assert bounds.seg_tiles_bytes(dev) - bounds.seg_tiles_bytes(dev, x_itemsize=0) == 4 * dev.ncols
    assert (bounds.csr_spmv_bytes(dev, R=4) - bounds.csr_spmv_bytes(dev)
            == 3 * 4 * (dev.ncols + dev.nrows))
    ms, by = bounds.bound_ms(3_350_000_000, 2, F32)
    assert by == "bytes" and ms == pytest.approx(1.0)
    assert bounds.bound_ms(1, 67_000_000_000, F32) == (pytest.approx(1.0), "operations")


def test_panel_byte_counts_read_tile_own0_at_one_column_only():
    """K4, K14 and K10 (the same tile kernel at R > 1) read the plan's
    tile_own0 once, at any R; only x, y and the partials grow with R."""
    info, r, c, v = reference("power_law_2048")[:4]
    pdev = from_coo("sell", info.nrows, info.ncols, r, c, v, split=False, device="cpu").dev
    read = bounds.nbytes(pdev.slice_ptr, pdev.cols, pdev.vals, pdev.tile_slice0,
                         pdev.tile_own0)
    xy = 4 * (pdev.ncols + pdev.nrows + 2 * pdev.ntiles * 32)
    assert bounds.nbytes(pdev.tile_own0) > 0
    for R in (1, 2, 4, 8):
        assert bounds.panel_tiles_bytes(pdev, R=R) == read + R * xy


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("probe", sorted(PROBES))
def test_probe_cli_on_the_cpu_checks_and_measures_nothing(capsys, probe):
    rc = probes_main([probe, "--matrix", "band", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert f"probe {probe} on band: 1024 x 1024" in out
    assert "checked:" in out and "warm not measured, cold not measured" in out
    assert " ms " not in out  # no time is printed for the CPU


def test_probe_cli_without_a_card_stops():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    proc = subprocess.run([sys.executable, "-m", "spmv_tpu_torch.probes", "ablate",
                           "--matrix", "band"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == ReturnCode.DEVICE_ERROR == 1
    assert "no CUDA device" in proc.stderr
    assert "checked" not in proc.stdout and "warm" not in proc.stdout


def test_pack_refuses_a_matrix_too_wide_for_u16(capsys, monkeypatch):
    from spmv_tpu_torch.probes import common

    wide = lambda: ref_synth.random_coo(40, 70_000, 300, seed=1)  # noqa: E731
    monkeypatch.setitem(common.MATRICES, "band", wide)
    assert probes_main(["pack", "--matrix", "band", "--device", "cpu"]) == \
        ReturnCode.PROGRAM_ERROR
    assert "16-bit" in capsys.readouterr().err


def test_a_failed_check_exits_nonzero(capsys, monkeypatch):
    """A wrong result is never printed as a pass."""
    monkeypatch.setattr(KP, "ablate_dma_reference",
                        lambda vals, cols: torch.zeros(-(-vals.numel() // 1024),
                                                       dtype=vals.dtype))
    assert probes_main(["ablate", "--matrix", "band", "--device", "cpu"]) == \
        ReturnCode.VALIDATION_FAILED
    assert "check failed" in capsys.readouterr().err


def test_run_probe_returns_bytes_and_no_times_on_the_cpu():
    from spmv_tpu_torch.probes import run_probe

    info, r, c, v = reference("band_1024")[:4]
    res = run_probe("accum", trip=(info, r, c, v), device="cpu", out=lambda s: None)
    assert res["card"].endswith("CPU") and res["l2_bytes"] is None
    names = [f"t{t} K1{k}" for t in (128, 512, 1024, 2048) for k in ("", "+K2")]
    assert list(res["members"]) == [*names, "dma", "hbm"]
    for m in res["members"].values():
        assert m["warm_ms"] is None and m["cold_ms"] is None
        assert m["bytes"] > 0 and m["bound_ms"] > 0 and m["bound_by"] == "bytes"


def test_band_plans_agree_with_the_ptr_they_came_from():
    """``retile`` keeps the matrix: the same ptr, columns and values."""
    info, r, c, v = triplets_in_order("band_1024")
    dev = plan("band_1024")
    for tile in KP.PROBE_TILES:
        dt = KP.retile(dev, tile)
        assert torch.equal(dt.ptr, dev.ptr) and torch.equal(dt.cols, dev.cols)
        assert torch.equal(dt.vals, dev.vals)
        assert dt.ntiles == -(-dev.nnz // tile)
    assert np.array_equal(dev.ptr.numpy(), csr_ptr(r, info.nrows))


# ---------------------------------------------------------------- turns


def test_turns_without_a_card_stops(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    proc = subprocess.run([sys.executable, "-m", "spmv_tpu_torch.probes.turns",
                           str(REPO), "--out", str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr
    assert not any(tmp_path.iterdir())


def test_turns_compare_outputs_bit_for_bit(tmp_path):
    """``turns.compare`` names every output of a later turn whose bits
    differ from the first turn's: a flipped last bit, a -0.0 for a 0.0, a
    missing file; equal NaN bits pass."""
    from spmv_tpu_torch.probes import turns

    dirs = [tmp_path / f"{i}" for i in range(3)]
    y32 = np.array([0.0, 1.5, np.nan], np.float32)
    y64 = np.array([2.0, -3.25], np.float64)
    for d in dirs:
        d.mkdir()
        np.save(d / "a_f32_y.npy", y32)
        np.save(d / "a_f64_y.npy", y64)
    assert turns.compare(dirs) == []
    np.save(dirs[1] / "a_f32_y.npy", np.array([-0.0, 1.5, np.nan], np.float32))
    np.save(dirs[2] / "a_f64_y.npy", np.nextafter(y64, np.inf))
    assert turns.compare(dirs) == ["1/a_f32_y.npy", "2/a_f64_y.npy"]
    (dirs[2] / "a_f32_y.npy").unlink()
    assert "2/a_f32_y.npy" in turns.compare(dirs)


def test_turns_name_the_probes_matrices_to_a_worker():
    """``turns.matrix_specs`` names each matrix by generator and arguments,
    through JSON as the worker gets them, and they build the probes'
    matrices bit for bit."""
    from spmv_tpu_torch import synth
    from spmv_tpu_torch.probes import common, turns

    specs = json.loads(json.dumps(turns.matrix_specs()))
    assert list(specs) == list(turns.TURN_MATRICES)
    assert specs["pl_wide"] == ["power_law", dict(n=524_288, avg_nnz_per_row=24, seed=0)]
    gen, kwargs = specs["band"]
    a, b = getattr(synth, gen)(**kwargs), common.MATRICES["band"]()
    assert all(np.array_equal(u, w) for u, w in zip(a[1:], b[1:]))


@pytest.mark.parametrize("only", [None, "seg", "panel", "spmm", "sorted", "fused"])
def test_turns_specs_name_each_engines_matrices_and_rhs(tmp_path, only):
    """``turns.run_specs`` hands each worker, through JSON, the R of its
    kernels (1 for seg and panel, 2, 4, 8 for spmm), the segmented
    kernels' matrices, the SELL panels with their split, the panel
    shapes' triplets, the unsorted panels whose public calls the panel
    and spmm engines time, the sorted SELL builds and the plans of the
    one-dispatch sweep the fused engine times K3 on; ``--only`` keeps one
    engine's."""
    from spmv_tpu_torch import synth
    from spmv_tpu_torch.probes import common, turns

    specs = json.loads(json.dumps(turns.run_specs(only, tmp_path)))
    assert specs["rhs"] == {None: [1, 2, 4, 8], "seg": [1], "panel": [1],
                            "spmm": [2, 4, 8], "sorted": [], "fused": []}[only]
    assert ("fused" in specs) == (only in (None, "fused"))
    if "fused" in specs:  # the sweep's plans, built as chip_smoke.py builds them
        assert list(specs["fused"]) == list(turns.FUSED_TURN_MATRICES)
        assert specs["fused"]["entry"] == ["synthetic_cant", dict(
            n=512, avg_nnz_per_row=8, bandwidth=40, seed=0)]
        gen, kwargs = specs["fused"]["cant_8192"]
        a, b = getattr(synth, gen)(**kwargs), synth.synthetic_cant(n=8192)
        assert all(np.array_equal(u, w) for u, w in zip(a[1:], b[1:]))
    assert turns.SPMM_RHS == (2, 4, 8)
    assert ("seg" in specs) == (only in (None, "seg", "spmm"))
    assert ("panel" in specs) == ("shapes" in specs) == (only in (None, "panel", "spmm"))
    assert ("sorted" in specs) == (only in (None, "sorted"))
    assert ("unsorted" in specs) == (only in (None, "panel", "spmm"))
    if "sorted" in specs:  # cant split, pl and pl_big whole, pl with a spill
        assert {n: s[-2:] for n, s in specs["sorted"].items()} == {
            "cant": [True, False], "pl": [False, False], "pl_big": [False, False],
            "pl_hyb": [True, True]}
        assert specs["sorted"]["pl_hyb"][:2] == specs["sorted"]["pl"][:2] == [
            "power_law", dict(n=32768, avg_nnz_per_row=24, bandwidth=512, seed=0)]
        assert sorted(specs["sorted_shapes"]) == sorted(common.PANEL_SHAPES)
    if "seg" in specs:
        assert specs["seg"] == json.loads(json.dumps(turns.matrix_specs()))
    if "panel" in specs:
        assert list(specs["panel"]) == list(turns.PANEL_TURN_MATRICES)
        assert {n: s[-1] for n, s in specs["panel"].items()} == {
            "cant": True, "pl": False, "pl_big": False}
        assert sorted(specs["shapes"]) == sorted(common.PANEL_SHAPES)
        # pl-32768's ell_pure, its HYB and split ELL and cant's HYB with a
        # forced spill
        assert {n: s[2:] for n, s in specs["unsorted"].items()} == {
            "pl_ell_pure": ["ell", False, False], "pl_hyb": ["hyb", True, True],
            "pl_ell_spill": ["ell", True, True], "cant_hyb": ["hyb", True, True]}
        assert all(s[:2] == specs["panel"][n.split("_")[0]][:2]
                   for n, s in specs["unsorted"].items())
        for name, path in specs["shapes"].items():
            z = np.load(path)
            info, r, c, v = common.PANEL_SHAPES[name]()
            assert list(z["shape"]) == [info.nrows, info.ncols]
            assert np.array_equal(z["r"], r) and np.array_equal(z["v"], v)


def test_turns_compare_multi_rhs_outputs_column_by_column(tmp_path):
    """The spmm engine's saved Y, carries and partials ((n, R) and
    (2·ntiles, 32, R)) go through ``turns.compare`` like the vectors: one
    flipped bit in one column of one turn is named."""
    from spmv_tpu_torch.probes import turns

    rng = np.random.default_rng(0)
    arrays = {"cant_R4_y.npy": rng.standard_normal((50, 4)).astype(np.float32),
              "cant_R4_part.npy": rng.standard_normal((6, 4)).astype(np.float32),
              "cant_panel_R8_part.npy": rng.standard_normal((4, 32, 8)).astype(np.float32)}
    dirs = [tmp_path / f"{i}" for i in range(4)]
    for d in dirs:
        d.mkdir()
        for name, a in arrays.items():
            np.save(d / name, a)
    assert turns.compare(dirs) == []
    part = arrays["cant_panel_R8_part.npy"].copy()
    part.view(np.uint32)[2, 17, 7] ^= 1  # the last bit of column 7
    np.save(dirs[3] / "cant_panel_R8_part.npy", part)
    assert turns.compare(dirs) == ["3/cant_panel_R8_part.npy"]


def test_turns_run_each_checkout_twice_around_this():
    """``turns.turn_order``: one other checkout gives OTHER, THIS, THIS,
    OTHER; several (variants of one design) each run twice, in mirrored
    order around THIS's two turns."""
    from spmv_tpu_torch.probes import turns

    assert turns.turn_order(["other"]) == ["other", "this", "this", "other"]
    order = turns.turn_order(["other", "other2", "other3"])
    assert order == ["other", "other2", "other3", "this", "this", "other3", "other2",
                     "other"]
    assert all(order.count(t) == 2 for t in set(order))

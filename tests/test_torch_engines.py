"""The PyTorch port's segmented engine (``spmv_tpu_torch.kernels.engines``)
against the JAX package's, on the same triplets.

The JAX engines run as the JAX tests run them: Pallas in interpret mode on
the CPU (``tests/conftest.py``). The port's wrappers get CPU tensors, so
they run their plain PyTorch versions; the CUDA kernels themselves are
checked against those on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). Port and JAX agree within the sum of both tolerances:
the port's ``1e-5 + fp32_rel_tol(k)·Σ|v||x|`` and the JAX engine's
``1e-5 + engine_rel_tol(k)·container_scale``.
"""

import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spmv_tpu
from spmv_tpu import synth as ref_synth
from spmv_tpu.device import x_to_table, y_from_padded
from spmv_tpu.kernels.engines import segmented_spmv_fused as jax_fused
from spmv_tpu.kernels.engines import segmented_spmv_partials as jax_partials
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu_torch import CSRMatrix, device
from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.formats.base import TILE_NNZ, build_csr_plan
from spmv_tpu_torch.kernels import _build
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)
from spmv_tpu_torch.probes.common import TILE_SHAPES

MATRICES = {
    "empty_rows": lambda: ref_synth.edge_case("empty_rows"),
    "ragged": lambda: ref_synth.edge_case("ragged"),
    "all_empty": lambda: ref_synth.edge_case("all_empty"),
    "rectangular": lambda: ref_synth.edge_case("rectangular"),
    "random_500x300": lambda: ref_synth.random_coo(500, 300, 4000, seed=3),
    "band_1024": lambda: ref_synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                                  bandwidth=60, seed=5),
    "power_law_2048": lambda: ref_synth.power_law(n=2048, seed=7),
    # the extremes of K1's row-offset stage (test_torch_tiles.py)
    **TILE_SHAPES,
}


@functools.cache
def reference(name):
    """Triplets, x, and the JAX engine's two paths on them (cached: the
    interpret-mode kernels cost about half a second a call)."""
    info, r, c, v = MATRICES[name]()
    x = np.random.default_rng(17).standard_normal(info.ncols).astype(np.float32)
    a = spmv_tpu.from_coo("csr", info.nrows, info.ncols, r, c, v)
    x2d = x_to_table(x, info.ncols)
    y_partials = np.asarray(y_from_padded(jax_partials(a.dev, x2d), info.nrows))
    y_fused = np.asarray(y_from_padded(jax_fused(a.dev, x2d), info.nrows))
    lengths = np.bincount(r, minlength=info.nrows) if r.size else np.zeros(1)
    k = int(lengths.max() or 1)
    row_abs = row_scale(info.nrows, r, c, v, x)
    jax_bound = KERNEL_TOL_ABS + engine_rel_tol(k) * container_scale(a, x, row_abs)
    return info, r, c, v, x, y_partials, y_fused, jax_bound, k


def check_against_jax(name, y_port, y_jax):
    info, r, c, v, x, _, _, jax_bound, k = reference(name)
    row_abs = row_scale(info.nrows, r, c, v, x)
    port_bound = KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
    assert y_port.shape == y_jax.shape == (info.nrows,)
    err = np.abs(y_port.astype(np.float64) - y_jax)
    assert (err <= port_bound + jax_bound).all(), err.max()
    expected = golden_spmv(info.nrows, r, c, v, x)
    assert kernel_check(expected, y_port, row_abs, k).ok
    assert (np.abs(y_jax - expected) <= jax_bound).all()


def port_dev(name, tile=TILE_NNZ):
    info, r, c, v = reference(name)[:4]
    order = np.lexsort((c, r))
    a = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="cpu")
    if tile == TILE_NNZ:
        return a.dev
    return DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, a.ptr,
                                           np.asarray(c)[order],
                                           np.asarray(v)[order], tile=tile), "cpu")


@pytest.mark.parametrize("tile", [TILE_NNZ, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_two_dispatch_path_matches_jax_partials(name, tile):
    """Plain K1 + K2 against ``segmented_spmv_partials`` (B1 + B2)."""
    x = torch.from_numpy(reference(name)[4])
    dev = port_dev(name, tile)
    before = dict(E.LAUNCHES)
    y1, carry = E.segmented_spmv_partials(dev, x)
    y = E.carry_fixup(dev, y1, carry)
    assert E.LAUNCHES == before  # CPU tensors: the plain versions ran
    check_against_jax(name, y.numpy(), reference(name)[5])


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fused_path_matches_jax_fused(name):
    """Plain K3 against ``segmented_spmv_fused`` (B3)."""
    x = torch.from_numpy(reference(name)[4])
    dev = port_dev(name)
    before = dict(E.LAUNCHES)
    y = E.segmented_spmv_fused(dev, x)
    assert E.LAUNCHES == before
    check_against_jax(name, y.numpy(), reference(name)[6])


@pytest.mark.parametrize("tile", [TILE_NNZ, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fused_path_is_the_two_dispatch_path_bit_for_bit(name, tile):
    """Plain K3 is plain K1's tile partials and plain K2's adds in tile
    order, as the kernel is: the same bits as plain K1 + K2, so which side
    of the one-dispatch threshold a plan falls on does not change y."""
    x = torch.from_numpy(reference(name)[4])
    dev = port_dev(name, tile)
    y12 = E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x))
    assert torch.equal(E.segmented_spmv_fused(dev, x), y12)


@pytest.mark.parametrize("fused", [True, False])
def test_segmented_spmv_dispatches_on_plan_bytes(monkeypatch, fused):
    calls = []
    for fn in ("segmented_spmv_fused", "segmented_spmv_partials"):
        orig = getattr(E, fn)
        monkeypatch.setattr(E, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    monkeypatch.setattr(device, "FUSED_STREAM_BYTES_MAX",
                        1 << 40 if fused else 0)
    dev = port_dev("band_1024")
    y = E.segmented_spmv(dev, torch.from_numpy(reference("band_1024")[4]))
    assert calls == (["segmented_spmv_fused"] if fused
                     else ["segmented_spmv_partials"])
    check_against_jax("band_1024", y.numpy(), reference("band_1024")[5])


def test_wrappers_refuse_mismatched_inputs():
    dev = port_dev("ragged")
    x = torch.from_numpy(reference("ragged")[4])
    with pytest.raises(ValueError, match="shape"):
        E.segmented_spmv_fused(dev, x[:-1])
    with pytest.raises(ValueError, match="float32"):
        E.segmented_spmv_partials(dev, x.double())
    with pytest.raises(ValueError, match="plan on cpu"):
        E.segmented_spmv_fused(dev, x.to("meta"))
    y, carry = E.segmented_spmv_partials(dev, x)
    with pytest.raises(ValueError, match="does not match"):
        E.carry_fixup(dev, y[:-1], carry)


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    info, r, c, v = reference("ragged")[:4]
    a = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        E.segmented_spmv(a.dev, torch.zeros(info.ncols, device="meta"))


def test_fused_lanes_follow_mean_row_length():
    lanes = {}
    for n, per_row in ((400, 3), (400, 8), (400, 12), (400, 40)):
        rows = np.repeat(np.arange(n), per_row)
        cols = np.tile(np.arange(per_row), n)
        a = CSRMatrix.from_coo(n, per_row, rows, cols, np.ones(rows.size),
                               device="cpu")
        lanes[per_row] = E.fused_lanes(a.dev)
    assert lanes == {3: 4, 8: 8, 12: 16, 40: 32}


@pytest.mark.parametrize("longest, mode", [(12, 4), (13, 0), (96, 32), (97, 0)])
def test_fused_mode_is_the_tiles_wherever_a_row_is_long(longest, mode):
    """K3 runs a sub-warp per row only while no row takes more than
    ``ROWS_MAX_STEPS`` (3) steps of it; a longer row sends the plan to the
    tiles (0)."""
    assert E.ROWS_MAX_STEPS == 3
    per_row = 3 if mode == 4 or longest == 13 else 40
    lengths = np.full(400, per_row)
    lengths[7] = longest
    rows = np.repeat(np.arange(400), lengths)
    cols = np.concatenate([np.arange(k) for k in lengths])
    a = CSRMatrix.from_coo(400, 200, rows, cols, np.ones(rows.size), device="cpu")
    assert E.fused_lanes(a.dev) == mode


def test_launcher_signatures_match_the_cuda_source():
    """Every launcher's ctypes argtypes follow its C parameters: c_void_p
    for each pointer and the stream (a missing declaration would pass a
    64-bit pointer as a 32-bit int), c_int for each int."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        src = path.read_text()
        block = src[src.index('extern "C" {'):]
        launchers = dict(re.findall(r"^int (\w+)\(([^)]*)\)", block, flags=re.M))
        assert launchers and not set(launchers) & set(found), path.name
        found.update(launchers)
    assert {"seg_spmv.cu", "panel_spmv.cu"} <= {
        p.name for p in _build.CSRC.glob("*.cu")}
    assert sorted(found) == sorted(_build.SIGNATURES)
    for name, params in found.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",") if p.strip()]  # () takes none
        assert list(_build.SIGNATURES[name]) == kinds, name


def test_a_library_name_follows_its_source_and_the_headers(tmp_path):
    """An edited header gives every source a new library name, so the
    build that includes it cannot be loaded stale."""
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._so_path(src, tmp_path)
    assert _build._so_path(src, tmp_path) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._so_path(src, tmp_path) != first
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {"seg_tile.cuh", "x_rows.cuh",
                                                            "panel_tile.cuh"}


def test_build_failures_raise(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("int main() { return 0; }\n")
    refusing = tmp_path / "nvcc"
    refusing.write_text("#!/bin/sh\necho 'fatal: refused' >&2\nexit 2\n")
    refusing.chmod(0o755)
    out = tmp_path / "build"
    with pytest.raises(_build.BuildError, match="refused"):
        _build.build([src], out, nvcc=str(refusing))
    assert not list(out.glob("*.so"))  # nothing half-built is left to load
    with pytest.raises(_build.BuildError, match="cannot run"):
        _build.build([src], out, nvcc=str(tmp_path / "missing-nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.nvcc_path()

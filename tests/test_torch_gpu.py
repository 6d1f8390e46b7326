"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on a CUDA card. Skipped without one (the decision is made in the
``cuda`` fixture, at run time).

    pytest -m gpu tests/test_torch_gpu.py      # on a machine with a card
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from spmv_tpu_torch import CSRMatrix, EllMatrix, SellMatrix, X2Matrix, synth
from spmv_tpu_torch.formats.base import build_csr_plan, build_panel_plan, csr_ptr
from spmv_tpu_torch.device import DevCsr, DevPanel
from spmv_tpu_torch.kernels import _build
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X2
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.oracle import KERNEL_TOL_ABS, fp32_rel_tol, row_scale
from spmv_tpu_torch.probes.common import MATRICES as MATRICES_OF_PROBES
from spmv_tpu_torch.probes.common import (PANEL_SHAPES, TILE_SHAPES, tile_sum_bound,
                                          unread_column)
from spmv_tpu_torch.probes.turns import TURN_MATRICES, forced_split

pytestmark = pytest.mark.gpu

MATRICES = {
    **{n: (lambda n=n: synth.edge_case(n)) for n in sorted(synth.EDGE_CASES)},
    "band_1024": lambda: synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                              bandwidth=60, seed=5),
    "power_law_32768": lambda: synth.power_law(n=32768, seed=1),
    "cant_8192": lambda: synth.synthetic_cant(n=8192),
    # a tile of 1024 one-nonzero rows, tiles over the row-offset stage's cap
    # (K1 and K12 read ptr in global memory there), a hub row over six tiles
    **TILE_SHAPES,
    # the panel tile kernel's cases: empty slices at tile starts and ends, a
    # slice per tile, a hub slice, one-column slices, a cut last slice
    **PANEL_SHAPES,
}


def used(dev, carry):
    """The carry slots of a CSR plan that a split row uses
    (``engines.carry_slot_rows``): the tile kernel writes no other, and its
    wrapper does not clear them."""
    return carry[E.carry_slot_rows(dev) >= 0]


def same_partials(dev, a, b) -> bool:
    """Two ``(y, carry)`` of the tile kernel bit for bit: y, and the carry
    slots a split row uses."""
    return torch.equal(a[0], b[0]) and torch.equal(used(dev, a[1]), used(dev, b[1]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def setup(name, device):
    info, r, c, v = MATRICES[name]()
    a = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device=device)
    xh = np.random.default_rng(5).standard_normal(info.ncols).astype(np.float32)
    scale = torch.from_numpy(row_scale(info.nrows, r, c, v.astype(np.float32), xh))
    bound = KERNEL_TOL_ABS + fp32_rel_tol(a.dev.max_row_nnz) * scale.to(device)
    return a.dev, torch.from_numpy(xh).to(device), bound


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernels_match_plain_versions_and_repeat_bitwise(cuda, name):
    dev, x, bound = setup(name, cuda)
    y1, carry = E.segmented_spmv_partials(dev, x)
    assert same_partials(dev, (y1, carry), E.segmented_spmv_partials(dev, x))
    y = E.carry_fixup(dev, y1.clone(), carry)
    assert torch.equal(y, E.carry_fixup(dev, y1.clone(), carry))
    y_plain = E.carry_fixup_reference(dev, *E.segmented_spmv_partials_reference(dev, x))
    assert ((y.double() - y_plain.double()).abs() <= bound).all()
    y3 = E.segmented_spmv_fused(dev, x)
    assert torch.equal(y3, E.segmented_spmv_fused(dev, x))
    if E.fused_lanes(dev) == 0:  # K3's tiles: K1 + K2, bit for bit
        assert torch.equal(y3, y)
    y3_plain = E.segmented_spmv_fused_reference(dev, x)
    assert ((y3.double() - y3_plain.double()).abs() <= bound).all()
    torch.cuda.synchronize()


def setup_panel(name, device):
    """The pure-panel SELL build (σ-sorted where the sort shrinks the
    panel) of a matrix: its panel plan, K7's table, x and the row bound."""
    info, r, c, v = MATRICES[name]()
    a = SellMatrix.from_coo(info.nrows, info.ncols, r, c, v, sigma=128,
                            split=False, device=device)
    xh = np.random.default_rng(6).standard_normal(info.ncols).astype(np.float32)
    scale = row_scale(info.nrows, r, c, v.astype(np.float32), xh)
    k = max(a.dev.max_width, 1)
    scale_sorted = np.zeros(a.dev.nrows)
    scale_sorted[np.argsort(a.perm)[:info.nrows]] = scale  # sorted row space
    bound = KERNEL_TOL_ABS + fp32_rel_tol(k) * torch.from_numpy(scale_sorted).to(device)
    return a, torch.from_numpy(xh).to(device), bound


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_panel_kernels_match_plain_versions_and_repeat_bitwise(cuda, name):
    a, x, bound = setup_panel(name, cuda)
    dev = a.dev
    y4, part = P.panel_spmv_partials(dev, x)
    y4b, partb = P.panel_spmv_partials(dev, x)
    assert torch.equal(y4, y4b) and torch.equal(part, partb)
    y4_plain, _ = P.panel_spmv_partials_reference(dev, x)
    assert ((y4.double() - y4_plain.double()).abs() <= bound).all()
    y = P.panel_fixup(dev, y4.clone(), part)
    assert torch.equal(y, P.panel_fixup(dev, y4.clone(), part))
    y_plain = P.panel_fixup_reference(dev, *P.panel_spmv_partials_reference(dev, x))
    assert ((y.double() - y_plain.double()).abs() <= bound).all()
    y6 = P.panel_spmv_fused(dev, x)
    assert torch.equal(y6, P.panel_spmv_fused(dev, x))
    assert ((y6.double() - P.panel_spmv_fused_reference(dev, x).double()).abs()
            <= bound).all()
    if a.sorted_rows:
        y7 = P.inverse_permute(a.invperm_dev, y6, a.nrows)
        assert torch.equal(y7, P.inverse_permute_reference(a.invperm_dev, y6, a.nrows))
    torch.cuda.synchronize()


def test_each_launch_counts_once(cuda):
    dev, x, _ = setup("band_1024", cuda)
    a, xp, _ = setup_panel("power_law_32768", cuda)
    assert a.sorted_rows
    E.reset_launches()
    y, carry = E.segmented_spmv_partials(dev, x)
    E.carry_fixup(dev, y, carry)
    E.segmented_spmv_fused(dev, x)
    E.segmented_spmv_partials_reference(dev, x)
    E.segmented_spmv_fused_reference(dev, x)
    yp, part = P.panel_spmv_partials(a.dev, xp)
    P.panel_fixup(a.dev, yp, part)
    y6 = P.panel_spmv_fused(a.dev, xp)
    P.inverse_permute(a.invperm_dev, y6, a.nrows)
    P.panel_spmv_fused_reference(a.dev, xp)
    P.inverse_permute_reference(a.invperm_dev, y6, a.nrows)
    X = torch.stack([x, x], dim=1)
    Xp = torch.stack([xp, xp], dim=1)
    E.segmented_spmv_multi(dev, X)
    E.carry_fixup_multi_reference(dev, *E.segmented_spmv_multi_partials_reference(dev, X))
    P.panel_spmv_multi(a.dev, Xp)
    P.panel_fixup_multi_reference(a.dev, *P.panel_spmv_multi_partials_reference(a.dev, Xp))
    dev64, pdev64, x64 = setup_x2("band_1024", cuda)
    X2.segmented_spmv_x2(dev64, x64)
    X2.carry_fixup_x2_reference(dev64, *X2.segmented_spmv_x2_partials_reference(dev64, x64))
    X2.panel_spmv_x2(pdev64, x64)
    X2.panel_fixup_x2_reference(pdev64, *X2.panel_spmv_x2_partials_reference(pdev64, x64))
    c16 = KP.cols16(dev)
    KP.segmented_spmv_partials_u16(dev, c16, x)
    KP.segmented_spmv_partials_u16(dev64, c16, x64)
    KP.segmented_spmv_partials_u16_reference(dev, c16, x)
    for tile in KP.PROBE_TILES:
        dt = KP.retile(dev, tile)
        KP.carry_fixup_at(dt, *KP.segmented_spmv_partials_at(dt, x))
    for d, xx in ((dev, x), (dev64, x64)):
        KP.ablate_nogather(d)
        KP.ablate_noseg(d.vals, d.cols, xx)
        KP.ablate_dma(d.vals, d.cols)
        KP.ablate_dma_reference(d.vals, d.cols)
    KP.ablate_x32(dev64, x64.float())
    KP.panel_ablate_nogather(a.dev)
    KP.panel_ablate_nogather(pdev64)
    KP.panel_ablate_nogather_reference(a.dev)
    KP.segmented_spmv_fold(dev, x)
    KP.segmented_spmv_fold_reference(dev, x)
    KP.launch_floor(cuda)
    # K7: the gather, and its identity mode after K4, K10 and K14 where the
    # panel has split slices (panel_fixup, panel_spmv_multi, panel_spmv_x2)
    k7 = 1 + 2 * bool(a.dev.nsplit) + bool(pdev64.nsplit)
    assert E.LAUNCHES == {k: 1 for k in (
        "seg_spmv_tiles", "carry_fixup", "csr_spmv_fused", "panel_spmv_tiles",
        "panel_spmv_fused", "seg_spmm_tiles", "carry_fixup_multi", "panel_spmm_tiles",
        "seg_spmv_tiles_x2", "carry_fixup_x2", "panel_spmv_tiles_x2",
        "seg_spmv_tiles_u16", "seg_spmv_tiles_u16_x2",
        "seg_spmv_tiles_t128", "seg_spmv_tiles_t512", "seg_spmv_tiles_t2048",
        "carry_fixup_t128", "carry_fixup_t512", "carry_fixup_t2048",
        "seg_ablate_nogather", "seg_ablate_noseg", "seg_ablate_dma",
        "seg_ablate_x2_nogather", "seg_ablate_x2_noseg", "seg_ablate_x2_dma",
        "seg_ablate_x2_x32", "panel_ablate_nogather", "panel_ablate_x2_nogather",
        "seg_spmv_tiles_fold", "launch_floor")} | {"inverse_permute": k7}


def test_empty_plans_launch_nothing(cuda):
    dev, x, _ = setup("all_empty", cuda)
    info, r, c, v = MATRICES["all_empty"]()
    panel = EllMatrix.from_coo(info.nrows, info.ncols, r, c, v, split=False,
                               device=cuda).dev
    E.reset_launches()
    y, carry = E.segmented_spmv_partials(dev, x)
    assert E.carry_fixup(dev, y, carry).tolist() == [0.0] * dev.nrows
    assert E.segmented_spmv_fused(dev, x).tolist() == [0.0] * dev.nrows
    yp, part = P.panel_spmv_partials(panel, x)
    assert P.panel_fixup(panel, yp, part).tolist() == [0.0] * dev.nrows
    assert P.panel_spmv_fused(panel, x).tolist() == [0.0] * dev.nrows
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    assert P.inverse_permute(empty, torch.zeros(0, device=cuda), 0).numel() == 0
    assert P.inverse_permute(empty, torch.zeros(0, 4, device=cuda), 0).shape == (0, 4)
    X = torch.ones(dev.ncols, 4, device=cuda)
    assert not E.segmented_spmv_multi(dev, X).any()
    assert not P.panel_spmv_multi(panel, X).any()
    dev64, pdev64, x64 = setup_x2("all_empty", cuda)
    assert X2.segmented_spmv_x2(dev64, x64).tolist() == [0.0] * dev.nrows
    assert X2.panel_spmv_x2(pdev64, x64).tolist() == [0.0] * dev.nrows
    assert X2.inverse_permute_x2(empty, torch.zeros(0, dtype=torch.float64,
                                                    device=cuda), 0).numel() == 0
    assert set(E.LAUNCHES.values()) == {0}


def test_refused_launch_raises(cuda):
    info, r, c, v = synth.edge_case("ragged")
    order = np.lexsort((c, r))
    a = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="cpu")
    dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, a.ptr,
                                          c[order], v[order], tile=16), cuda)
    x = torch.ones(info.ncols, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        E.segmented_spmv_partials(dev, x)
    # the launcher itself refuses a tile it was not built for
    lib = _build.library().lib
    y = torch.zeros(dev.nrows, device=cuda)
    carry = torch.zeros(2 * dev.ntiles, device=cuda)
    rc = lib.seg_spmv_tiles(dev.ptr.data_ptr(), dev.cols.data_ptr(),
                            dev.vals.data_ptr(), dev.tile_row0.data_ptr(),
                            x.data_ptr(), y.data_ptr(), carry.data_ptr(),
                            dev.nnz, dev.ntiles, dev.tile,
                            torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    # and so do K3's wrapper and launcher
    with pytest.raises(ValueError, match="tile"):
        E.segmented_spmv_fused(dev, x)
    rc = lib.csr_spmv_fused(dev.ptr.data_ptr(), dev.cols.data_ptr(),
                            dev.vals.data_ptr(), dev.tile_row0.data_ptr(),
                            x.data_ptr(), y.data_ptr(), dev.fused_words.data_ptr(),
                            dev.nnz, dev.ntiles, dev.nrows, dev.tile, 0,
                            torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    # and lanes per row it was not built for
    good = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device=cuda).dev
    rc = lib.csr_spmv_fused(good.ptr.data_ptr(), good.cols.data_ptr(),
                            good.vals.data_ptr(), good.tile_row0.data_ptr(),
                            x.data_ptr(), y.data_ptr(), good.fused_words.data_ptr(),
                            good.nnz, good.ntiles, good.nrows, good.tile, 64,
                            torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    # K8 is built for R = 2..8 only
    X = torch.ones(good.ncols, 9, device=cuda)
    Y = torch.zeros(good.nrows, 9, device=cuda)
    carry = torch.zeros(2 * good.ntiles, 9, device=cuda)
    rc = lib.seg_spmm_tiles(good.ptr.data_ptr(), good.cols.data_ptr(),
                            good.vals.data_ptr(), good.tile_row0.data_ptr(),
                            X.data_ptr(), Y.data_ptr(), carry.data_ptr(),
                            good.nnz, good.ntiles, good.tile, 9,
                            torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_refused_panel_launch_raises(cuda):
    info, r, c, v = synth.edge_case("ragged")
    order = np.lexsort((c, r))
    dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r[order],
                                              c[order], v[order], tile=3), cuda)
    x = torch.ones(info.ncols, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        P.panel_spmv_partials(dev, x)
    lib = _build.library().lib
    y = torch.zeros(dev.nrows, device=cuda)
    part = torch.zeros(2 * dev.ntiles, 32, device=cuda)
    rc = lib.panel_spmv_tiles(dev.slice_ptr.data_ptr(), dev.cols.data_ptr(),
                              dev.vals.data_ptr(), dev.tile_slice0.data_ptr(),
                              dev.tile_own0.data_ptr(), x.data_ptr(), y.data_ptr(),
                              part.data_ptr(), dev.nslots // 32, dev.ntiles, dev.tile,
                              dev.nrows, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def poison(*shapes, dtype, device):
    """Fill blocks of these shapes with NaN and free them: the caching
    allocator hands them to the next allocations of the same sizes, so a
    row or slot that a kernel leaves unwritten reads NaN."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device=device)
              for shape in shapes]
    del blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_panel_tile_kernel_writes_every_row_and_slot(cuda, name, dtype):
    """K4 and K14 on each panel shape (the plan as built, no σ-sort): twice
    with the same bits into NaN-poisoned allocations, against the plain
    version per entry, the launcher itself into NaN-filled y and partials
    (every row and slot written, with the wrapper's bits), and the path
    with K7's fix-up against the plain path."""
    info, r, c, v = PANEL_SHAPES[name](1)
    f32 = dtype == torch.float32
    v = v if f32 else v * (1 + 1e-9 * np.arange(v.size))
    dev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                              dtype=np.float32 if f32 else np.float64),
                             cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(info.ncols)).to(
        dtype).to(cuda)
    tiles, fixup, kname = ((P.panel_spmv_partials, P.panel_fixup, "panel_spmv_tiles")
                           if f32 else (X2.panel_spmv_x2_partials, X2.panel_fixup_x2,
                                        "panel_spmv_tiles_x2"))
    outs = []
    for _ in range(2):
        poison((dev.nrows,), (2 * dev.ntiles, 32), dtype=dtype, device=cuda)
        outs.append(tiles(dev, x))
    (y, part), (yb, partb) = outs
    assert torch.equal(y, yb) and torch.equal(part, partb)
    # per entry: the plain version of the same sums, and of their magnitudes
    y_plain, part_plain = P.panel_spmv_partials_reference(dev, x)
    y_abs, part_abs = P.panel_spmv_partials_reference(
        dataclasses.replace(dev, vals=dev.vals.abs()), x.abs())
    k = max(dev.max_width, 1)

    def bound(scale):
        return (KERNEL_TOL_ABS + fp32_rel_tol(k) * scale.double() if f32
                else k * 2.0 ** -50 * scale)

    assert ((y.double() - y_plain.double()).abs() <= bound(y_abs)).all()
    assert ((part.double() - part_plain.double()).abs() <= bound(part_abs)).all()
    y_nan, part_nan = torch.full_like(y, float("nan")), torch.full_like(part, float("nan"))
    lib = _build.library().lib
    assert getattr(lib, kname)(dev.slice_ptr.data_ptr(), dev.cols.data_ptr(),
                               dev.vals.data_ptr(), dev.tile_slice0.data_ptr(),
                               dev.tile_own0.data_ptr(), x.data_ptr(), y_nan.data_ptr(),
                               part_nan.data_ptr(), dev.nslots // 32, dev.ntiles,
                               dev.tile, dev.nrows,
                               torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(y_nan, y) and torch.equal(part_nan, part)
    yp = fixup(dev, y.clone(), part)
    yp_plain = P.panel_fixup_reference(dev, y_plain.clone(), part_plain)
    yp_abs = P.panel_fixup_reference(dev, y_abs.clone(), part_abs)
    assert ((yp.double() - yp_plain.double()).abs() <= bound(yp_abs)).all()


# ---------------------------------------------------------------- R > 1


def columns_bound(info, r, c, v, Xh, max_nnz, perm=None, nrows_plan=None):
    """Per-entry bound of an (nrows, R) result: each column's row scale,
    moved to the plan's sorted row space when ``perm`` is given."""
    scale = np.stack([row_scale(info.nrows, r, c, v.astype(np.float32), Xh[:, j])
                      for j in range(Xh.shape[1])], axis=1)
    if perm is not None:
        sorted_scale = np.zeros((nrows_plan, Xh.shape[1]))
        sorted_scale[np.argsort(perm)[:info.nrows]] = scale
        scale = sorted_scale
    return KERNEL_TOL_ABS + fp32_rel_tol(max(max_nnz, 1)) * torch.from_numpy(scale)


def unaligned_copy(X):
    """X at an address 4 bytes past a 16-byte boundary: K8 and K10 then
    load its rows with scalar loads."""
    buf = torch.empty(X.numel() + 1, device=X.device)
    Xu = buf[1:].view(X.shape)
    Xu.copy_(X)
    assert Xu.is_contiguous() and Xu.data_ptr() % 16 == 4
    return Xu


@pytest.mark.parametrize("R", [2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_multi_kernels_match_plain_versions_and_repeat_bitwise(cuda, name, R):
    """K8 + K9 on the CSR plan, K10 + K7's fix-up on the pure SELL panel,
    and K7 over rows of R: against their plain versions, twice with the same
    bits, and column j against the one-vector kernels on X[:, j]."""
    info, r, c, v = MATRICES[name]()
    Xh = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(np.float32)
    X = torch.from_numpy(Xh).to(cuda)
    dev = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device=cuda).dev
    bound = columns_bound(info, r, c, v, Xh, dev.max_row_nnz).to(cuda)
    Y8, c8 = E.segmented_spmv_multi_partials(dev, X)
    assert same_partials(dev, (Y8, c8), E.segmented_spmv_multi_partials(dev, X))
    Y = E.carry_fixup_multi(dev, Y8.clone(), c8)
    assert torch.equal(Y, E.carry_fixup_multi(dev, Y8.clone(), c8))
    Y_plain = E.carry_fixup_multi_reference(
        dev, *E.segmented_spmv_multi_partials_reference(dev, X))
    assert ((Y.double() - Y_plain.double()).abs() <= bound).all()
    assert torch.equal(E.segmented_spmv_multi(dev, unaligned_copy(X)), Y)
    for j in range(R):
        y1, c1 = E.segmented_spmv_partials(dev, X[:, j].contiguous())
        assert same_partials(dev, (Y8[:, j], c8[:, j]), (y1, c1))

    a = SellMatrix.from_coo(info.nrows, info.ncols, r, c, v, sigma=128,
                            split=False, device=cuda)
    pdev = a.dev
    pbound = columns_bound(info, r, c, v, Xh, pdev.max_width, a.perm,
                           pdev.nrows).to(cuda)
    Y10, p10 = P.panel_spmv_multi_partials(pdev, X)
    Y10b, p10b = P.panel_spmv_multi_partials(pdev, X)
    assert torch.equal(Y10, Y10b) and torch.equal(p10, p10b)
    if pdev.nslots:  # K10 writes every row of Y and every partial slot: its
        # launcher into NaN-filled outputs gives the wrapper's bits
        Y_nan, p_nan = (torch.full_like(t, float("nan")) for t in (Y10, p10))
        assert _build.library().lib.panel_spmm_tiles(
            pdev.slice_ptr.data_ptr(), pdev.cols.data_ptr(), pdev.vals.data_ptr(),
            pdev.tile_slice0.data_ptr(), pdev.tile_own0.data_ptr(), X.data_ptr(),
            Y_nan.data_ptr(), p_nan.data_ptr(), pdev.nslots // 32, pdev.ntiles,
            pdev.tile, pdev.nrows, R, torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(Y_nan, Y10) and torch.equal(p_nan, p10)
    Ys = P.panel_fixup_multi(pdev, Y10.clone(), p10)
    assert torch.equal(Ys, P.panel_fixup_multi(pdev, Y10.clone(), p10))
    Ys_plain = P.panel_fixup_multi_reference(
        pdev, *P.panel_spmv_multi_partials_reference(pdev, X))
    assert ((Ys.double() - Ys_plain.double()).abs() <= pbound).all()
    assert torch.equal(P.panel_spmv_multi(pdev, unaligned_copy(X)), Ys)
    for j in range(R):
        y4, p4 = P.panel_spmv_partials(pdev, X[:, j].contiguous())
        assert torch.equal(Y10[:, j], y4) and torch.equal(p10[..., j], p4)
    if a.sorted_rows:
        Y7 = P.inverse_permute(a.invperm_dev, Ys, a.nrows)
        assert Y7.shape == (a.nrows, R)
        assert torch.equal(Y7, P.inverse_permute_reference(a.invperm_dev, Ys, a.nrows))
    torch.cuda.synchronize()


@pytest.mark.parametrize("fmt", ["csr", "ell", "sell", "hyb", "bsr"])
def test_spmm_on_the_card_passes_the_oracle(cuda, fmt):
    """``spmm`` end to end at R = 4 (and BSR at R = 32, twice with the same
    bits) on the 8192-row cant-like matrix."""
    import spmv_tpu_torch
    from spmv_tpu_torch.oracle import golden_spmv, kernel_check

    info, r, c, v = MATRICES["cant_8192"]()
    R = 32 if fmt == "bsr" else 4
    Xh = np.random.default_rng(1).standard_normal((info.ncols, R)).astype(np.float32)
    a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device=cuda)
    Y = spmv_tpu_torch.spmm(a, Xh)
    assert Y.device.type == "cuda" and Y.shape == (info.nrows, R)
    if fmt == "bsr":
        assert torch.equal(Y, spmv_tpu_torch.spmm(a, Xh))
    k = int(np.bincount(r, minlength=info.nrows).max())
    for j in range(R):
        rep = kernel_check(golden_spmv(info.nrows, r, c, v, Xh[:, j]), Y[:, j].cpu().numpy(),
                           row_scale(info.nrows, r, c, v, Xh[:, j]), k)
        assert rep.ok, (j, rep)


# ---------------------------------------------------------------- fp64 (x2)


def setup_x2(name, device):
    """A matrix's fp64 CSR plan and fp64 panel (row order, no split), and
    an fp64 x with content below f32's mantissa."""
    info, r, c, v = MATRICES[name]()
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = np.asarray(v, np.float64)[order] * (1 + 1e-9 * np.arange(r.size))
    dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, csr_ptr(r, info.nrows),
                                          c, v, dtype=np.float64), device)
    pdev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r, c, v,
                                               dtype=np.float64), device)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(info.ncols)).to(device)
    return dev, pdev, x


def x2_bound(dev, x, k):
    """``k·2⁻⁵⁰·Σ|v||x|`` per row of a plan: the kernel and its plain
    version both sum each row in fp64, in different orders."""
    ref = E.carry_fixup_reference(
        dev, *E.segmented_spmv_partials_reference(
            DevCsr(dev.ptr, dev.cols, dev.vals.abs(), dev.tile_row0,
                   dev.carry_rows, dev.nrows, dev.ncols, dev.tile,
                   dev.max_row_nnz), x.abs()))
    return max(k, 1) * 2.0 ** -50 * ref


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_x2_kernels_match_plain_versions_and_repeat_bitwise(cuda, name):
    """K12 + K13 on the fp64 CSR plan and K14 + K7's fix-up on the fp64
    panel:
    twice with the same bits, and within k·2⁻⁵⁰·Σ|v||x| of the plain
    versions."""
    dev, pdev, x = setup_x2(name, cuda)
    bound = x2_bound(dev, x, dev.max_row_nnz)
    y12, c12 = X2.segmented_spmv_x2_partials(dev, x)
    assert y12.dtype == c12.dtype == torch.float64
    assert same_partials(dev, (y12, c12), X2.segmented_spmv_x2_partials(dev, x))
    y = X2.carry_fixup_x2(dev, y12.clone(), c12)
    assert torch.equal(y, X2.carry_fixup_x2(dev, y12.clone(), c12))
    y_plain = X2.carry_fixup_x2_reference(
        dev, *X2.segmented_spmv_x2_partials_reference(dev, x))
    assert ((y - y_plain).abs() <= bound).all()
    y14, p14 = X2.panel_spmv_x2_partials(pdev, x)
    y14b, p14b = X2.panel_spmv_x2_partials(pdev, x)
    assert torch.equal(y14, y14b) and torch.equal(p14, p14b)
    yp = X2.panel_fixup_x2(pdev, y14.clone(), p14)
    assert torch.equal(yp, X2.panel_fixup_x2(pdev, y14.clone(), p14))
    yp_plain = X2.panel_fixup_x2_reference(
        pdev, *X2.panel_spmv_x2_partials_reference(pdev, x))
    pbound = x2_bound(dev, x, max(pdev.max_width, 1))
    assert ((yp - yp_plain).abs() <= pbound).all()
    assert ((yp - y).abs() <= pbound).all()  # both engines, the same rows
    torch.cuda.synchronize()


def test_x2_gather_is_a_bit_copy(cuda):
    import spmv_tpu_torch

    info, r, c, v = MATRICES["band_1024"]()
    a = spmv_tpu_torch.X2Matrix.from_coo("sell", info.nrows, info.ncols, r, c, v,
                                         device=cuda)
    assert a.sorted_rows
    rng = np.random.default_rng(5)
    yh = rng.standard_normal(a.dev.nrows) * 2.0 ** rng.integers(-1070, 1000, a.dev.nrows)
    y_sorted = torch.from_numpy(yh).to(cuda)
    E.reset_launches()
    got = X2.inverse_permute_x2(a.invperm_dev, y_sorted, a.nrows)
    assert E.LAUNCHES["inverse_permute"] == 1
    want = y_sorted[a.invperm_dev[:a.nrows].long()]
    assert got.dtype == torch.float64
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
    ref = X2.inverse_permute_x2_reference(a.invperm_dev, y_sorted, a.nrows)
    assert got.cpu().numpy().tobytes() == ref.cpu().numpy().tobytes()


@pytest.mark.parametrize("fmt", ["csr", "coo", "cmrs", "ell", "sell", "hyb"])
def test_x2_matvec_on_the_card(cuda, fmt):
    """``X2Matrix.matvec`` on the 8192-row cant-like matrix: fp64 y within
    the fp64 bound of the oracle, through the fp64 kernels only."""
    import spmv_tpu_torch
    from spmv_tpu_torch.oracle import golden_spmv, x2_check

    info, r, c, v = MATRICES["cant_8192"]()
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
    xh = np.random.default_rng(8).standard_normal(info.ncols)
    a = spmv_tpu_torch.X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v,
                                         device=cuda)
    E.reset_launches()
    y = a.matvec(xh)
    assert y.dtype == torch.float64 and y.device.type == "cuda"
    ran = {k for k, n in E.LAUNCHES.items() if n}
    assert ran and ran <= {"seg_spmv_tiles_x2", "carry_fixup_x2",
                           "panel_spmv_tiles_x2", "inverse_permute"}, ran
    scale = row_scale(info.nrows, r, c, v, xh)
    k = int(np.bincount(r, minlength=info.nrows).max())
    err = np.abs(y.cpu().numpy() - golden_spmv(info.nrows, r, c, v, xh))
    assert (err <= k * 2.0 ** -50 * scale).all()
    assert x2_check(golden_spmv(info.nrows, r, c, v, xh), y.cpu().numpy(), scale).ok
    Y = spmv_tpu_torch.spmm(a, np.stack([xh, -xh], axis=1))
    assert Y.dtype == torch.float64 and torch.equal(Y[:, 0], y)


def test_refused_x2_launch_raises(cuda):
    info, r, c, v = synth.edge_case("ragged")
    order = np.lexsort((c, r))
    a = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="cpu")
    dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, a.ptr, c[order],
                                          v[order], tile=16, dtype=np.float64), cuda)
    x = torch.ones(info.ncols, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="tile"):
        X2.segmented_spmv_x2_partials(dev, x)
    lib = _build.library().lib
    y = torch.zeros(dev.nrows, dtype=torch.float64, device=cuda)
    carry = torch.zeros(2 * dev.ntiles, dtype=torch.float64, device=cuda)
    rc = lib.seg_spmv_tiles_x2(dev.ptr.data_ptr(), dev.cols.data_ptr(),
                               dev.vals.data_ptr(), dev.tile_row0.data_ptr(),
                               x.data_ptr(), y.data_ptr(), carry.data_ptr(),
                               dev.nnz, dev.ntiles, dev.tile,
                               torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    pdev = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r[order],
                                               c[order], v[order], tile=3,
                                               dtype=np.float64), cuda)
    with pytest.raises(ValueError, match="tile"):
        X2.panel_spmv_x2_partials(pdev, x)


def test_a_conversion_error_returns_program_error_on_the_card(cuda, tmp_path, capsys):
    """The CLI's code for a matrix the format refuses, on the CUDA route:
    the BSR fill guard on a 40,000-row diagonal (``test_torch_cli.py``)."""
    from spmv_tpu_torch import cli
    from spmv_tpu_torch.errors import ReturnCode

    n = 40_000
    path = tmp_path / "diag.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    f"{n} {n} {n}\n"
                    + "\n".join(f"{k} {k} 1.5" for k in range(1, n + 1)) + "\n")
    assert cli.main(["run", "--format", "bsr", "--matrix", str(path)]) == \
        ReturnCode.PROGRAM_ERROR
    assert cli.main(["run", "--format", "bsr", "--dtype", "f32x2", "--matrix",
                     str(path)]) == ReturnCode.PROGRAM_ERROR
    assert "error:" in capsys.readouterr().err


# ---------------------------------------------------------------- fix-ups


# The matrices ``probes.turns`` times K1 + K2 and K12 + K13 on (cant,
# pl_big, pl_wide, band-1024), and the extremes of the tile kernel's stage
FIXUP_MATRICES = {**{f"turns_{n}": MATRICES_OF_PROBES[n] for n in TURN_MATRICES},
                  **TILE_SHAPES}


@functools.cache
def fixup_plans(name):
    """A matrix of ``FIXUP_MATRICES`` as float32 and float64 CSR plans on
    the card, with x of each type (cached: the 524k-row ones take seconds
    to build)."""
    info, r, c, v = FIXUP_MATRICES[name]()
    dev = CSRMatrix.from_coo(info.nrows, info.ncols, r, c, v, device="cuda").dev
    dev64 = X2Matrix.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cuda").dev
    xh = np.random.default_rng(9).standard_normal(info.ncols)
    return dev, dev64, torch.from_numpy(xh).float().cuda(), torch.from_numpy(xh).cuda()


def fixup_of_nan_carry(launcher, dev, x, fixup):
    """The tile launcher itself (K1, K12, K8 with x an (ncols, R) X) into a
    zero-filled y and a NaN-filled carry, then the fix-up's wrapper: a slot
    the fix-up reads and the tile kernel leaves unwritten stays NaN."""
    tail = tuple(x.shape[1:])
    y = torch.zeros((dev.nrows, *tail), dtype=x.dtype, device=x.device)
    carry = torch.full((2 * dev.ntiles, *tail), float("nan"), dtype=x.dtype,
                       device=x.device)
    assert getattr(_build.library().lib, launcher)(
        dev.ptr.data_ptr(), dev.cols.data_ptr(), dev.vals.data_ptr(),
        dev.tile_row0.data_ptr(), x.data_ptr(), y.data_ptr(), carry.data_ptr(),
        dev.nnz, dev.ntiles, dev.tile, *tail,
        torch.cuda.current_stream().cuda_stream) == 0
    return fixup(dev, y, carry)


@pytest.mark.parametrize("name", sorted(FIXUP_MATRICES))
def test_fixups_read_only_the_carry_slots_the_tile_kernel_writes(cuda, name):
    """K1 → K2 and K12 → K13 with the tile launcher writing into a
    NaN-filled carry give the wrappers' y bit for bit; two runs of the
    tile kernel agree on every used slot."""
    dev, dev64, x, x64 = fixup_plans(name)
    for tiles, fixup, launcher, d, xx in (
            (E.segmented_spmv_partials, E.carry_fixup, "seg_spmv_tiles", dev, x),
            (X2.segmented_spmv_x2_partials, X2.carry_fixup_x2, "seg_spmv_tiles_x2",
             dev64, x64)):
        part = tiles(d, xx)
        assert same_partials(d, part, tiles(d, xx))
        want = fixup(d, part[0].clone(), part[1])
        assert torch.equal(fixup_of_nan_carry(launcher, d, xx, fixup), want)
        assert not want.isnan().any()
    torch.cuda.synchronize()


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(FIXUP_MATRICES))
def test_multi_fixup_reads_only_the_carry_slots_k8_writes(cuda, name, R):
    """K8 → K9 with K8's launcher writing into a NaN-filled carry gives
    the wrappers' Y bit for bit."""
    dev, _, _, _ = fixup_plans(name)
    X = torch.from_numpy(np.random.default_rng(R).standard_normal(
        (dev.ncols, R)).astype(np.float32)).cuda()
    want = E.segmented_spmv_multi(dev, X)
    got = fixup_of_nan_carry("seg_spmm_tiles", dev, X, E.carry_fixup_multi)
    assert torch.equal(got, want) and not want.isnan().any()
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["turns_cant", "turns_band", "hub_row",
                                  "empty_row_gaps"])
def test_fixup_paths_in_a_cuda_graph_equal_the_eager_run(cuda, name):
    """K1 + K2, K12 + K13 and K8 + K9 captured in a CUDA graph (the fix-up
    a programmatic dependent launch there too) and replayed give the eager
    run's bits."""
    dev, dev64, x, x64 = fixup_plans(name)
    X = torch.stack([x, -x, 2 * x, x * x], dim=1)
    paths = {"K1 + K2": (lambda d, xx: E.carry_fixup(d, *E.segmented_spmv_partials(d, xx)),
                         dev, x),
             "K12 + K13": (X2.segmented_spmv_x2, dev64, x64),
             "K8 + K9": (E.segmented_spmv_multi, dev, X)}
    for what, (path, d, xx) in paths.items():
        eager = path(d, xx)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # a call before capture, as CUDA graphs ask
            path(d, xx)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = path(d, xx)
        for _ in range(3):
            out.fill_(float("nan"))
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), what


def fused_mode(dev, x, vec):
    """K3's launcher in one mode (vec 0: K1's tiles; 4-32: lanes per row),
    outside its wrapper, into a NaN-filled y: a row it leaves unwritten
    stays NaN."""
    y = torch.full((dev.nrows,), float("nan"), device=x.device)
    assert _build.library().lib.csr_spmv_fused(
        dev.ptr.data_ptr(), dev.cols.data_ptr(), dev.vals.data_ptr(),
        dev.tile_row0.data_ptr(), x.data_ptr(), y.data_ptr(), dev.fused_words.data_ptr(),
        dev.nnz, dev.ntiles, dev.nrows, dev.tile, vec,
        torch.cuda.current_stream().cuda_stream) == 0
    return y


@pytest.mark.parametrize("name", sorted(FIXUP_MATRICES))
def test_k3_is_k1_k2_bits_eager_and_in_a_cuda_graph(cuda, name):
    """K3's tiles, on any plan (cant, pl_big and pl_wide have more tiles
    than the card holds blocks, so its blocks walk several), give K1 + K2's
    y bit for bit into a NaN-filled y, twice; so does K3 itself wherever it
    picks its tiles (every plan here with a long row), and its sub-warp
    mode, where it picks that, writes every row. K3 gives its eager bits in
    3 replays of one captured graph. The published words are 0 again after
    every launch, and they are no part of the plan's bytes."""
    dev, _, x, _ = fixup_plans(name)
    want = E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x))
    for _ in range(2):
        assert torch.equal(fused_mode(dev, x, 0), want)
        assert not dev.fused_words.any()
    mode = E.fused_lanes(dev)
    assert (mode == 0) == (dev.max_row_nnz > E.ROWS_MAX_STEPS * E.row_lanes(dev))
    eager = E.segmented_spmv_fused(dev, x)
    assert torch.equal(fused_mode(dev, x, mode), eager)
    if mode == 0:
        assert torch.equal(eager, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a call before capture, as CUDA graphs ask
        E.segmented_spmv_fused(dev, x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = E.segmented_spmv_fused(dev, x)
    for _ in range(3):
        out.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert not dev.fused_words.any()
    resident = _build.library().lib.csr_spmv_fused_resident(torch.cuda.current_device())
    assert resident >= torch.cuda.get_device_properties(0).multi_processor_count
    assert dev.fused_words.shape == (dev.ntiles,)
    assert dev.stream_bytes == sum(t.numel() * t.element_size() for t in (
        dev.ptr, dev.cols, dev.vals, dev.tile_row0, dev.carry_rows))


# ---------------------------------------------------------------- K6


def k6_launch(dev, x, mode):
    """K6's launcher in one mode (0: a warp per slice; 1: K4's tiles, the
    split slices finished in the launch), outside its wrapper, into a
    NaN-filled y: a row it leaves unwritten stays NaN."""
    y = torch.full((dev.nrows,), float("nan"), device=x.device)
    assert _build.library().lib.panel_spmv_fused(
        dev.slice_ptr.data_ptr(), dev.cols.data_ptr(), dev.vals.data_ptr(),
        dev.tile_slice0.data_ptr(), dev.tile_own0.data_ptr(), x.data_ptr(), y.data_ptr(),
        dev.fused_words.data_ptr(), dev.nslices,
        dev.nslots // 32, dev.ntiles, dev.tile, dev.nrows, mode,
        torch.cuda.current_stream().cuda_stream) == 0
    return y


def skewed(n):
    """bench.py's power-law generator at n rows (``bench.py:162-169``)."""
    return synth.power_law(n=n, avg_nnz_per_row=24, bandwidth=512, seed=0)


# whole SELL panels K6 runs on: skewed ones under 4 MB (its tile mode),
# regular ones (its slice mode), the panel shapes and the unread column
K6_MATRICES = {"pl_2048": lambda: skewed(2048), "pl_16384": lambda: skewed(16384),
               "band_1024": MATRICES["band_1024"], "unread_column": unread_column,
               **PANEL_SHAPES}


@pytest.mark.parametrize("name", sorted(K6_MATRICES))
def test_k6_modes_against_plain_and_the_tile_mode_is_k4_k7_bits(cuda, name):
    """K6 in each mode through its launcher, twice, into a NaN-filled y:
    within the bound of its plain version in that mode; the tile mode bit
    for bit K4 + K7's identity mode, its published words 0 after each
    launch. The wrapper picks by the widest slice, gives the launcher's bits
    in that mode, and its bits in 3 replays of a captured graph; the words
    are no part of the plan's bytes."""
    info, r, c, v = K6_MATRICES[name]()
    a = SellMatrix.from_coo(info.nrows, info.ncols, r, c, v, split=False, device=cuda)
    dev = a.dev
    xh = np.random.default_rng(7).standard_normal(info.ncols).astype(np.float32)
    x = torch.from_numpy(xh).to(cuda)
    xa = x.abs()
    dabs = dataclasses.replace(dev, vals=dev.vals.abs())
    k = max(dev.max_width, 1)
    y47 = P.panel_fixup(dev, *P.panel_spmv_partials(dev, x))
    for mode in (0, 1):
        plain = P.panel_spmv_fused_reference(dev, x, mode).double()
        bound = KERNEL_TOL_ABS + fp32_rel_tol(k) * P.panel_spmv_fused_reference(
            dabs, xa, mode).double()
        first = k6_launch(dev, x, mode)
        assert torch.equal(first, k6_launch(dev, x, mode))
        assert ((first.double() - plain).abs() <= bound).all()
        if mode == 1:
            assert torch.equal(first, y47)
            assert not dev.fused_words.any()
    mode = P.fused_mode(dev)
    assert mode == (dev.max_width > P.FUSED_SLICE_COLS_MAX)
    eager = P.panel_spmv_fused(dev, x)
    assert torch.equal(eager, k6_launch(dev, x, mode))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a call before capture, as CUDA graphs ask
        P.panel_spmv_fused(dev, x)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = P.panel_spmv_fused(dev, x)
    for _ in range(3):
        out.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert not dev.fused_words.any()
    assert dev.fused_words.shape == (2 * dev.ntiles, 32)
    resident = _build.library().lib.panel_spmv_fused_resident(torch.cuda.current_device())
    assert resident >= torch.cuda.get_device_properties(0).multi_processor_count
    assert dev.stream_bytes == sum(t.numel() * t.element_size() for t in (
        dev.slice_ptr, dev.vals, dev.cols, dev.tile_slice0, dev.tile_own0,
        dev.split_slices))


@pytest.mark.parametrize("where", ["x0", "read"])
def test_a_nan_reaches_only_the_rows_that_read_its_column(cuda, where):
    """On the unread-column matrix's whole ELL panel (no entry in column 0;
    31 rows of the first slice padded), a NaN at x[0] or at a column the
    last row reads: K4 + K7, K6 in each mode, K10 + K7 (column 0 of R =
    4) and K14 + K7 give NaN exactly in the oracle's NaN rows."""
    from spmv_tpu_torch.oracle import golden_spmv

    info, r, c, v = unread_column()
    dev = EllMatrix.from_coo(info.nrows, info.ncols, r, c, v, split=False,
                             device=cuda).dev
    dev64 = X2Matrix.from_coo("ell", info.nrows, info.ncols, r, c, v, split=False,
                              device=cuda).dev
    xh = np.random.default_rng(3).standard_normal(info.ncols).astype(np.float32)
    xh[0 if where == "x0" else int(c[-1])] = float("nan")
    want = np.isnan(golden_spmv(info.nrows, r, c, v, xh))
    assert want.sum() == (0 if where == "x0" else 2)
    x = torch.from_numpy(xh).to(cuda)
    X = torch.stack([x, x.nan_to_num(), -x.nan_to_num(), x.nan_to_num()], dim=1)
    outs = {"K4 + K7": P.panel_fixup(dev, *P.panel_spmv_partials(dev, x)),
            "K6 slices": k6_launch(dev, x, 0), "K6 tiles": k6_launch(dev, x, 1),
            "K10 + K7": P.panel_spmv_multi(dev, X)[:, 0],
            "K14 + K7": X2.panel_spmv_x2(dev64, x.double())}
    for what, y in outs.items():
        assert np.array_equal(torch.isnan(y).cpu().numpy(), want), what


def test_refused_k6_launch_raises(cuda):
    """K6's launcher refuses a mode it has not, and a tile it was not built
    for; its wrapper refuses the tile first."""
    info, r, c, v = skewed(2048)
    good = SellMatrix.from_coo(info.nrows, info.ncols, r, c, v, split=False,
                               device=cuda).dev
    x = torch.ones(info.ncols, device=cuda)
    with pytest.raises(AssertionError):
        k6_launch(good, x, 2)
    order = np.lexsort((c, r))
    bad = DevPanel.from_plan(build_panel_plan(info.nrows, info.ncols, r[order], c[order],
                                              v[order], tile=3), cuda)
    with pytest.raises(ValueError, match="tile"):
        P.panel_spmv_fused(bad, x)
    with pytest.raises(AssertionError):
        k6_launch(bad, x, 1)


# ---------------------------------------------------------------- K7


def sorted_sell(name, device, free_dispatch):
    """The σ-sorted SELL build (σ = 128) of a matrix, split; with
    ``free_dispatch`` the split's dispatch price is 0, which keeps a panel
    and spills the hub rows' tails on skewed matrices. None where the sort
    does not apply."""
    info, r, c, v = MATRICES[name]()
    with forced_split(dispatch_s=0.0 if free_dispatch else None):
        a = SellMatrix.from_coo(info.nrows, info.ncols, r, c, v, sigma=128,
                                device=device)
    return a if a.sorted_rows else None


@pytest.mark.parametrize("free_dispatch", [False, True])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_k7_is_the_fixup_add_and_gather(cuda, name, free_dispatch):
    """K7 after K4 with its partials, and after K6 without, each with the
    spill part's y′ where the build spills, at R = 1 and 4: bit for bit the
    fix-up (K7's identity mode), a torch add and the gather, with y′'s
    split-slice rows NaN; the containers' calls are the same bits."""
    a = sorted_sell(name, cuda, free_dispatch)
    if a is None:
        pytest.skip("the σ-sort does not apply to this matrix")
    dev, ip, n = a.dev, a.invperm_dev, a.nrows
    rows = (dev.split_slices.long()[:, None] * 32
            + torch.arange(32, device=cuda)).reshape(-1)
    rows = rows[rows < dev.nrows]
    rng = np.random.default_rng(11)
    for R in (1, 4):
        shape = (dev.ncols,) if R == 1 else (dev.ncols, R)
        X = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
        tiles, fixup, spmv = ((P.panel_spmv_partials, P.panel_fixup, E.segmented_spmv)
                              if R == 1 else (P.panel_spmv_multi_partials,
                                              P.panel_fixup_multi, E.segmented_spmv_multi))
        y, part = tiles(dev, X)
        spill = spmv(a.dev_spill, X) if a.dev_spill is not None else None
        fixed = fixup(dev, y.clone(), part)
        want = (fixed if spill is None else fixed + spill)[ip[:n].long()]
        poisoned = y.clone()
        poisoned[rows] = float("nan")
        got = P.inverse_permute(ip, poisoned, n, dev=dev, part=part, spill=spill)
        assert torch.equal(got, want)
        if R == 1:
            y6 = P.panel_spmv_fused(dev, X)
            bare = P.inverse_permute(ip, y6, n, spill=spill)
            assert torch.equal(bare, (y6 if spill is None else y6 + spill)[ip[:n].long()])
            assert torch.equal(a.matvec(X), bare if dev.fused else got)
        else:
            assert torch.equal(a.matmat(X), got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["band_1024", "power_law_32768", "cant_8192"])
def test_x2_k7_is_k15_and_the_gather(cuda, name):
    """The fp64 K7 after K14 with its partials: bit for bit the fp64
    fix-up (K7's identity mode) and the gather, y′'s split-slice rows
    unread; the sorted x2 ``matvec`` the same bits."""
    info, r, c, v = MATRICES[name]()
    v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
    a = X2Matrix.from_coo("sell", info.nrows, info.ncols, r, c, v, sigma=128,
                          split=False, device=cuda)
    assert a.sorted_rows
    dev, ip, n = a.dev, a.invperm_dev, a.nrows
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(info.ncols)).to(cuda)
    y, part = X2.panel_spmv_x2_partials(dev, x)
    want = X2.panel_fixup_x2(dev, y.clone(), part)[ip[:n].long()]
    rows = (dev.split_slices.long()[:, None] * 32 + torch.arange(32, device=cuda)).reshape(-1)
    poisoned = y.clone()
    poisoned[rows[rows < dev.nrows]] = float("nan")
    E.reset_launches()
    assert torch.equal(X2.inverse_permute_x2(ip, poisoned, n, dev=dev, part=part), want)
    assert E.LAUNCHES["inverse_permute"] == 1
    assert torch.equal(a.matvec(x), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["power_law_32768", "cant_8192"])
def test_sorted_paths_in_a_cuda_graph_equal_the_eager_run(cuda, name):
    """The sorted paths captured in a CUDA graph (K7 a programmatic
    dependent there too) and replayed give the eager run's bits: K4 + K7,
    K10 + K7, and with a spill part."""
    for free in (False, True):
        a = sorted_sell(name, cuda, free)
        if a is None:
            continue
        info = MATRICES[name]()[0]
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(
            info.ncols).astype(np.float32)).to(cuda)
        X = torch.stack([x, -x, 2 * x, x * x], dim=1)
        for path, xx in ((a.matvec, x), (a.matmat, X)):
            eager = path(xx)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # a call before capture, as CUDA graphs ask
                path(xx)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = path(xx)
            for _ in range(3):
                out.fill_(float("nan"))
                g.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, eager)


def unsorted_panel(name, fmt, device, x2=False):
    """A panel that keeps its row order: ``ell_pure`` (ELL whole), or HYB
    built with the split's dispatch price at 0 (a panel and a spill part);
    both kept on the tile kernel (the one-dispatch bound at 0 when called
    inside ``forced_split(fused_max=0)``)."""
    import spmv_tpu_torch

    info, r, c, v = MATRICES[name]()
    if x2:
        v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
    make = X2Matrix.from_coo if x2 else spmv_tpu_torch.from_coo
    kw = {"split": False} if fmt == "ell" else {}
    with forced_split(dispatch_s=0.0 if fmt == "hyb" else None):
        return make(fmt, info.nrows, info.ncols, r, c, v, device=device, **kw), info


def unused_nan(dev, part):
    """The partials with every slot no split slice uses set to NaN: K7
    reads none of them."""
    scol = dev.slice_ptr.long().cpu() // 32
    used = torch.zeros(part.shape[0], dtype=torch.bool)
    for s in dev.split_slices.long().cpu().tolist():
        ta, tb = int(scol[s]) // dev.tile, (int(scol[s + 1]) - 1) // dev.tile
        used[2 * ta + 1] = True
        used[2 * torch.arange(ta + 1, tb + 1)] = True
    out = part.clone()
    out[~used.to(part.device)] = float("nan")
    return out


@pytest.mark.parametrize("fmt", ["ell", "hyb"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_k7_identity_is_the_parents_fixup_and_add(cuda, name, fmt):
    """K7's identity mode after K4, K10 (R = 4, 8) and K14: without a spill
    the split slices' rows of y′ alone, with one every row plus the spill;
    bit for bit the plain fix-up (its adds in a fixed order) and a torch
    add, the parent's sequence, into a y′ whose split-slice rows and
    partials no slice uses are NaN, in place; the containers' calls the
    same bits; after K6 (a small plan), y′ plus the spill."""
    for R in (1, 4, 8, "x2"):
        a, info = unsorted_panel(name, fmt, cuda, x2=R == "x2")
        dev, n = a.dev, a.dev.nrows
        rng = np.random.default_rng(3)
        if R == "x2":
            X = torch.from_numpy(rng.standard_normal(info.ncols)).to(cuda)
            tiles, fixup, epi, spmv = (X2.panel_spmv_x2_partials, X2.panel_fixup_x2,
                                       X2.inverse_permute_x2, X2.segmented_spmv_x2)
        else:
            shape = (info.ncols,) if R == 1 else (info.ncols, R)
            X = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
            tiles, fixup, spmv = ((P.panel_spmv_partials, P.panel_fixup, E.segmented_spmv)
                                  if R == 1 else (P.panel_spmv_multi_partials,
                                                  P.panel_fixup_multi,
                                                  E.segmented_spmv_multi))
            epi = P.inverse_permute
        with forced_split(fused_max=0):
            y, part = tiles(dev, X)
            spill = spmv(a.dev_spill, X) if a.dev_spill is not None else None
            parent = P.panel_fixup_reference(dev, y.clone(), part)
            if spill is not None:
                parent.add_(spill)
            E.reset_launches()
            poisoned = split_rows_nan(dev, y)
            got = (fixup(dev, poisoned, unused_nan(dev, part)) if spill is None else
                   epi(None, poisoned, n, dev=dev, part=unused_nan(dev, part),
                       spill=spill))
            assert got.data_ptr() == poisoned.data_ptr()
            assert torch.equal(got, parent), R
            assert E.LAUNCHES["inverse_permute"] == int(bool(dev.nsplit) or spill is not None)
            call = a.matvec if R in (1, "x2") else a.matmat
            assert torch.equal(call(X), parent[:a.nrows]), R
        if R == 1 and spill is not None and dev.fused:  # K6's y′, no partials
            y6 = P.panel_spmv_fused(dev, X)
            spill = spmv(a.dev_spill, X)  # as the call runs it: K3 on a small plan
            want = y6 + spill
            assert torch.equal(P.inverse_permute(None, y6, n, spill=spill), want)
            assert torch.equal(a.matvec(X), want[:a.nrows])
    torch.cuda.synchronize()


def split_rows_nan(dev, y):
    out = y.clone()
    rows = (dev.split_slices.long()[:, None] * 32
            + torch.arange(32, device=y.device)).reshape(-1)
    out[rows[rows < dev.nrows]] = float("nan")
    return out


@pytest.mark.parametrize("name", ["power_law_32768", "cant_8192", "hub_slice"])
def test_unsorted_paths_in_a_cuda_graph_equal_the_eager_run(cuda, name):
    """The unsorted panel paths captured in a CUDA graph (K7's identity
    mode a programmatic dependent there too) and replayed give the eager
    run's bits: K4 + K7, K10 + K7, K14 + K7, and with a spill part K4 +
    the spill's kernels + K7."""
    info = MATRICES[name]()[0]
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        info.ncols).astype(np.float32)).to(cuda)
    X = torch.stack([x, -x, 2 * x, x * x], dim=1)
    for fmt in ("ell", "hyb"):
        a, _ = unsorted_panel(name, fmt, cuda)
        b, _ = unsorted_panel(name, fmt, cuda, x2=True)
        with forced_split(fused_max=0):
            for path, xx in ((a.matvec, x), (a.matmat, X), (b.matvec, x.double())):
                eager = path(xx)
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):  # a call before capture, as CUDA graphs ask
                    path(xx)
                torch.cuda.current_stream().wait_stream(side)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = path(xx)
                for _ in range(3):
                    out.fill_(float("nan"))
                    g.replay()
                    torch.cuda.synchronize()
                    assert torch.equal(out, eager), (fmt, path)


@pytest.mark.parametrize("name", sorted(FIXUP_MATRICES))
def test_k9_column_j_is_k2_on_column_j(cuda, name):
    """K9 at R = 2..8 (K2's kernel at R columns) gives, in column j, K2's
    bits on K8's column j, which is K1's carry on X[:, j]."""
    dev, _, x, _ = fixup_plans(name)
    for R in range(2, 9):
        X = torch.stack([x * (j + 1) for j in range(R)], dim=1)
        Y8, c8 = E.segmented_spmv_multi_partials(dev, X)
        Y9 = E.carry_fixup_multi(dev, Y8.clone(), c8)
        for j in range(R):
            y1, c1 = E.segmented_spmv_partials(dev, X[:, j].contiguous())
            assert torch.equal(Y9[:, j], E.carry_fixup(dev, y1, c1)), (R, j)
    torch.cuda.synchronize()


# ---------------------------------------------------------------- probes


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_probe_kernels_match_plain_versions_and_repeat_bitwise(cuda, name):
    """The probe launchers: each twice with the same bits and against its
    plain version; u16 columns, nogather and x32 against the production
    kernel on the same x, bit for bit."""
    dev, x, bound = setup(name, cuda)
    dev64, _, x64 = setup_x2(name, cuda)
    y1, c1 = E.segmented_spmv_partials(dev, x)
    c16 = KP.cols16(dev)
    yu, cu = KP.segmented_spmv_partials_u16(dev, c16, x)
    assert same_partials(dev, (yu, cu), (y1, c1))
    # the plain versions' index_add_ sums in no fixed order on the card
    y_plain = E.carry_fixup_reference(
        dev, *KP.segmented_spmv_partials_u16_reference(dev, c16, x))
    y = E.carry_fixup(dev, yu.clone(), cu)
    assert ((y.double() - y_plain.double()).abs() <= bound).all()
    y12 = X2.segmented_spmv_x2_partials(dev64, x64)
    assert same_partials(dev64, KP.segmented_spmv_partials_u16(dev64, c16, x64), y12)
    for tile in KP.PROBE_TILES:
        dt = KP.retile(dev, tile)
        ya, ca = KP.segmented_spmv_partials_at(dt, x)
        assert same_partials(dt, (ya, ca), KP.segmented_spmv_partials_at(dt, x))
        y = KP.carry_fixup_at(dt, ya.clone(), ca)
        assert torch.equal(y, KP.carry_fixup_at(dt, ya.clone(), ca))
        y_plain = E.carry_fixup_reference(dt, *E.segmented_spmv_partials_reference(dt, x))
        assert ((y.double() - y_plain.double()).abs() <= bound).all(), tile
    # K1 + K2 folded into one launch: K1 then K2's bits, twice (the counter
    # is back at 0 after each launch)
    y_path = E.carry_fixup(dev, y1.clone(), c1)
    assert torch.equal(KP.segmented_spmv_fold(dev, x), y_path)
    assert torch.equal(KP.segmented_spmv_fold(dev, x), y_path)
    xt = KP.xtilde(dev.ncols, torch.float32, cuda)
    yn, cn = KP.ablate_nogather(dev)
    assert same_partials(dev, (yn, cn), E.segmented_spmv_partials(dev, xt))
    assert same_partials(dev, (yn, cn), KP.ablate_nogather(dev))
    xt64 = KP.xtilde(dev.ncols, torch.float64, cuda)
    assert same_partials(dev64, KP.ablate_nogather(dev64),
                         X2.segmented_spmv_x2_partials(dev64, xt64))
    x32 = x64.float()
    assert same_partials(dev64, KP.ablate_x32(dev64, x32),
                         X2.segmented_spmv_x2_partials(dev64, x32.double()))
    for d, xx in ((dev, x), (dev64, x64)):
        for fn, ref, args in ((KP.ablate_noseg, KP.ablate_noseg_reference, (xx,)),
                              (KP.ablate_dma, KP.ablate_dma_reference, ())):
            out = fn(d.vals, d.cols, *args)
            assert torch.equal(out, fn(d.vals, d.cols, *args))
            err = (out - ref(d.vals, d.cols, *args)).abs().double().cpu().numpy()
            assert (err <= tile_sum_bound(d.vals, d.cols, *args)).all(), fn.__name__
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_panel_nogather_is_k4_on_xtilde(cuda, name):
    """The probe's K4 and K14 without the gather: twice with the same bits,
    and bit for bit the production kernel on x̃."""
    a, _, _ = setup_panel(name, cuda)
    _, pdev64, _ = setup_x2(name, cuda)
    for dev, tiles in ((a.dev, P.panel_spmv_partials),
                       (pdev64, X2.panel_spmv_x2_partials)):
        xt = KP.xtilde(dev.ncols, dev.vals.dtype, cuda)
        got = KP.panel_ablate_nogather(dev)
        assert all(map(torch.equal, got, KP.panel_ablate_nogather(dev)))
        assert all(map(torch.equal, got, tiles(dev, xt)))
    torch.cuda.synchronize()


def test_probe_launchers_refuse(cuda):
    dev, x, _ = setup("band_1024", cuda)
    c16 = KP.cols16(dev)
    shifted = torch.empty(dev.nnz + 1, dtype=torch.int16, device=cuda)[1:]
    shifted.copy_(c16)
    with pytest.raises(ValueError, match="aligned"):
        KP.segmented_spmv_partials_u16(dev, shifted, x)
    with pytest.raises(ValueError, match="tile"):
        KP.segmented_spmv_partials_at(dev, x)  # the production tile: K1's own
    lib = _build.library().lib
    y = torch.zeros(dev.nrows, device=cuda)
    carry = torch.zeros(2 * dev.ntiles, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.seg_spmv_tiles_at(dev.ptr.data_ptr(), dev.cols.data_ptr(),
                                 dev.vals.data_ptr(), dev.tile_row0.data_ptr(),
                                 x.data_ptr(), y.data_ptr(), carry.data_ptr(),
                                 dev.nnz, dev.ntiles, dev.tile, stream) != 0
    out = torch.zeros(dev.ntiles, device=cuda)
    # x32 is a float64 mode; mode 4 does not exist
    for mode in (3, 4):
        assert lib.seg_ablate(dev.ptr.data_ptr(), dev.cols.data_ptr(),
                              dev.vals.data_ptr(), dev.tile_row0.data_ptr(),
                              x.data_ptr(), y.data_ptr(), carry.data_ptr(),
                              out.data_ptr(), dev.nnz, dev.ntiles, mode, stream) != 0


def test_probe_timing_on_the_card(cuda):
    """One probe end to end: every member checked, then timed (warm and
    cold, positive), with the card named."""
    from spmv_tpu_torch.probes import run_probe

    lines = []
    res = run_probe("ablate", trip=MATRICES["band_1024"](), rounds=1, device=cuda,
                    out=lines.append)
    assert set(res["members"]) == {"full", "fold", "noscat", "nogather", "noseg", "zero",
                                   "dma", "hbm"}
    for m in res["members"].values():
        assert m["warm_ms"] > 0 and m["cold_ms"] > 0 and m["bound_ms"] > 0
    assert res["card"] and all(res["card"] in ln for ln in lines if " warm " in ln)


# ---------------------------------------------------------------- solvers


def shifted_system(n, nnz_row, seed, sym):
    """The cant generator's lower triangle, expanded, with each diagonal
    entry set to 1 + its row's off-diagonal absolute sum: SPD by Gershgorin.
    ``sym`` gives the stored triangle (sym's input), else the expansion."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=nnz_row,
                                         bandwidth=min(350, n // 4), seed=seed)
    low = r > c
    r, c, v = r[low], c[low], v[low]
    diag = 1 + np.bincount(r, np.abs(v), n) + np.bincount(c, np.abs(v), n)
    d = np.arange(n)
    if sym:
        return n, np.concatenate([r, d]), np.concatenate([c, d]), np.concatenate([v, diag])
    return (n, np.concatenate([r, c, d]), np.concatenate([c, r, d]),
            np.concatenate([v, v, diag]))


# "large" plans are over FUSED_STREAM_BYTES_MAX: K1 + K2 (K4 + K7) per matvec
SOLVE_SIZES = {"small": (2000, 12), "large": (40000, 24)}


def solver_container(fmt, size, device):
    import spmv_tpu_torch

    n, r, c, v = shifted_system(*SOLVE_SIZES[size], seed=4, sym=fmt == "sym")
    return spmv_tpu_torch.from_coo(fmt, n, n, r, c, v, device=device)


@pytest.mark.parametrize("size", sorted(SOLVE_SIZES))
@pytest.mark.parametrize("fmt", ["csr", "sym", "sell", "hyb"])
def test_cg_graph_loop_is_the_eager_loops_bits(cuda, monkeypatch, fmt, size):
    """The CUDA graph of masked iteration bodies gives the eager loop's
    iteration count, x and residual bit for bit, reading one flag on the
    host per replay and none inside a chunk. A container's first solve
    runs the eager loop; the second captures the graph."""
    import math

    from spmv_tpu_torch import solve

    rng = np.random.default_rng(1)
    for chunk in (solve.GRAPH_CHUNK, 5):
        monkeypatch.setattr(solve, "GRAPH_CHUNK", chunk)
        a = solver_container(fmt, size, cuda)
        b = rng.standard_normal(a.nrows).astype(np.float32)
        x0, k0, res0 = solve.cg(a, b, tol=1e-6, _graph=False)
        solve.cg(a, b, tol=1e-6)  # the first solve: eager, nothing captured
        assert a._graph_loops == {"cg": None}
        x1, k1, res1 = solve.cg(a, b, tol=1e-6)
        assert torch.equal(x0, x1) and k0 == k1 and res0 == res1, (k0, k1)
        loop = a._graph_loops["cg"]
        assert (loop.chunk, loop.replays, loop.host_reads) == (
            chunk, math.ceil(k1 / chunk), math.ceil(k1 / chunk) + 1)
    assert 0 < k0 < 1000 and x1.device.type == "cuda"
    b2 = rng.standard_normal(a.nrows).astype(np.float32)  # the loop reused
    x2, k2, res2 = solve.cg(a, b2, tol=1e-5, maxiter=900)
    assert a._graph_loops == {"cg": loop}
    assert (x2, k2, res2)[1:] == solve.cg(a, b2, tol=1e-5, maxiter=900, _graph=False)[1:]
    assert torch.equal(x2, solve.cg(a, b2, tol=1e-5, maxiter=900, _graph=False)[0])
    assert torch.equal(x1, x0)  # an earlier x is not the loop's tensor


@pytest.mark.parametrize("fmt", ["csr", "sym"])
def test_bicgstab_and_power_graph_loops_are_the_eager_bits(cuda, fmt):
    from spmv_tpu_torch import solve

    a = solver_container(fmt, "large", cuda)
    b = np.random.default_rng(2).standard_normal(a.nrows).astype(np.float32)
    x0, k0, res0 = solve.bicgstab(a, b, tol=1e-6, _graph=False)
    for _ in range(2):  # eager, then the captured loop
        x1, k1, res1 = solve.bicgstab(a, b, tol=1e-6)
        assert torch.equal(x0, x1) and k0 == k1 and res0 == res1
    assert a._graph_loops["bicgstab"].replays > 0
    for iters in (1, 37, 37):  # eager, captured, reused at another count
        lam0, v0 = solve.power_iteration(a, iters=iters, seed=3, _graph=False)
        lam1, v1 = solve.power_iteration(a, iters=iters, seed=3)
        assert lam0 == lam1 and torch.equal(v0, v1)
    assert a._graph_loops["power_iteration"].host_reads == 0


def test_a_failed_capture_raises_and_does_not_fall_back(cuda):
    """A matvec that reads the device on the host cannot be captured: the
    solve that captures raises instead of running the eager loop."""
    from spmv_tpu_torch import solve

    a = solver_container("csr", "small", cuda)

    class Syncing:
        nrows, ncols, dev = a.nrows, a.ncols, a.dev

        def matvec(self, x):
            y = a.matvec(x)
            float(y[0])  # a host read: illegal while the stream is captured
            return y

    b = np.ones(a.nrows, np.float32)
    syncing = Syncing()
    solve.cg(syncing, b, tol=1e-6)  # the first solve runs eagerly
    with pytest.raises(RuntimeError):
        solve.cg(syncing, b, tol=1e-6)
    torch.cuda.synchronize()
    x, k, _ = solve.cg(a, b, tol=1e-6)  # the card is still usable
    assert k > 0


def test_bench_on_the_card_times_by_graph_against_the_cold_roofline(cuda, tmp_path):
    """``bench --formats csr,sell --probe-bw --json`` on a 32k-row
    power-law matrix: CUDA-graph timing, the card named, the roofline share
    of the cold reading at most 105%."""
    import json

    from spmv_tpu_torch import cli
    from spmv_tpu_torch.io import mmio

    info, r, c, v = synth.power_law(n=32768, avg_nnz_per_row=24, bandwidth=512, seed=0)
    path, out = tmp_path / "pl.mtx", tmp_path / "bench.json"
    mmio.write_coo(str(path), info.nrows, info.ncols, r, c, v)
    assert cli.main(["bench", "--formats", "csr,sell", "--probe-bw", "--matrix",
                     str(path), "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res) == {"csr", "sell"}
    for d in res.values():
        assert d["timing"] == "graph" and d["card"]
        assert d["ms_per_spmv"] > 0 and d["cold_ms_per_spmv"] > 0
        assert 0 < d["roofline_pct"] <= 105
        assert d["hbm_bw_gbps"] > 0

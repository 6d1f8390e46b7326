"""The PyTorch port's tile schedule (``spmv_tpu_torch.formats.base``) and
its plain K1+K2 and K3 paths against each other and the fp64 oracle."""

import numpy as np
import pytest
import torch

from spmv_tpu_torch import synth
from spmv_tpu_torch.device import DevCsr, FUSED_STREAM_BYTES_MAX, x_to_device
from spmv_tpu_torch.formats.base import TILE_NNZ, build_csr_plan, csr_ptr
from spmv_tpu_torch.io.mmio import MMInfo
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.oracle import golden_spmv, kernel_check, row_scale
from spmv_tpu_torch.probes.common import empty_row_edges, wide_hub


def long_rows(seed=0):
    """Rows of 3000 and 5000 nonzeros (3 and 5+ tiles of 1024), rows ending
    exactly on tile boundaries, and empty rows at both ends and between."""
    rng = np.random.default_rng(seed)
    lengths = np.array([0, 0, 3000, 1, 0, 0, 1023, 1025, 2, 0, 5000, 1, 1, 0, 0])
    rows = np.repeat(np.arange(lengths.size), lengths)
    info = MMInfo("matrix", "coordinate", "real", "general",
                  lengths.size, 50, rows.size)
    return (info, rows, rng.integers(0, 50, rows.size),
            rng.standard_normal(rows.size))


CASES = {
    **{f"edge_{n}": (lambda n=n: synth.edge_case(n)) for n in sorted(synth.EDGE_CASES)},
    "band_1024": lambda: synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                              bandwidth=60, seed=5),
    "power_law_2048": lambda: synth.power_law(n=2048, seed=7),
    "long_rows": long_rows,
    # a hub over 22 tiles; empty rows at and between tile edges (K3's cases)
    "wide_hub": wide_hub,
    "empty_row_edges": empty_row_edges,
}
TILES = [TILE_NNZ, 64, 7]


def plan_of(trip, tile):
    info, r, c, v = trip
    order = np.lexsort((c, r))
    return build_csr_plan(info.nrows, info.ncols, csr_ptr(r[order], info.nrows),
                          c[order], v[order], tile=tile)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_schedule_invariants(case, tile):
    p = plan_of(CASES[case](), tile)
    ptr = p.ptr.astype(np.int64)
    assert p.tile_row0.size == p.ntiles + 1
    assert (np.diff(p.tile_row0) >= 0).all()
    for t in range(p.ntiles):  # the row holding each tile's first nonzero
        r = p.tile_row0[t]
        assert ptr[r] <= t * tile < ptr[r + 1]
    if p.nnz:
        r = p.tile_row0[-1]
        assert ptr[r] <= p.nnz - 1 < ptr[r + 1]
    # split rows, by brute force: nonzeros in more than one tile
    row_of = np.repeat(np.arange(p.nrows), np.diff(ptr))
    tile_of = np.arange(p.nnz) // tile
    split = sorted({r for r in range(p.nrows)
                    if np.unique(tile_of[row_of == r]).size > 1})
    assert p.carry_rows.tolist() == split
    for r in p.carry_rows:
        ta, tb = ptr[r] // tile, (ptr[r + 1] - 1) // tile
        assert 0 <= ta < tb < p.ntiles


def test_row_spanning_many_tiles_uses_a_carry_range():
    info, r, c, v = long_rows()
    p = plan_of((info, r, c, v), TILE_NNZ)
    dev = DevCsr.from_plan(p, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        info.ncols).astype(np.float32))
    y1, carry = E.segmented_spmv_partials_reference(dev, x)
    ptr = p.ptr.astype(np.int64)
    ta, tb = ptr[10] // TILE_NNZ, (ptr[11] - 1) // TILE_NNZ
    assert tb - ta >= 4  # row 10 (5000 nonzeros) reaches five tiles or more
    assert 10 in p.carry_rows and y1[10] == 0  # K1 leaves a split row to K2
    slots = [2 * ta + 1] + [2 * t for t in range(ta + 1, tb + 1)]
    y = E.carry_fixup_reference(dev, y1.clone(), carry)
    assert float(y[10]) == pytest.approx(float(carry[slots].sum()), rel=1e-6)
    prod = (v.astype(np.float32) * x.numpy()[c]).astype(np.float64)
    assert float(y[10]) == pytest.approx(prod[r == 10].sum(), rel=1e-4)


def test_empty_matrix_and_empty_rows():
    info, r, c, v = synth.edge_case("all_empty")
    p = plan_of((info, r, c, v), TILE_NNZ)
    assert p.nnz == 0 and p.ntiles == 0 and p.carry_rows.size == 0
    assert p.tile_row0.tolist() == [0]
    dev = DevCsr.from_plan(p, "cpu")
    x = torch.ones(info.ncols)
    y1, carry = E.segmented_spmv_partials(dev, x)
    assert carry.numel() == 0
    assert E.carry_fixup(dev, y1, carry).tolist() == [0.0] * info.nrows
    assert E.segmented_spmv_fused(dev, x).tolist() == [0.0] * info.nrows
    # a 0 x 0 matrix
    p0 = build_csr_plan(0, 0, np.zeros(1), np.zeros(0, np.int32), np.zeros(0))
    dev0 = DevCsr.from_plan(p0, "cpu")
    assert E.segmented_spmv(dev0, torch.zeros(0)).numel() == 0


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_paths_agree_with_each_other_and_the_oracle(case, tile):
    info, r, c, v = CASES[case]()
    p = plan_of((info, r, c, v), tile)
    dev = DevCsr.from_plan(p, "cpu")
    xh = np.random.default_rng(11).standard_normal(info.ncols).astype(np.float32)
    x = torch.from_numpy(xh)
    y12 = E.carry_fixup_reference(dev, *E.segmented_spmv_partials_reference(dev, x))
    y3 = E.segmented_spmv_fused_reference(dev, x)
    expected = golden_spmv(info.nrows, r, c, v.astype(np.float32), xh)
    scale = row_scale(info.nrows, r, c, v.astype(np.float32), xh)
    for y in (y12, y3):
        assert y.dtype == torch.float32 and y.shape == (info.nrows,)
        rep = kernel_check(expected, y.numpy(), scale, p.max_row_nnz)
        assert rep.ok, rep
    assert kernel_check(y3.numpy().astype(np.float64), y12.numpy(), scale,
                        p.max_row_nnz).ok
    assert torch.equal(y3, y12)  # K3 is K1's tiles and K2's adds in one launch


@pytest.mark.parametrize("shape", [(0, 0), (0, 7), (7, 0), (5, 5), (3000, 20)])
def test_fused_path_without_nonzeros(shape):
    """nnz == 0: plain K3 gives every row 0, as plain K1 + K2 does."""
    nrows, ncols = shape
    dev = DevCsr.from_plan(build_csr_plan(nrows, ncols, np.zeros(nrows + 1),
                                          np.zeros(0, np.int32), np.zeros(0)), "cpu")
    x = torch.ones(ncols)
    y3 = E.segmented_spmv_fused(dev, x)
    assert y3.dtype == torch.float32 and y3.tolist() == [0.0] * nrows
    assert torch.equal(y3, E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x)))


def test_duplicates_stay_separate_and_sum():
    # (1, 2) twice: both nonzeros are in the plan and add up
    p = plan_of((MMInfo("matrix", "coordinate", "real", "general", 3, 3, 3),
                 np.array([1, 1, 0]), np.array([2, 2, 0]), np.array([3.0, 4.0, 1.0])),
                TILE_NNZ)
    assert p.nnz == 3 and p.ptr.tolist() == [0, 1, 3, 3]
    dev = DevCsr.from_plan(p, "cpu")
    y = E.segmented_spmv(dev, torch.tensor([1.0, 1.0, 2.0]))
    assert y.tolist() == [1.0, 14.0, 0.0]


@pytest.mark.parametrize("bad", ["ptr_length", "ptr_decreasing", "ptr_end",
                                 "col_range", "row_range", "tile"])
def test_plan_refuses_malformed_input(bad):
    ptr, cols, vals = np.array([0, 2, 3]), np.array([0, 1, 2]), np.ones(3)
    kw = {}
    if bad == "ptr_length":
        ptr = np.array([0, 3])
    elif bad == "ptr_decreasing":
        ptr = np.array([0, 3, 1])
    elif bad == "ptr_end":
        ptr = np.array([0, 1, 2])
    elif bad == "col_range":
        cols = np.array([0, 1, 3])
    elif bad == "tile":
        kw = {"tile": 0}
    if bad == "row_range":
        with pytest.raises(ValueError):
            csr_ptr(np.array([0, 1, 2]), 2)
        return
    with pytest.raises(ValueError):
        build_csr_plan(2, 3, ptr, cols, vals, **kw)


def test_device_plan_bytes_and_fused_predicate():
    info, r, c, v = synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                         bandwidth=60, seed=5)
    p = plan_of((info, r, c, v), TILE_NNZ)
    dev = DevCsr.from_plan(p, torch.device("cpu"))
    arrays = (p.ptr, p.cols, p.vals, p.tile_row0, p.carry_rows)
    assert dev.stream_bytes == sum(a.nbytes for a in arrays)
    assert dev.ptr.dtype == dev.cols.dtype == torch.int32
    assert dev.vals.dtype == torch.float32
    assert (dev.nnz, dev.ntiles, dev.ncarry) == (p.nnz, p.ntiles, p.carry_rows.size)
    assert dev.fused == (dev.stream_bytes <= FUSED_STREAM_BYTES_MAX) and dev.fused
    assert dev.max_row_nnz == int(np.bincount(r).max())


def test_x_to_device_casts_and_checks_length():
    x = x_to_device(np.arange(5, dtype=np.float64), 5, "cpu")
    assert x.dtype == torch.float32 and x.tolist() == [0, 1, 2, 3, 4]
    assert x_to_device(torch.arange(4, dtype=torch.int64), 4, "cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="x has 4 entries, matrix has 5"):
        x_to_device(np.zeros(4), 5, "cpu")

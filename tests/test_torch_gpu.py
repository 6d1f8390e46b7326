"""The PyTorch port's CUDA kernels against their plain PyTorch versions,
on a CUDA card. Skipped without one (the decision is made in the
``cuda`` fixture, at run time).

    pytest -m gpu tests/test_torch_gpu.py      # on a machine with a card
"""

import numpy as np
import pytest
import torch

from spmv_tpu_torch import CSRMatrix, synth
from spmv_tpu_torch.formats.base import build_csr_plan
from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.kernels import _build
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.oracle import KERNEL_TOL_ABS, fp32_rel_tol, row_scale

pytestmark = pytest.mark.gpu

MATRICES = {
    **{n: (lambda n=n: synth.edge_case(n)) for n in sorted(synth.EDGE_CASES)},
    "band_1024": lambda: synth.synthetic_cant(n=1024, avg_nnz_per_row=16,
                                              bandwidth=60, seed=5),
    "power_law_32768": lambda: synth.power_law(n=32768, seed=1),
    "cant_8192": lambda: synth.synthetic_cant(n=8192),
}


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
    y1b, carryb = E.segmented_spmv_partials(dev, x)
    assert torch.equal(y1, y1b) and torch.equal(carry, carryb)
    y = E.carry_fixup(dev, y1.clone(), carry)
    assert torch.equal(y, E.carry_fixup(dev, y1.clone(), carry))
    y_plain = E.carry_fixup_reference(dev, *E.segmented_spmv_partials_reference(dev, x))
    assert ((y.double() - y_plain.double()).abs() <= bound).all()
    y3 = E.segmented_spmv_fused(dev, x)
    assert torch.equal(y3, E.segmented_spmv_fused(dev, x))
    y3_plain = E.segmented_spmv_fused_reference(dev, x)
    assert ((y3.double() - y3_plain.double()).abs() <= bound).all()
    torch.cuda.synchronize()


def test_each_launch_counts_once(cuda):
    dev, x, _ = setup("band_1024", cuda)
    E.reset_launches()
    y, carry = E.segmented_spmv_partials(dev, x)
    E.carry_fixup(dev, y, carry)
    E.segmented_spmv_fused(dev, x)
    E.segmented_spmv_partials_reference(dev, x)
    E.segmented_spmv_fused_reference(dev, x)
    assert E.LAUNCHES == {"seg_spmv_tiles": 1, "carry_fixup": 1,
                          "csr_spmv_fused": 1}


def test_empty_plans_launch_nothing(cuda):
    dev, x, _ = setup("all_empty", cuda)
    E.reset_launches()
    y, carry = E.segmented_spmv_partials(dev, x)
    assert E.carry_fixup(dev, y, carry).tolist() == [0.0] * dev.nrows
    assert E.segmented_spmv_fused(dev, x).tolist() == [0.0] * dev.nrows
    assert E.LAUNCHES == {"seg_spmv_tiles": 0, "carry_fixup": 0,
                          "csr_spmv_fused": 0}


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

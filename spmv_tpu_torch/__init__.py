"""spmv_tpu_torch — the SpMV library on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100), ported from the JAX package ``spmv_tpu``.

This package imports ``torch`` and never ``jax`` or ``spmv_tpu``. Ported so
far: MatrixMarket reading, the synthetic generators, the fp64 oracle, and
the CSR, COO and CMRS containers on the segmented engine's three kernels
(``kernels/csrc/seg_spmv.cu``). ``ROADMAP.md`` lists what is still to come.
"""

from spmv_tpu_torch import device, oracle, synth
from spmv_tpu_torch.api import FORMATS, from_coo, from_reference, load, spmv
from spmv_tpu_torch.errors import ReturnCode
from spmv_tpu_torch.formats.cmrs import CMRSMatrix
from spmv_tpu_torch.formats.coo import COOMatrix
from spmv_tpu_torch.formats.csr import CSRMatrix
from spmv_tpu_torch.io.mmio import read_coo
from spmv_tpu_torch.oracle import check_result, default_x, golden_spmv

__all__ = [
    "FORMATS",
    "from_coo",
    "from_reference",
    "load",
    "spmv",
    "ReturnCode",
    "COOMatrix",
    "CSRMatrix",
    "CMRSMatrix",
    "read_coo",
    "check_result",
    "default_x",
    "golden_spmv",
    "device",
    "oracle",
    "synth",
]

"""spmv_tpu_torch — the SpMV library on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100), ported from the JAX package ``spmv_tpu``.

This package imports ``torch`` and never ``jax`` or ``spmv_tpu``. Ported so
far: MatrixMarket reading and writing (``io.mmio``, with the C++ body
parser of ``io.native``), the synthetic generators, the fp64 oracle, the
CSR, COO and CMRS containers on the segmented engine's kernels
(``kernels/csrc/seg_spmv.cu``), the ELL, SELL-C-σ and HYB containers on the
panel engine's (``kernels/csrc/panel_spmv.cu``) with their CSR spill part,
``spmm`` (Y = A·X; R = 2..8 right-hand sides in one pass over each plan),
the BSR container, the fp64-grade mode (``X2Matrix``: fp64 plans on
the fp64 kernels of both engines, for csr, coo, cmrs, ell, sell and hyb),
the symmetric container (``SymmetricMatrix``: the lower triangle on two
passes of the segmented engine), the Krylov solvers (``solve``: cg,
bicgstab and power iteration, on the card as a CUDA graph of the iteration
body), the plan cache (``cache``), the benchmark harness
(``bench.runner``, ``python -m spmv_tpu_torch bench``), distribution
(``dist``: the row-, column-, ring- and chunked-gather-sharded containers
over ``torch.distributed``, one process per device; ``bench.scaling``,
``bench --scaling``) and the driver benchmark (``bench.suite``, ``python
-m spmv_tpu_torch.bench.suite``: the root ``bench.py``'s suites, the
4.2M-row big cell included). That is all the JAX package does.
"""

from spmv_tpu_torch import cache, device, oracle, solve, synth
from spmv_tpu_torch.api import (FORMATS, from_coo, from_reference, load, spmm,
                                spmv)
from spmv_tpu_torch.errors import ReturnCode
from spmv_tpu_torch.formats.bsr import BSRMatrix
from spmv_tpu_torch.formats.cmrs import CMRSMatrix
from spmv_tpu_torch.formats.coo import COOMatrix
from spmv_tpu_torch.formats.csr import CSRMatrix
from spmv_tpu_torch.formats.ell import EllMatrix
from spmv_tpu_torch.formats.hyb import HybMatrix
from spmv_tpu_torch.formats.sell import SellMatrix
from spmv_tpu_torch.io.mmio import read_coo
from spmv_tpu_torch.oracle import check_result, default_x, golden_spmv
from spmv_tpu_torch.sym import SymmetricMatrix
from spmv_tpu_torch.x2 import X2_FORMATS, X2Matrix

__all__ = [
    "FORMATS",
    "from_coo",
    "from_reference",
    "load",
    "spmv",
    "spmm",
    "ReturnCode",
    "BSRMatrix",
    "COOMatrix",
    "CSRMatrix",
    "CMRSMatrix",
    "EllMatrix",
    "SellMatrix",
    "HybMatrix",
    "SymmetricMatrix",
    "X2Matrix",
    "X2_FORMATS",
    "read_coo",
    "check_result",
    "default_x",
    "golden_spmv",
    "cache",
    "device",
    "oracle",
    "solve",
    "synth",
]

"""``ablate``: where K1 + K2's time goes, by cutting one stage at a time.

Counterpart of B12a-c, the JAX probes of the segmented engine
(``scripts/probe_ablate.py:152``, ``probe_ablate2.py:175`` and
``probe_ablate3.py:211``/``:218``), on the float32 CSR plan:

=========  ==========================================  ===================
member     what runs                                   TPU probe variant
=========  ==========================================  ===================
full       K1 + K2 (the production path)               full
fold       K1 with K2 folded into its last block: one   (none: the scatter
           launch, K1 + K2's bits                       without its launch)
noscat     K1 alone                                    noscat (ablate3)
nogather   K1 with x̃(c) computed from c, no x read      nowin
noseg      loads and gather, one sum per tile: no       noseg
           row search, scan or emit
zero       K1's outputs alone: y zero-filled (one       (none: the wrapper's
           memset, no kernel), the carries not filled   allocation)
dma        the plan's values and columns alone          dma
hbm        ``dma`` over 5 L2s of stream: HBM ceiling    (the co-sampled
                                                        ceiling)
=========  ==========================================  ===================

So noscat − nogather is the gather of x, noscat − noseg − zero the row
tracking, scan and emit, zero the wrapper's zero fill (noseg writes one sum
per tile into an uninitialized output), full − noscat K2 and its launch,
fold − noscat K2 without a launch of its own, and dma the floor that
streaming the plan sets.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import CSRMatrix
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.probes.bounds import (csr_spmv_bytes, seg_tiles_bytes,
                                          stream_bytes)
from spmv_tpu_torch.probes.common import (ceiling_members, spmv_check,
                                          tile_sums_check, vector)
from spmv_tpu_torch.probes.timing import Member

F32 = torch.float32


def members(trip, device, matrix: str):
    info, rows, cols, vals = trip
    dev = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals, device=device).dev
    x = vector(info.ncols, F32, device)
    flops = 2 * dev.nnz

    def fix(out):
        return E.carry_fixup_reference(dev, out[0].clone(), out[1])

    def zero_fill():  # what K1's wrapper allocates before it launches
        return E.tile_outputs(dev, F32)

    def zeros_check(out) -> str:
        y, carry = out
        if y.count_nonzero() or carry.shape != (2 * dev.ntiles,):
            raise AssertionError("the zero fill left a nonzero, or the carries "
                                 "have the wrong shape")
        return f"{y.numel()} zeros"

    ms = [
        Member("full", lambda: E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x)),
               csr_spmv_bytes(dev), flops, F32, spmv_check(trip, x)),
        Member("fold", lambda: KP.segmented_spmv_fold(dev, x), csr_spmv_bytes(dev),
               flops, F32, spmv_check(trip, x)),
        Member("noscat", lambda: E.segmented_spmv_partials(dev, x),
               seg_tiles_bytes(dev), flops, F32, spmv_check(trip, x, fixup=fix)),
        Member("nogather", lambda: KP.ablate_nogather(dev),
               seg_tiles_bytes(dev, x_itemsize=0), flops, F32,
               spmv_check(trip, KP.xtilde(info.ncols, F32, device), fixup=fix)),
        Member("noseg", lambda: KP.ablate_noseg(dev.vals, dev.cols, x),
               stream_bytes(dev.vals, dev.cols, x), flops, F32,
               tile_sums_check(dev.vals, dev.cols, x)),
        Member("zero", zero_fill, dev.nrows * 4, 0, F32, zeros_check),
        *ceiling_members(dev.vals, dev.cols, device),
    ]
    header = [f"float32 CSR plan {dev.stream_bytes} B, {dev.ntiles} tiles of "
              f"{dev.tile}, {dev.ncarry} split rows"]
    return ms, header


def summary(readings) -> list[str]:
    out = []
    for kind in ("warm", "cold"):
        t = {k: getattr(r, f"{kind}_ms") for k, r in readings.items()}
        out.append(f"stage split, {kind} (ms): x gather (noscat - nogather) "
                   f"{t['noscat'] - t['nogather']:.4f}, row search + scan + emit "
                   f"(noscat - noseg - zero) {t['noscat'] - t['noseg'] - t['zero']:.4f}, "
                   f"zero fill (zero) {t['zero']:.4f}, K2 + its "
                   f"launch (full - noscat) {t['full'] - t['noscat']:.4f}, K2 "
                   f"in K1's last block (fold - noscat) "
                   f"{t['fold'] - t['noscat']:.4f}, the "
                   f"stream (dma) {t['dma']:.4f}, of K1 + K2 {t['full']:.4f}")
    return out

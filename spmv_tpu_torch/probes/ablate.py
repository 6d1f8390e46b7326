"""``ablate``: where K1 + K2's time goes, by cutting one stage at a time.

Counterpart of B12a-c, the JAX probes of the segmented engine
(``scripts/probe_ablate.py:152``, ``probe_ablate2.py:175`` and
``probe_ablate3.py:211``/``:218``), on the float32 CSR plan:

=========  ==========================================  ===================
member     what runs                                   TPU probe variant
=========  ==========================================  ===================
full       K1 + K2 (the production path)               full
noscat     K1 alone                                    noscat (ablate3)
nogather   K1 with x̃(c) computed from c, no x read      nowin
noseg      loads and gather, one sum per tile: no       noseg
           row search, scan or emit
zero       K1's zero fill of y and the carries alone    (none: the wrapper's
           (two memsets, no kernel)                     allocation)
dma        the plan's values and columns alone          dma
hbm        ``dma`` over 5 L2s of stream: HBM ceiling    (the co-sampled
                                                        ceiling)
=========  ==========================================  ===================

So noscat − nogather is the gather of x, noscat − noseg − zero the row
tracking, scan and emit, zero the wrapper's zero fill (noseg writes one sum
per tile into an uninitialized output), full − noscat K2 and its launch,
and dma the floor that streaming the plan sets.
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
        return (torch.zeros(dev.nrows, dtype=F32, device=device),
                torch.zeros(2 * dev.ntiles, dtype=F32, device=device))

    def zeros_check(out) -> str:
        if any(t.count_nonzero() for t in out):
            raise AssertionError("the zero fill left a nonzero")
        return f"{sum(t.numel() for t in out)} zeros"

    ms = [
        Member("full", lambda: E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x)),
               csr_spmv_bytes(dev), flops, F32, spmv_check(trip, x)),
        Member("noscat", lambda: E.segmented_spmv_partials(dev, x),
               seg_tiles_bytes(dev), flops, F32, spmv_check(trip, x, fixup=fix)),
        Member("nogather", lambda: KP.ablate_nogather(dev),
               seg_tiles_bytes(dev, x_itemsize=0), flops, F32,
               spmv_check(trip, KP.xtilde(info.ncols, F32, device), fixup=fix)),
        Member("noseg", lambda: KP.ablate_noseg(dev.vals, dev.cols, x),
               stream_bytes(dev.vals, dev.cols, x), flops, F32,
               tile_sums_check(dev.vals, dev.cols, x)),
        Member("zero", zero_fill, (dev.nrows + 2 * dev.ntiles) * 4, 0, F32, zeros_check),
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
                   f"launch (full - noscat) {t['full'] - t['noscat']:.4f}, the "
                   f"stream (dma) {t['dma']:.4f}, of K1 + K2 {t['full']:.4f}")
    return out

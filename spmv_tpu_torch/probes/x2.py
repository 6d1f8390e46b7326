"""``x2``: where K12 + K13's time goes, and why K12 streams slower than K1.

Counterpart of B12g (``scripts/probe_x2.py:241``), which cut stages of
the TPU's double-single kernel B10 (the Dekker/TwoSum chains, the integer
planes, the windowed reduce; none of which the port has). On the float64
CSR plan:

==========  ===============================================================
member      what runs
==========  ===============================================================
full        K12 + K13 (the fp64-grade path)
noscat      K12 alone
x32         K12 with x gathered from a float32 copy: 4 B per gather, not 8
nogather    K12 with x̃(c) computed from c, no x read
noseg       loads and gather, one fp64 sum per tile
f32 noscat  K1 alone on the float32 plan of the same matrix
dma, hbm    the fp64 plan's values and columns alone; the HBM ceiling
==========  ===============================================================

Run on the 1024-row band matrix (deep in the L2), cant (its fp64 plan
fills 96% of the 50 MB L2) and ``pl_big`` (above it): if x32 closes the
gap between noscat and f32 noscat, the 8-byte gather costs it; if the gap
follows the plan's size against the L2, capacity does.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import CSRMatrix, X2Matrix
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X2
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.probes.bounds import (csr_spmv_bytes, seg_tiles_bytes,
                                          stream_bytes)
from spmv_tpu_torch.probes.common import (ceiling_members, spmv_check,
                                          tile_sums_check, vector)
from spmv_tpu_torch.probes.timing import Member

F32, F64 = torch.float32, torch.float64


def members(trip, device, matrix: str):
    info, rows, cols, vals = trip
    dev = X2Matrix.from_coo("csr", info.nrows, info.ncols, rows, cols, vals,
                            device=device).dev
    dev32 = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals,
                               device=device).dev
    x = vector(info.ncols, F64, device)
    x32 = x.float()
    xp = E.plan_x(dev, x)  # x in the plan's column order, for the stream probe
    flops = 2 * dev.nnz

    def fix(out):
        return E.carry_fixup_reference(dev, out[0].clone(), out[1])

    def fix32(out):
        return E.carry_fixup_reference(dev32, out[0].clone(), out[1])

    ms = [
        Member("full", lambda: X2.segmented_spmv_x2(dev, x), csr_spmv_bytes(dev),
               flops, F64, spmv_check(trip, x, x2=True)),
        Member("noscat", lambda: X2.segmented_spmv_x2_partials(dev, x),
               seg_tiles_bytes(dev), flops, F64, spmv_check(trip, x, fixup=fix, x2=True)),
        Member("x32", lambda: KP.ablate_x32(dev, x32),
               seg_tiles_bytes(dev, x_itemsize=4), flops, F64,
               spmv_check(trip, x32.double(), fixup=fix, x2=True)),
        Member("nogather", lambda: KP.ablate_nogather(dev),
               seg_tiles_bytes(dev, x_itemsize=0), flops, F64,
               spmv_check(trip, KP.xtilde(info.ncols, F64, device), fixup=fix, x2=True)),
        Member("noseg", lambda: KP.ablate_noseg(dev.vals, dev.cols, xp),
               stream_bytes(dev.vals, dev.cols, xp), flops, F64,
               tile_sums_check(dev.vals, dev.cols, xp)),
        Member("f32 noscat", lambda: E.segmented_spmv_partials(dev32, x32),
               seg_tiles_bytes(dev32), flops, F32, spmv_check(trip, x32, fixup=fix32)),
        *ceiling_members(dev.vals, dev.cols, device),
    ]
    header = [f"float64 CSR plan {dev.stream_bytes} B (float32: "
              f"{dev32.stream_bytes} B), {dev.ntiles} tiles, {dev.ncarry} split rows"]
    return ms, header


def summary(readings) -> list[str]:
    out = []
    for kind in ("warm", "cold"):
        t = {k: getattr(r, f"{kind}_ms") for k, r in readings.items()}
        out.append(f"{kind}: K12 / K1 {t['noscat'] / t['f32 noscat']:.3f}, x32 / K12 "
                   f"{t['x32'] / t['noscat']:.3f}, nogather / K12 "
                   f"{t['nogather'] / t['noscat']:.3f}, noseg / K12 "
                   f"{t['noseg'] / t['noscat']:.3f}, dma / K12 "
                   f"{t['dma'] / t['noscat']:.3f}; K13 + its launch (full - "
                   f"noscat) {t['full'] - t['noscat']:.4f} ms")
    return out

"""``panel``: where the panel tile kernel's time goes (K4, and K14 in
float64): the stream of the panel, the x gather, or the walk.

No TPU probe cut the panel kernel; this is B12a's ``nowin`` cut
(``scripts/probe_ablate.py:152``, the tile kernel without its x reads)
and its ``dma`` member, applied to K4 and K14 on the SELL panel of one
matrix (``common.PANEL_SPLIT``: cant's as the split builds it, the others
whole):

================  =========================================================
member            what runs
================  =========================================================
K4                K4 alone (the wrapper's call), on the float32 panel
nogather          K4 with x̃(c) computed from c, no x read
dma               the panel's values and columns alone
K14               K14 alone, on the float64 panel of the same matrix
nogather fp64     K14 with x̃(c), no x read
dma fp64          the float64 panel's values and columns alone
hbm               ``dma`` over 5 L2s of stream: the HBM ceiling
================  =========================================================

So dma is the stream, K4 − nogather the x gather, and nogather − dma the
walk: the slice steps, the emits and whatever else of the kernel the
stream does not hide.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import X2Matrix, from_coo
from spmv_tpu_torch.kernels import engines_x2 as X2
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.probes.bounds import panel_tiles_bytes, stream_bytes
from spmv_tpu_torch.probes.common import (PANEL_SPLIT, ceiling_members, panel_triplets,
                                          spmv_check, tile_sums_check, vector)
from spmv_tpu_torch.probes.timing import Member

F32, F64 = torch.float32, torch.float64


def members(trip, device, matrix: str):
    info, rows, cols, vals = trip
    split = PANEL_SPLIT.get(matrix, False)
    a = from_coo("sell", info.nrows, info.ncols, rows, cols, vals, split=split,
                 device=device)
    a64 = X2Matrix.from_coo("sell", info.nrows, info.ncols, rows, cols, vals,
                            split=split, device=device)
    ms = []
    for dev, nnz, dtype, tiles, name, sfx in (
            (a.dev, a.panel_nnz, F32, P.panel_spmv_partials, "K4", ""),
            (a64.dev, a64.panel_nnz, F64, X2.panel_spmv_x2_partials, "K14", " fp64")):
        x = vector(info.ncols, dtype, device)
        ptrip = panel_triplets(dev)
        x2 = dtype == F64

        def fix(out, dev=dev):
            return P.panel_fixup_reference(dev, out[0].clone(), out[1])

        ms += [
            Member(name, lambda dev=dev, x=x, tiles=tiles: tiles(dev, x),
                   panel_tiles_bytes(dev), 2 * nnz, dtype,
                   spmv_check(ptrip, x, fixup=fix, x2=x2)),
            Member(f"nogather{sfx}", lambda dev=dev: KP.panel_ablate_nogather(dev),
                   panel_tiles_bytes(dev, x_itemsize=0), 2 * nnz, dtype,
                   spmv_check(ptrip, KP.xtilde(info.ncols, dtype, device), fixup=fix,
                              x2=x2))]
        if x2:
            ms.append(Member("dma fp64", lambda dev=dev: KP.ablate_dma(dev.vals, dev.cols),
                             stream_bytes(dev.vals, dev.cols), 3 * dev.nslots, F64,
                             tile_sums_check(dev.vals, dev.cols)))
    ms += ceiling_members(a.dev.vals, a.dev.cols, device)
    header = [f"{'split' if split else 'whole'} SELL panel, sorted {a.sorted_rows}: "
              f"{a.dev.nslots} slots for {a.panel_nnz} nonzeros, {a.dev.ntiles} tiles, "
              f"{a.dev.nsplit} split slices; float32 panel {a.dev.stream_bytes} B, "
              f"float64 panel {a64.dev.stream_bytes} B"]
    return ms, header


def summary(readings) -> list[str]:
    out = []
    for kind in ("warm", "cold"):
        t = {k: getattr(r, f"{kind}_ms") for k, r in readings.items()}
        for tiles, sfx in (("K4", ""), ("K14", " fp64")):
            out.append(f"{tiles} split, {kind} (ms): the stream (dma{sfx}) "
                       f"{t[f'dma{sfx}']:.4f}, x gather ({tiles} - nogather{sfx}) "
                       f"{t[tiles] - t[f'nogather{sfx}']:.4f}, walk (nogather{sfx} - "
                       f"dma{sfx}) {t[f'nogather{sfx}'] - t[f'dma{sfx}']:.4f}, of "
                       f"{tiles} {t[tiles]:.4f}")
    return out

"""``accum``: the granularity at which K1 folds row partials.

Counterpart of B12d (``scripts/probe_accum.py:168``), which timed the TPU
kernel's y accumulate per subtile against one windowed read-modify-write.
On Hopper the same question is the tile: a row is summed in registers,
joined across threads by the block's segmented scan, and a row that
crosses a tile boundary leaves carries for K2. Smaller tiles mean more
blocks and more carries; larger ones a longer scan. The members run K1
and K2 on the float32 plan of the same matrix at tiles of 128 nonzeros
(one warp, no shared-memory stage), 512, 1024 (the production tile) and
2048:

===============  ==============================
member           what runs
===============  ==============================
t<tile> K1       K1 at that tile
t<tile> K1+K2    K1 and its K2 at that tile
dma, hbm         the plan's stream; the HBM ceiling
===============  ==============================
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import CSRMatrix
from spmv_tpu_torch.formats.base import TILE_NNZ
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.probes.bounds import csr_spmv_bytes, seg_tiles_bytes
from spmv_tpu_torch.probes.common import ceiling_members, spmv_check, vector
from spmv_tpu_torch.probes.timing import Member

F32 = torch.float32
TILES = (128, 512, TILE_NNZ, 2048)


def _kernels(tile: int):
    """K1 and K2 for a plan of ``tile``: the production ones at 1024."""
    if tile == TILE_NNZ:
        return E.segmented_spmv_partials, E.carry_fixup
    return KP.segmented_spmv_partials_at, KP.carry_fixup_at


def members(trip, device, matrix: str):
    info, rows, cols, vals = trip
    base = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals, device=device).dev
    x = vector(info.ncols, F32, device)
    ms, header = [], []
    for tile in TILES:
        dev = base if tile == TILE_NNZ else KP.retile(base, tile)
        k1, k2 = _kernels(tile)

        def fix(out, dev=dev):
            return E.carry_fixup_reference(dev, out[0].clone(), out[1])

        ms += [Member(f"t{tile} K1", lambda dev=dev, k1=k1: k1(dev, x),
                      seg_tiles_bytes(dev), 2 * dev.nnz, F32,
                      spmv_check(trip, x, fixup=fix)),
               Member(f"t{tile} K1+K2", lambda dev=dev, k1=k1, k2=k2: k2(dev, *k1(dev, x)),
                      csr_spmv_bytes(dev), 2 * dev.nnz, F32, spmv_check(trip, x))]
        header.append(f"tile {tile}: {dev.ntiles} tiles, {dev.ncarry} split rows, "
                      f"{2 * dev.ntiles} carry slots")
    ms += ceiling_members(base.vals, base.cols, device)
    return ms, header


def summary(readings) -> list[str]:
    out = []
    for kind in ("warm", "cold"):
        t = {k: getattr(r, f"{kind}_ms") for k, r in readings.items()}
        ref = t[f"t{TILE_NNZ} K1+K2"]
        out.append(f"{kind}: K1+K2 against tile {TILE_NNZ}: " + ", ".join(
            f"t{tile} {t[f't{tile} K1+K2'] / ref:.3f}" for tile in TILES))
    return out

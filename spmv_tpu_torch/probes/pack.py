"""``pack``: what the bytes per nonzero cost K1 and K12.

Counterpart of B12e (``scripts/probe_pack.py:147``), which timed the TPU
streams at 8, 6 and 5.25 B per slot (the P-packing and the panel16
stream count, which the port does not have). Here K1 and K12 read their
columns as int32 or as uint16: 8 against 6 B per nonzero in float32, 12
against 10 in float64, with the same bits out. It needs a matrix of at
most 65,536 columns (cant); wider ones are refused before any launch.

===========  =================================================
member       what runs
===========  =================================================
i32 f32      K1 (int32 columns)
u16 f32      K1 reading uint16 columns
i32 f64      K12
u16 f64      K12 reading uint16 columns
dma, hbm     the float32 plan's stream alone; the HBM ceiling
===========  =================================================
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import CSRMatrix, X2Matrix
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X2
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.probes.bounds import seg_tiles_bytes
from spmv_tpu_torch.probes.common import ceiling_members, spmv_check, vector
from spmv_tpu_torch.probes.timing import Member

F32, F64 = torch.float32, torch.float64


def same_bits_check(ref, dev):
    """A check that a member gives the int32-column kernel's ``(y,
    carry)`` bit for bit: y, and the carry slots a split row uses
    (``engines.carry_slot_rows``; the others are not written)."""
    used = E.carry_slot_rows(dev) >= 0

    def check(out) -> str:
        (y, carry), (y_ref, carry_ref) = out, ref
        if not (torch.equal(y, y_ref) and torch.equal(carry[used], carry_ref[used])):
            raise AssertionError("not bit for bit the int32-column kernel's result")
        return "bit for bit the int32-column kernel's result"
    return check


def members(trip, device, matrix: str):
    info, rows, cols, vals = trip
    dev32 = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals,
                               device=device).dev
    dev64 = X2Matrix.from_coo("csr", info.nrows, info.ncols, rows, cols, vals,
                              device=device).dev
    c16 = KP.cols16(dev32)  # raises for more than 65,536 columns
    x64 = vector(info.ncols, F64, device)
    x32 = x64.float()
    flops = 2 * dev32.nnz
    ref32 = E.segmented_spmv_partials(dev32, x32)
    ref64 = X2.segmented_spmv_x2_partials(dev64, x64)

    def fixer(dev):
        return lambda out: E.carry_fixup_reference(dev, out[0].clone(), out[1])

    ms = [
        Member("i32 f32", lambda: E.segmented_spmv_partials(dev32, x32),
               seg_tiles_bytes(dev32), flops, F32,
               spmv_check(trip, x32, fixup=fixer(dev32))),
        Member("u16 f32", lambda: KP.segmented_spmv_partials_u16(dev32, c16, x32),
               seg_tiles_bytes(dev32, cols=c16), flops, F32, same_bits_check(ref32, dev32)),
        Member("i32 f64", lambda: X2.segmented_spmv_x2_partials(dev64, x64),
               seg_tiles_bytes(dev64), flops, F64,
               spmv_check(trip, x64, fixup=fixer(dev64), x2=True)),
        Member("u16 f64", lambda: KP.segmented_spmv_partials_u16(dev64, c16, x64),
               seg_tiles_bytes(dev64, cols=c16), flops, F64, same_bits_check(ref64, dev64)),
        *ceiling_members(dev32.vals, dev32.cols, device),
    ]
    header = [f"float32 plan {dev32.stream_bytes} B, float64 plan "
              f"{dev64.stream_bytes} B; uint16 columns save {2 * dev32.nnz} B"]
    return ms, header


def summary(readings) -> list[str]:
    out = []
    for kind in ("warm", "cold"):
        t = {k: getattr(r, f"{kind}_ms") for k, r in readings.items()}
        out.append(f"{kind}: u16 / i32 in float32 {t['u16 f32'] / t['i32 f32']:.3f} "
                   f"(bytes 6/8 of the stream), in float64 "
                   f"{t['u16 f64'] / t['i32 f64']:.3f} (10/12)")
    return out

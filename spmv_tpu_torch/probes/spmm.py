"""``spmm``: one fused pass over the plan for R vectors against R passes.

Counterpart of B12f (``scripts/probe_spmm.py:140``), which timed the TPU's
fused R-vector kernel against R single passes. It needs no kernel of its
own: K8 + K9 at R = 2, 4 and 8 against K1 + K2, whose time per vector is
what R passes cost per vector. Per-vector times are printed beside each
member.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import CSRMatrix
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.probes.bounds import csr_spmv_bytes
from spmv_tpu_torch.probes.common import ceiling_members, spmv_check, vector
from spmv_tpu_torch.probes.timing import Member

F32 = torch.float32
RHS = (2, 4, 8)


def members(trip, device, matrix: str):
    info, rows, cols, vals = trip
    dev = CSRMatrix.from_coo(info.nrows, info.ncols, rows, cols, vals, device=device).dev
    x = vector(info.ncols, F32, device)
    ms = [Member("K1+K2", lambda: E.carry_fixup(dev, *E.segmented_spmv_partials(dev, x)),
                 csr_spmv_bytes(dev), 2 * dev.nnz, F32, spmv_check(trip, x))]
    for R in RHS:
        X = vector(info.ncols, F32, device, seed=R, R=R)
        ms.append(Member(f"K8+K9 R={R}", lambda X=X: E.segmented_spmv_multi(dev, X),
                         csr_spmv_bytes(dev, R), 2 * dev.nnz * R, F32,
                         spmv_check(trip, X), per=R))
    ms += ceiling_members(dev.vals, dev.cols, device)
    return ms, [f"float32 CSR plan {dev.stream_bytes} B, {dev.ncarry} split rows"]


def summary(readings) -> list[str]:
    out = []
    for kind in ("warm", "cold"):
        t = {k: getattr(r, f"{kind}_ms") for k, r in readings.items()}
        one = t["K1+K2"]
        out.append(f"{kind}: ms per vector, R passes of K1+K2 {one:.4f}; "
                   + ", ".join(f"K8+K9 R={R} {t[f'K8+K9 R={R}'] / R:.4f} "
                               f"({one * R / t[f'K8+K9 R={R}']:.2f}x)" for R in RHS))
    return out

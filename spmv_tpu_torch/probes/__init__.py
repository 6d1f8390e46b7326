"""On-card probes of the segmented and panel tile kernels: the port's
counterpart of the JAX package's B12 probes (``scripts/probe_*.py``).

    python -m spmv_tpu_torch.probes {ablate,x2,pack,accum,spmm,panel}
        [--matrix cant|pl_big|pl_wide|pl|band] [--rounds N] [--device cpu]

Each probe builds the plans of one matrix, checks every member's result
once (the kernels on the card; the plain versions with ``--device cpu``),
then times the members with ``timing.measure`` and prints one line per
member: warm and cold ms, GB/s, the share of the co-sampled ceiling and of
the HBM-peak bound, with the card's name and power limit. On the CPU every
time is "not measured".

========  =========================================  ======================
probe     question                                   replaces (B12)
========  =========================================  ======================
ablate    K1 + K2's stage split                      probe_ablate.py:152,
                                                     probe_ablate2.py:175,
                                                     probe_ablate3.py:211
x2        K12's stage split; the 8-byte gather or    probe_x2.py:241
          the L2's capacity
pack      int32 against uint16 columns               probe_pack.py:147
accum     the tile at which partials are folded      probe_accum.py:168
spmm      one R-vector pass against R passes         probe_spmm.py:140
panel     K4's and K14's split: stream, x gather,    probe_ablate.py:152
          walk                                       (nowin, dma), on the
                                                     panel kernel
========  =========================================  ======================
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.probes import ablate, accum, pack, panel, spmm, timing, x2
from spmv_tpu_torch.probes.bounds import bound_ms
from spmv_tpu_torch.probes.common import MATRICES

__all__ = ["PROBES", "MATRICES", "run_probe"]

PROBES = {"ablate": ablate, "x2": x2, "pack": pack, "accum": accum, "spmm": spmm,
          "panel": panel}


def run_probe(name: str, matrix: str = "cant", *, trip=None, rounds: int = 5,
              device="cuda", out=print) -> dict:
    """Run probe ``name`` on ``matrix`` (or on the triplets ``trip``, named
    ``matrix``): its ``members(trip, device, matrix)``; check every member,
    then time them on a CUDA device (on the CPU, print "not measured").
    Returns each member's bytes, bound and readings (None on the CPU). A
    wrong result raises AssertionError."""
    mod = PROBES[name]
    trip = MATRICES[matrix]() if trip is None else trip
    device = torch.device(device)
    on_card = device.type == "cuda"
    card = timing.card_line(device) if on_card else "plain PyTorch versions, CPU"
    info, rows = trip[0], trip[1]
    members, header = mod.members(trip, device, matrix)
    out(f"probe {name} on {matrix}: {info.nrows} x {info.ncols}, nnz {rows.size}  [{card}]")
    for line in header:
        out(f"  {line}")
    for m in members:  # each result once, against its definition
        out(f"  {m.name:14s} checked: {m.check(m.fn())}")
    readings = timing.measure(members, device, rounds) if on_card else None
    l2 = timing.l2_bytes(device) if on_card else None
    for line in timing.report(members, readings, l2, card):
        out(line)
    if readings is not None:
        for line in mod.summary(readings):
            out(f"  {line}  [{card}]")
    result = {}
    for m in members:
        ms, by = bound_ms(m.nbytes, m.flops, m.dtype)
        r = readings[m.name] if readings is not None else None
        result[m.name] = {"bytes": m.nbytes, "bound_ms": ms, "bound_by": by,
                          "warm_ms": r.warm_ms if r else None,
                          "cold_ms": r.cold_ms if r else None, "per": m.per}
    return {"probe": name, "matrix": matrix, "card": card, "l2_bytes": l2,
            "members": result}

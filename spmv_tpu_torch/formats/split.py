"""Byte-priced panel/spill split, shared by ELL, SELL-C-σ and HYB.

Counterpart of ``spmv_tpu/formats/split.py``, with its algorithm and the
port's own unit and prices. Every panel pays padding: the 32 rows of a
slice all pad to the slice's longest row. So the width of each slice is
capped, and the elements of a row past the cap spill into a CSR plan run
by the segmented engine (K1 + K2 or K3). With ``H(cap)`` the number of the
slice's rows longer than ``cap``,

    bytes(cap) = PANEL_B · 32 · cap  +  SPILL_B · Σ_r max(0, n_r − cap)

falls while ``SPILL_B · H(cap) > 32 · PANEL_B``, so the best cap is the
smallest one with at most ``32·PANEL_B/SPILL_B`` rows above it
(``_optimal_caps``). The split then prices three shapes — the whole matrix
in the panel, capped panel plus spill, the whole matrix spilled — as
streamed bytes over ``_BW`` plus ``_DISPATCH_S`` per engine run, and keeps
the cheapest, so a matrix too small to pay for a second dispatch stays on
one engine.

The JAX constants (``split.py:43-48``) are v5e numbers for P-packed
stripes; these are the port's own:

* ``PANEL_B`` = 8 B per panel slot: K4 and K6 read a float32 value and an
  int32 column per slot (``kernels/csrc/panel_spmv.cu``); the slice
  pointer adds 4 B per 32-row slice.
* ``SPILL_B`` = 8.44 B per spilled element: a CSR nonzero streams 8 B, and
  the row pointer and tile schedule add their share. The port's CSR plans
  hold 8.07 B per nonzero on cant (32,160,872 B / 3,985,015) and 8.44 on
  ``pl_big`` (41,237,556 B / 4,888,021; PERF.md §4); the power-law figure is
  taken, since the split matters there.
* ``_BW`` = 1.85e12 B/s: on an H100 80GB HBM3 at 700 W, K1 streamed cant's
  32,156,468-byte plan (n = 62451) in 0.0174 ms of device time (PERF.md
  §6).
* ``_DISPATCH_S`` = 20e-6 s: on the same card K3 took 0.0360 ms per call
  against 0.0154 ms on the device at cant, so one more dispatch costs a
  caller about 0.02 ms of host launch work (PERF.md §6).

``PanelSpill`` holds the two device plans of a split matrix, and
``PanelSpillFormat`` gives ELL, SELL-C-σ and HYB their shared accessors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, DevPanel
from spmv_tpu_torch.formats.base import (SLICE_ROWS, CsrPlan, PanelPlan,
                                         build_csr_plan, build_panel_plan,
                                         cdiv, check_rows, csr_ptr)
from spmv_tpu_torch.kernels.panel import (panel_and_spill_spmm,
                                          panel_and_spill_spmv)

__all__ = ["priced_split", "split_triplets", "modeled_seconds", "PanelSpill",
           "PanelSpillFormat", "PANEL_B", "SPILL_B"]

PANEL_B = 8.0
SPILL_B = 8.44
_BW = 1.85e12
_DISPATCH_S = 20e-6


def _slice_lengths(rows: np.ndarray, nrows: int) -> np.ndarray:
    """Row lengths as (nslices, 32), zero past ``nrows``."""
    nslices = cdiv(nrows, SLICE_ROWS)
    lengths = np.zeros(nslices * SLICE_ROWS, dtype=np.int64)
    lengths[:nrows] = np.bincount(rows, minlength=nrows)
    return lengths.reshape(nslices, SLICE_ROWS)


def _optimal_caps(lengths: np.ndarray) -> np.ndarray:
    """Per-slice width cap minimizing panel + spill bytes: the smallest cap
    with at most ``32·PANEL_B/SPILL_B`` of the slice's rows above it. With
    the lengths sorted in descending order that is entry ``thresh``."""
    thresh = int(SLICE_ROWS * PANEL_B / SPILL_B)
    if thresh >= SLICE_ROWS:  # spilling never pays: keep whole slices
        return lengths.max(axis=1, initial=0)
    return -np.sort(-lengths, axis=1)[:, thresh]


def modeled_seconds(panel_slots: int, spill_elems: int, n_engines: int) -> float:
    """Byte-model time of a split: streamed bytes over the streaming rate
    plus one dispatch per engine run."""
    return ((panel_slots * PANEL_B + spill_elems * SPILL_B) / _BW
            + n_engines * _DISPATCH_S)


def priced_split(rows, cols, vals, nrows: int):
    """The byte-optimal panel/spill split of a triplet set.

    Returns ``(r, c, v, keep, shape)``: the triplets in (row, col) order (a
    stable sort, so duplicates keep their input order), a mask of the
    elements kept in the panel, and the chosen shape (``"panel"``,
    ``"hyb"`` or ``"spill"``); ``keep`` is all True or all False for the
    pure shapes. Unlike JAX's, it needs no column count: the port's panel
    has no column stripes.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    nnz = rows.size
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    if nnz == 0:
        return r, c, v, np.ones(0, dtype=bool), "panel"

    lengths = _slice_lengths(r, nrows)
    caps = _optimal_caps(lengths)
    starts = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(lengths.reshape(-1)[:nrows], out=starts[1:])
    k = np.arange(nnz, dtype=np.int64) - starts[r]  # rank within the row
    keep = k < caps[r // SLICE_ROWS]

    panel_pure = SLICE_ROWS * int(lengths.max(axis=1).sum())
    panel_hyb = SLICE_ROWS * int(caps.sum())
    spill_hyb = int((~keep).sum())
    t_panel = modeled_seconds(panel_pure, 0, 1)
    t_spill = modeled_seconds(0, nnz, 1)
    t_hyb = modeled_seconds(panel_hyb, spill_hyb,
                            2 if 0 < spill_hyb < nnz else 1)
    shape = min((t_hyb, "hyb"), (t_panel, "panel"), (t_spill, "spill"))[1]
    if shape == "hyb" and spill_hyb in (0, nnz):  # a pure shape after all
        shape = "spill" if spill_hyb else "panel"
    if shape == "panel":
        keep = np.ones(nnz, dtype=bool)
    elif shape == "spill":
        keep = np.zeros(nnz, dtype=bool)
    return r, c, v, keep, shape


def split_triplets(rows, cols, vals, nrows: int, split: bool = True):
    """``priced_split``, or with ``split=False`` the whole matrix in the
    panel: ``(r, c, v, keep, shape)`` with the triplets in (row, col)
    order. A row outside ``[0, nrows)`` is refused first, with
    ``csr_ptr``'s message, before any row length is counted."""
    rows = check_rows(rows, nrows)
    if split:
        return priced_split(rows, cols, vals, nrows)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.lexsort((cols, rows))
    return (rows[order], cols[order], np.asarray(vals)[order],
            np.ones(rows.size, dtype=bool), "panel")


@dataclass(frozen=True)
class PanelSpill:
    """A matrix lowered to a panel plan and, where the split spills, a CSR
    plan over the same ``nrows`` rows."""

    plan: PanelPlan
    dev: DevPanel
    spill_plan: CsrPlan | None
    dev_spill: DevCsr | None
    shape: str  # the split's choice: "panel", "hyb" or "spill"

    @classmethod
    def from_split(cls, nrows: int, ncols: int, r, c, v, keep, shape: str, *,
                   device, dtype=np.float32) -> "PanelSpill":
        """Plans from ``split_triplets``' output (row-ordered triplets),
        with ``dtype`` values (float64 for ``x2.X2Matrix``)."""
        plan = build_panel_plan(nrows, ncols, r[keep], c[keep], v[keep],
                                dtype=dtype)
        spill_plan = dev_spill = None
        if (~keep).any():
            spill_plan = build_csr_plan(nrows, ncols, csr_ptr(r[~keep], nrows),
                                        c[~keep], v[~keep], dtype=dtype)
            dev_spill = DevCsr.from_plan(spill_plan, device)
        return cls(plan=plan, dev=DevPanel.from_plan(plan, device),
                   spill_plan=spill_plan, dev_spill=dev_spill, shape=shape)

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of both plans on the device."""
        return self.dev.stream_bytes + (self.dev_spill.stream_bytes
                                        if self.dev_spill is not None else 0)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y over the plans' ``nrows`` rows (x already on the device)."""
        return panel_and_spill_spmv(self.dev, self.dev_spill, x)

    def spmm(self, X: torch.Tensor) -> torch.Tensor:
        """Y (nrows, R) over the plans' rows for an (ncols, R) X already on
        the device, 2 ≤ R ≤ ``engines.MULTI_RHS_MAX``: one multi-RHS pass
        over each part."""
        return panel_and_spill_spmm(self.dev, self.dev_spill, X)


class PanelSpillFormat:
    """Accessors of a container that holds its plans in ``parts``."""

    parts: PanelSpill

    @property
    def dev(self) -> DevPanel:
        return self.parts.dev

    @property
    def plan(self) -> PanelPlan:
        return self.parts.plan

    @property
    def dev_spill(self) -> DevCsr | None:
        return self.parts.dev_spill

    @property
    def spill_plan(self) -> CsrPlan | None:
        return self.parts.spill_plan

    @property
    def shape(self) -> str:
        return self.parts.shape

    @property
    def panel_nnz(self) -> int:
        """Elements kept in the panel."""
        return self.parts.plan.nnz

    @property
    def spill_nnz(self) -> int:
        """Elements in the CSR spill part."""
        sp = self.parts.spill_plan
        return sp.nnz if sp is not None else 0

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the container's plans on the device."""
        return self.parts.stream_bytes

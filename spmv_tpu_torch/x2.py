"""The fp64-grade mode: ``X2Matrix``, SpMV at the reference's precision.

Counterpart of ``spmv_tpu/x2.py``. The reference computes in double
(``coo.c:39-42``) and validates at an absolute 1e-6
(``inc/helper_functions.h:11``); the fp32 engines miss that by about two
orders of magnitude at window scale. The JAX package reaches it with
double-single arithmetic (f32 hi and lo planes, ``kernels/engines_x2.py``),
because its TPU has no FMA on the VPU and bf16 on the MXU. Hopper has
native fp64 FMA, so the port computes in **fp64**: fp64 plan values (at
least as precise as hi + lo), fp64 x, every product and sum in fp64
(K12-K14 and K7, ``kernels/engines_x2.py``), fp64 y. The user-facing name stays
JAX's: ``--dtype f32x2``.

* csr, coo and cmrs build one fp64 CSR plan (coo lexsorts it; duplicates
  sum) and run K12 then K13.
* ell and hyb run the port's byte-priced split on the pattern, as their
  float32 containers do, into an fp64 panel (K14) and, where it spills,
  an fp64 CSR plan (K12 then K13); then K7 in float64, with no row order,
  sums the panel's split slices and adds the spill in fp64 on the
  device, in place on the panel's y.
* sell (``sell_c_sigma``) adds the σ-sort, decided on the pattern as
  ``SellMatrix`` decides it; where it applies, K14 and the spill's K12 +
  K13 run in sorted row space and K7 in float64 sums the split slices'
  partials, adds the spill and gathers y back to row order in one
  launch.
* bsr is refused, as in JAX: its tiles are a dense matmul format.

The split is priced with the float32 constants of ``formats.split``, as
JAX prices its x2 split with its f32 ones; both plans' layouts depend only
on the sparsity pattern. JAX's ``chunk`` and ``pack`` are TPU layout and
have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import DevCsr, DevPanel, x_to_device
from spmv_tpu_torch.formats.base import build_csr_plan, csr_ptr
from spmv_tpu_torch.formats.sell import DEFAULT_SIGMA, sort_and_split
from spmv_tpu_torch.formats.split import PanelSpill, split_triplets
from spmv_tpu_torch.kernels.engines_x2 import (panel_and_spill_spmv_x2,
                                               segmented_spmv_x2,
                                               sorted_panel_and_spill_spmv_x2)

__all__ = ["X2Matrix", "X2_FORMATS"]

X2_FORMATS = ("csr", "coo", "cmrs", "ell", "sell", "sell_c_sigma", "hyb")
_SEG = ("csr", "coo", "cmrs")


@dataclass
class X2Matrix:
    x2 = True  # marker for dtype-aware call sites (api.spmm)
    format: str
    nrows: int
    ncols: int
    nnz: int
    dev: DevCsr | DevPanel = field(repr=False)  # the CSR plan, or the panel
    parts: PanelSpill | None = field(repr=False, default=None)  # panel formats
    sorted_rows: bool = False  # did SELL's σ-sort apply?
    invperm_dev: torch.Tensor | None = field(repr=False, default=None)  # K7's table

    @classmethod
    def from_coo(cls, format: str, nrows: int, ncols: int, rows, cols, vals,
                 *, device, sigma: int | None = None,
                 split: bool = True) -> "X2Matrix":
        """``split=False`` keeps an ell or sell matrix whole in the panel
        (the float32 containers' option, and the shape JAX's x2 ell and
        sell always take); hyb always splits."""
        format = format.lower()
        if format not in X2_FORMATS:
            raise ValueError(
                f"f32x2 supports {sorted(set(X2_FORMATS))}, not {format!r}")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        common = dict(format=format, nrows=nrows, ncols=ncols, nnz=rows.size)
        if format in _SEG:
            order = np.lexsort((cols, rows))
            plan = build_csr_plan(nrows, ncols, csr_ptr(rows[order], nrows),
                                  cols[order], vals[order], dtype=np.float64)
            return cls(dev=DevCsr.from_plan(plan, device), **common)
        if format in ("ell", "hyb"):
            nrows_plan, sorted_, invperm = nrows, False, None
            split_out = split_triplets(rows, cols, vals, nrows,
                                       split or format == "hyb")
        else:
            _, sorted_, _, invperm, nrows_plan, split_out = sort_and_split(
                rows, cols, vals, nrows, sigma or DEFAULT_SIGMA, split)
        parts = PanelSpill.from_split(nrows_plan, ncols, *split_out,
                                      device=device, dtype=np.float64)
        return cls(dev=parts.dev, parts=parts, sorted_rows=sorted_,
                   invperm_dev=(torch.from_numpy(invperm.astype(np.int32)).to(device)
                                if sorted_ else None), **common)

    @property
    def device(self) -> torch.device:
        return self.dev.device

    @property
    def dev_spill(self) -> DevCsr | None:
        return self.parts.dev_spill if self.parts is not None else None

    @property
    def shape(self) -> str | None:
        """The split's choice ("panel", "hyb" or "spill"); None for the
        CSR formats."""
        return self.parts.shape if self.parts is not None else None

    @property
    def panel_nnz(self) -> int:
        """Elements in the panel part (0 for the CSR formats)."""
        return self.parts.plan.nnz if self.parts is not None else 0

    @property
    def spill_nnz(self) -> int:
        """Elements in the CSR spill part (0 for the CSR formats)."""
        sp = self.parts.spill_plan if self.parts is not None else None
        return sp.nnz if sp is not None else 0

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plans (and K7's table) on the device."""
        if self.parts is None:
            return self.dev.stream_bytes
        extra = self.invperm_dev.numel() * 4 if self.invperm_dev is not None else 0
        return self.parts.stream_bytes + extra

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float64 tensor of length ``nrows`` on the plan's
        device; x is taken as float64 (JAX's x2 ``matvec`` takes an fp64 x
        too)."""
        xt = x_to_device(x, self.ncols, self.device, dtype=torch.float64)
        if self.parts is None:
            return segmented_spmv_x2(self.dev, xt)
        if not self.sorted_rows:  # identity permutation: no epilogue
            return panel_and_spill_spmv_x2(self.dev, self.dev_spill, xt)[:self.nrows]
        return sorted_panel_and_spill_spmv_x2(self.dev, self.dev_spill,
                                              self.invperm_dev, xt, self.nrows)

    __matmul__ = matvec

"""Device-resident plans and the x/y helpers.

Counterparts of ``spmv_tpu/device.py:DevSeg`` and ``DevPanel``. The JAX
containers split each stream into several arrays, pack u8 index planes and
compute y window targets, all for the TPU's DMA and VMEM limits; on Hopper
a plan is the CSR arrays or the sliced-ELLPACK panel of ``formats.base``
with its tile schedule, held as int32 tensors and float32 values (float64
for the fp64-grade mode, ``x2.X2Matrix``) on an explicit ``torch.device``.

A CSR plan whose columns are skewed and not banded is uploaded with its
columns relabelled hottest-first (``DevCsr.relabeled``, the rule in
``DevCsr.from_plan``): the engines gather x into that order before the
tile kernel runs (``kernels.engines.plan_x``), so the hot part of x lies
in a few cache lines.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, fields

import numpy as np
import torch

from spmv_tpu_torch import trace
from spmv_tpu_torch.formats.base import CsrPlan, PanelPlan

__all__ = ["DevCsr", "DevPanel", "FUSED_STREAM_BYTES_MAX", "x_to_device",
           "y_to_numpy", "X_to_device", "Y_to_numpy", "hot_head_counts"]

# Plans of at most this many bytes run the one-dispatch kernel (K3
# ``csr_spmv_fused``, K6 ``panel_spmv_fused``); larger plans run the
# two-dispatch shape (K1 + K2, K4 + K7). The JAX package's threshold
# (``spmv_tpu/device.py:68``, for both engines) was the starting point;
# PERF.md records the H100 times at the shapes ``chip_smoke.py`` runs.
FUSED_STREAM_BYTES_MAX = 4 * 1024 * 1024

# The column relabel's rule (``DevCsr.from_plan``), on a plan that runs K1
# + K2: relabel where the hottest ``RELABEL_TOP_COLS`` of the used columns
# hold at least ``RELABEL_TOP_SHARE_MIN`` of the nonzeros (skew) and fewer
# than ``RELABEL_NEAR_SHARE_MAX`` of them lie within ``RELABEL_NEAR_COLS``
# columns of their row (no band: a banded plan's x gather is local as it
# is, and a relabel would scatter it). On an H100 the Graph500 Kronecker
# graph at scale 22 reads 45.7% and 1.6% and runs K1 + K2 and the gather
# 14.6% faster relabelled; HPCG's stencil reads 1.0% and 100% (PERF.md).
RELABEL_TOP_COLS = 0.01
RELABEL_TOP_SHARE_MIN = 0.25
RELABEL_NEAR_COLS = 32768
RELABEL_NEAR_SHARE_MAX = 0.5
# nonzeros per step of ``column_shares``' row search: 4 Mi steps keep its
# scratch near 50 MB on any plan
_SCAN_NNZ = 1 << 22


def _put(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _tensor_bytes(plan) -> int:
    """Exact bytes of a device plan's tensors, ``col_order`` left out: a
    relabelled plan streams what the same plan without the relabel does."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(plan, f.name) for f in fields(plan)
                         if f.name != "col_order")
               if isinstance(t, torch.Tensor))


def hot_head_counts(hottest: torch.Tensor, used: int, nnz: int, cols: int) -> dict:
    """A relabelled plan's ``plan.upload`` counts of K1's hot head, from its
    columns' counts sorted hottest first: ``hot_cols``, the first ``cols``
    labels or the ``used`` columns where fewer, and ``hot_share``, the share
    of the ``nnz`` nonzeros whose label is below it."""
    hot = min(cols, used)
    return {"hot_cols": hot, "hot_share": int(hottest[:hot].sum()) / max(nnz, 1)}


@dataclass(frozen=True)
class DevCsr:
    ptr: torch.Tensor  # (nrows+1,) int32
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,) float32, or float64 (the plan's dtype)
    tile_row0: torch.Tensor  # (ntiles+1,) int32
    carry_rows: torch.Tensor  # (ncarry,) int32
    nrows: int
    ncols: int
    tile: int
    max_row_nnz: int
    # (nused,) int32 or None: a relabelled plan's source column of each
    # label, hottest first; ``cols`` then holds the labels (``relabeled``)
    col_order: torch.Tensor | None = None

    def __post_init__(self):
        # K3's published partials (``kernels.engines.segmented_spmv_fused``):
        # one int64 word per tile on a float32 CUDA plan, zeroed once here,
        # outside any CUDA-graph capture, and left 0 by every launch. Not a
        # field, so ``stream_bytes`` does not count it.
        if self.vals.device.type == "cuda" and self.vals.dtype == torch.float32:
            object.__setattr__(self, "fused_words", torch.zeros(
                self.ntiles, dtype=torch.int64, device=self.vals.device))

    @classmethod
    def from_plan(cls, plan: CsrPlan, device) -> "DevCsr":
        """The plan on ``device``, its columns relabelled where the rule
        above holds: on a plan that runs K1 + K2 (not ``fused``), the
        readings of ``column_shares``. The ``plan.upload`` span counts
        ``relabeled`` (0 or 1), where the rule was read both readings, and
        on a relabelled float32 plan on the card the hot head's
        ``hot_cols`` and ``hot_share`` (``relabeled``)."""
        with trace.maybe("plan.upload") as s:
            device = torch.device(device)
            dev = cls(ptr=_put(plan.ptr, device), cols=_put(plan.cols, device),
                      vals=_put(plan.vals, device),
                      tile_row0=_put(plan.tile_row0, device),
                      carry_rows=_put(plan.carry_rows, device),
                      nrows=plan.nrows, ncols=plan.ncols, tile=plan.tile,
                      max_row_nnz=plan.max_row_nnz)
            relabel = False
            if not dev.fused and dev.nnz:
                top, near = dev.column_shares()
                relabel = top >= RELABEL_TOP_SHARE_MIN and near < RELABEL_NEAR_SHARE_MAX
                if s is not None:
                    s.counts.update(top_share=top, near_share=near)
            if relabel:
                dev = dev.relabeled()
            if s is not None:
                s.counts["relabeled"] = int(relabel)
            return dev

    def source_cols(self) -> torch.Tensor:
        """The columns in the matrix's own labels: ``cols``, or on a
        relabelled plan ``col_order[cols]``."""
        if self.col_order is None:
            return self.cols
        return self.col_order.index_select(0, self.cols)

    def column_shares(self) -> tuple[float, float]:
        """The relabel rule's readings, shares of the nonzeros, on the
        plan's device: ``top``, those in the hottest ``RELABEL_TOP_COLS``
        of the used columns; ``near``, those within ``RELABEL_NEAR_COLS``
        columns of their row."""
        cols = self.source_cols()
        counts = torch.bincount(cols, minlength=self.ncols)
        k = max(1, math.ceil(RELABEL_TOP_COLS * int(torch.count_nonzero(counts))))
        top = int(torch.topk(counts, k, sorted=False).values.sum())
        near = torch.zeros((), dtype=torch.int64, device=self.device)
        for e0 in range(0, self.nnz, _SCAN_NNZ):  # in steps, to bound the scratch
            e = torch.arange(e0, min(e0 + _SCAN_NNZ, self.nnz), dtype=torch.int32,
                             device=self.device)
            rows = torch.searchsorted(self.ptr, e, right=True, out_int32=True) - 1
            near += torch.count_nonzero((cols[e0:e0 + e.numel()] - rows).abs()
                                        <= RELABEL_NEAR_COLS)
        return top / self.nnz, int(near) / self.nnz

    def relabeled(self) -> "DevCsr":
        """The same plan with its columns numbered hottest-first:
        ``col_order[j]`` is the source column of label j, the used columns
        by descending count, ties in source order (a stable sort), empty
        columns left out. No row's nonzeros are reordered, so K1 multiplies
        the same value by the same x entry in the same order: y, the carries
        and K2's sums are the plan's own, bit for bit. On the card, for a
        float32 plan inside a recording ``plan.upload`` span, it counts
        there ``hot_head_counts`` of the labels whose x K1's hot-head
        kernel reads from shared memory (``engines.hot_cols``)."""
        if self.col_order is not None:
            raise ValueError("the plan's columns are relabelled already")
        counts = torch.bincount(self.cols, minlength=self.ncols)
        used = int(torch.count_nonzero(counts))
        hottest = torch.sort(counts, descending=True, stable=True)
        s = trace.current()
        if (s is not None and s.name == "plan.upload" and self.device.type == "cuda"
                and self.vals.dtype == torch.float32):
            from spmv_tpu_torch.kernels.engines import hot_cols  # it imports this module

            s.counts.update(hot_head_counts(hottest.values, used, self.nnz, hot_cols()))
        order = hottest.indices[:used]
        del hottest  # the sorted counts, before the larger tensors below
        label = torch.empty(self.ncols, dtype=torch.int32, device=self.device)
        label[order] = torch.arange(used, dtype=torch.int32, device=self.device)
        return dataclasses.replace(self, cols=label.index_select(0, self.cols),
                                   col_order=order.to(torch.int32))

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return self.cols.numel()

    @property
    def ntiles(self) -> int:
        return self.tile_row0.numel() - 1

    @property
    def ncarry(self) -> int:
        return self.carry_rows.numel()

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plan's tensors on the device."""
        return _tensor_bytes(self)

    @property
    def fused(self) -> bool:
        """Small plans take the one-dispatch kernel K3."""
        return self.stream_bytes <= FUSED_STREAM_BYTES_MAX


@dataclass(frozen=True)
class DevPanel:
    slice_ptr: torch.Tensor  # (nslices+1,) int32, multiples of 32
    vals: torch.Tensor  # (nslots,) float32 or float64, column-major per slice
    cols: torch.Tensor  # (nslots,) int32
    tile_slice0: torch.Tensor  # (ntiles+1,) int32
    tile_own0: torch.Tensor  # (ntiles+1,) int32: the slices each K4 tile owns
    split_slices: torch.Tensor  # (nsplit,) int32
    nrows: int
    ncols: int
    tile: int  # slice columns per K4 tile
    max_width: int

    def __post_init__(self):
        # K6's tile mode (``kernels.panel.panel_spmv_fused``): the words its
        # split slices' pieces are published in, K4's partial slots as int64
        # (2·ntiles, 32), on a float32 CUDA plan, zeroed once here, outside
        # any CUDA-graph capture, and left 0 by every launch. Not a field,
        # so ``stream_bytes`` does not count it.
        if self.vals.device.type == "cuda" and self.vals.dtype == torch.float32:
            object.__setattr__(self, "fused_words", torch.zeros(
                (2 * self.ntiles, 32), dtype=torch.int64, device=self.vals.device))

    @classmethod
    @trace.traced("plan.upload")
    def from_plan(cls, plan: PanelPlan, device) -> "DevPanel":
        device = torch.device(device)
        return cls(slice_ptr=_put(plan.slice_ptr, device, np.int32),
                   vals=_put(plan.vals, device), cols=_put(plan.cols, device),
                   tile_slice0=_put(plan.tile_slice0, device),
                   tile_own0=_put(plan.tile_own0, device),
                   split_slices=_put(plan.split_slices, device),
                   nrows=plan.nrows, ncols=plan.ncols, tile=plan.tile,
                   max_width=plan.max_width)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nslices(self) -> int:
        return self.slice_ptr.numel() - 1

    @property
    def nslots(self) -> int:
        return self.vals.numel()

    @property
    def ntiles(self) -> int:
        return self.tile_slice0.numel() - 1

    @property
    def nsplit(self) -> int:
        return self.split_slices.numel()

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plan's tensors on the device."""
        return _tensor_bytes(self)

    @property
    def fused(self) -> bool:
        """Small plans take the one-dispatch kernel K6 (the predicate of
        ``DevCsr.fused``, as the JAX engines share theirs; K6 picks its own
        mode, ``kernels.panel.fused_mode``)."""
        return self.stream_bytes <= FUSED_STREAM_BYTES_MAX


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def x_to_device(x, ncols: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (numpy, list or tensor, any real dtype) → contiguous ``dtype``
    tensor of length ``ncols`` on ``device`` (the counterpart of
    ``spmv_tpu/device.py:x_to_table``, without the TPU table padding).
    float64 is the fp64-grade mode's x, which replaces JAX's hi∥lo table
    (``x_to_table_x2``): the kernels read it whole."""
    if isinstance(x, torch.Tensor):
        xt = x.to(device=device, dtype=dtype)
    else:
        xt = torch.from_numpy(np.asarray(x, dtype=_np_dtype(dtype))).to(device)
    xt = xt.reshape(-1).contiguous()
    if xt.numel() != ncols:
        raise ValueError(f"x has {xt.numel()} entries, matrix has {ncols} columns")
    return xt


def X_to_device(X, ncols: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """X (numpy or tensor, any real dtype, any strides) → contiguous
    row-major ``dtype`` tensor of shape (ncols, R) on ``device``: the layout
    the multi-RHS kernels read, one row of R floats per column index. A
    transposed or sliced X is copied here, not refused by a kernel."""
    if isinstance(X, torch.Tensor):
        Xt = X.to(device=device, dtype=dtype)
    else:
        Xt = torch.from_numpy(np.ascontiguousarray(X, dtype=_np_dtype(dtype))).to(device)
    if Xt.dim() != 2 or Xt.shape[0] != ncols:
        raise ValueError(f"X must be ({ncols}, R), got {tuple(Xt.shape)}")
    return Xt.contiguous()


def y_to_numpy(y: torch.Tensor, nrows: int,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Device y → host array, checking its length and dtype."""
    if y.dtype != dtype or y.shape != (nrows,):
        raise ValueError(f"y must be {dtype} of shape ({nrows},), got "
                         f"{y.dtype} {tuple(y.shape)}")
    return y.cpu().numpy()


def Y_to_numpy(Y: torch.Tensor, nrows: int, R: int,
               dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Device Y → host (nrows, R) array, checking shape and dtype."""
    if Y.dtype != dtype or Y.shape != (nrows, R):
        raise ValueError(f"Y must be {dtype} of shape ({nrows}, {R}), got "
                         f"{Y.dtype} {tuple(Y.shape)}")
    return Y.cpu().numpy()

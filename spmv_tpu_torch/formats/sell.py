"""SELL-C-σ — sliced ELLPACK with local row sorting.

Counterpart of ``spmv_tpu/formats/sell.py`` (reference: ``sigma_c.c`` +
``kernels/Sigma_C.cl``, which implement only the C-slicing and read a
pre-sorted file, never unpermuting y).

* **σ is real**: at conversion, rows sort by descending length, stably,
  within windows of σ rows (σ a multiple of 128, at most 1024, as JAX
  takes it). The sort is **adaptive**: it applies only when it shrinks the
  padded panel, counted on the port's own 32-row slices (the JAX package
  counts its striped TPU panel, so the two can decide differently).
* The panel/spill split (``formats.split``) runs in sorted row space, on
  ``nrows_pad`` rows. A sorted matrix runs the panel's tile kernel (K4, or
  K6 for a small plan), the spill's engine where it spills, then one
  epilogue, K7 (``kernels.panel.sorted_panel_and_spill_spmv``), which sums
  the split slices' partials, adds the spill's y′, takes y′ back to the
  original row order and cuts it to ``nrows``; ``matmat`` does the same
  for Y with K10, K8 + K9 and one K7 over rows of R floats. Where the sort
  was not applied the parts run as ELL's do and no K7 is launched. Where
  the split spills everything, the sort is dropped again: a pure spill has
  no panel widths to shrink.
* The format's public surface — ``slice_widths``, ``sell_arrays()``,
  ``from_sell`` — keeps the JAX container's C = 128 (``SellMatrix.C``), so
  its classical arrays match JAX's bit for bit wherever both make the same
  sort decision. The device plan uses its own C = 32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import X_to_device, x_to_device
from spmv_tpu_torch.formats.base import SLICE_ROWS, cdiv, check_rows
from spmv_tpu_torch.formats.split import (PanelSpill, PanelSpillFormat,
                                          split_triplets)
from spmv_tpu_torch.kernels.panel import (sorted_panel_and_spill_spmm,
                                          sorted_panel_and_spill_spmv)

__all__ = ["SellMatrix", "DEFAULT_SIGMA", "sigma_sort_tables", "sort_and_split"]

DEFAULT_SIGMA = 1024  # rows per sorting window (spmv_tpu/formats/sell.py:37)
_LANES = 128  # the JAX container's slice height C, for the format arrays


def _panel_slots(lengths: np.ndarray) -> int:
    """Padded slots of the port's panel for these row lengths (a multiple
    of 32 rows long): 32 · Σ over slices of the longest row."""
    return SLICE_ROWS * int(lengths.reshape(-1, SLICE_ROWS).max(axis=1).sum())


def sigma_sort_tables(rows, nrows: int, sigma: int = DEFAULT_SIGMA, *,
                      force_identity: bool = False):
    """The σ-sort decision and its permutation.

    Within each σ-row window rows stable-sort by descending length; the
    sort applies only when it shrinks the padded panel. Returns
    ``(rows_sorted, sorted_, perm, invperm, nrows_pad)``: ``perm`` maps a
    sorted position to its original row, ``invperm`` the reverse (both the
    identity when the sort was not applied)."""
    rows = np.asarray(rows, dtype=np.int64)
    nrows_pad = cdiv(max(nrows, 1), sigma) * sigma
    lengths = np.zeros(nrows_pad, dtype=np.int64)
    lengths[:nrows] = np.bincount(rows, minlength=nrows)
    win = lengths.reshape(-1, sigma)
    order_in_win = np.argsort(-win, axis=1, kind="stable")
    base = (np.arange(win.shape[0], dtype=np.int64) * sigma)[:, None]
    perm = (base + order_in_win).reshape(-1)  # perm[sorted_pos] = orig row
    if (not force_identity and rows.size
            and _panel_slots(lengths[perm]) < _panel_slots(lengths)):
        invperm = np.empty_like(perm)
        invperm[perm] = np.arange(nrows_pad, dtype=np.int64)
        return invperm[rows], True, perm, invperm, nrows_pad
    ident = np.arange(nrows_pad, dtype=np.int64)
    return rows, False, ident, ident, nrows_pad


def sort_and_split(rows, cols, vals, nrows: int, sigma: int = DEFAULT_SIGMA,
                   split: bool = True):
    """The σ-sort and the panel/spill split in sorted row space, as
    ``SellMatrix`` and the fp64-grade SELL (``x2.X2Matrix``) build them:
    ``(rows_sorted, sorted_, perm, invperm, nrows_pad, (r, c, v, keep,
    shape))``, the last five from ``split_triplets`` over ``nrows_pad``
    rows. Both depend only on the pattern; the values ride along. A row
    outside ``[0, nrows)`` is refused first, with ``csr_ptr``'s message."""
    if sigma % _LANES or sigma <= 0 or sigma > 1024:
        raise ValueError("sigma must be a positive multiple of 128, ≤ 1024")
    rows = check_rows(rows, nrows)
    rows_sorted, sorted_, perm, invperm, nrows_pad = sigma_sort_tables(
        rows, nrows, sigma)
    # the split runs in sorted row space, so the spill's y' adds to the
    # panel's before the one unpermute
    parts = split_triplets(rows_sorted, cols, vals, nrows_pad, split)
    if sorted_ and parts[4] == "spill":
        # everything spilled: no panel widths to shrink, and the sort
        # would only scatter the CSR stream and add the gather
        rows_sorted, sorted_, perm, invperm, nrows_pad = sigma_sort_tables(
            rows, nrows, sigma, force_identity=True)
        parts = split_triplets(rows_sorted, cols, vals, nrows_pad, split)
    return rows_sorted, sorted_, perm, invperm, nrows_pad, parts


@dataclass
class SellMatrix(PanelSpillFormat):
    nrows: int
    ncols: int
    nnz: int
    sigma: int
    slice_widths: np.ndarray  # per-slice padded K, slices of C = 128 rows
    parts: PanelSpill = field(repr=False)  # over nrows_pad sorted rows
    sorted_rows: bool  # did the adaptive σ-sort apply?
    invperm_dev: torch.Tensor | None = field(repr=False)  # (nrows_pad,) int32, K7's table
    # sorted-space rows with the input's cols/vals, and the permutation,
    # for the classical arrays (sigma_c.c:156-202) and to_coo
    _rows_sorted: np.ndarray = field(repr=False)
    _cols: np.ndarray = field(repr=False)
    _vals: np.ndarray = field(repr=False)
    _perm: np.ndarray = field(repr=False)  # sorted position -> original row

    C = _LANES

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 sigma: int = DEFAULT_SIGMA, split: bool = True,
                 device) -> "SellMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        rows_sorted, sorted_, perm, invperm, nrows_pad, split_out = \
            sort_and_split(rows, cols, vals, nrows, sigma, split)
        parts = PanelSpill.from_split(nrows_pad, ncols, *split_out,
                                      device=device)

        # per 128-row slice padded width of the sorted lengths: the
        # format's slice metadata, after any reset of the sort
        lengths = np.zeros(nrows_pad, dtype=np.int64)
        lengths[:nrows] = np.bincount(rows, minlength=nrows)
        slice_widths = lengths[perm].reshape(-1, _LANES).max(axis=1)
        return cls(
            nrows=nrows, ncols=ncols, nnz=rows.size, sigma=sigma,
            slice_widths=slice_widths, parts=parts, sorted_rows=sorted_,
            invperm_dev=(torch.from_numpy(invperm.astype(np.int32)).to(device)
                         if sorted_ else None),
            _rows_sorted=np.asarray(rows_sorted, np.int64),
            _cols=np.asarray(cols, np.int32), _vals=vals, _perm=perm)

    @classmethod
    def from_sell(cls, nrows: int, ncols: int, slice_ptr, data, cols,
                  perm=None, **kwargs) -> "SellMatrix":
        """Ingest the classical sliced arrays (``sigma_c.c:156-202``):
        element j of row r of slice s sits at ``slice_ptr[s] + r + j·C``
        (column-major within the slice, C = 128). ``perm`` maps a sorted
        position to its original row (identity when None, as in the
        reference). Pad slots are value 0."""
        slice_ptr = np.asarray(slice_ptr, dtype=np.int64)
        data = np.asarray(data).reshape(-1)
        cols = np.asarray(cols).reshape(-1)
        if data.size != slice_ptr[-1]:
            raise ValueError(f"data has {data.size} slots, slice_ptr ends at "
                             f"{slice_ptr[-1]}")
        nz = np.flatnonzero(data != 0)
        s = np.searchsorted(slice_ptr, nz, side="right") - 1
        sr = s * _LANES + (nz - slice_ptr[s]) % _LANES  # sorted row
        orig = sr if perm is None else np.asarray(perm, np.int64)[sr]
        return cls.from_coo(nrows, ncols, orig, cols[nz], data[nz], **kwargs)

    def sell_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The classical sliced arrays ``(slice_ptr, data, cols)``
        (``sigma_c.c:84-202``): per slice of C = 128 sorted rows a padded
        width ``slice_widths[s]``, column-major within the slice, zero
        padding."""
        widths = np.asarray(self.slice_widths, np.int64)
        slice_ptr = np.zeros(widths.size + 1, dtype=np.int64)
        np.cumsum(widths * _LANES, out=slice_ptr[1:])
        data = np.zeros(max(int(slice_ptr[-1]), 1), dtype=np.float64)
        colsa = np.zeros(max(int(slice_ptr[-1]), 1), dtype=np.int32)
        if self._rows_sorted.size:
            order = np.lexsort((self._cols, self._rows_sorted))
            sr = self._rows_sorted[order]
            starts = np.zeros(sr.max() + 2, dtype=np.int64)
            np.cumsum(np.bincount(sr, minlength=sr.max() + 1), out=starts[1:])
            k = np.arange(sr.size, dtype=np.int64) - starts[sr]
            pos = slice_ptr[sr // _LANES] + sr % _LANES + k * _LANES
            data[pos] = self._vals[order]
            colsa[pos] = self._cols[order]
        return slice_ptr, data, colsa

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` with the original row ids, in input
        order, as fresh copies."""
        return (self._perm[self._rows_sorted],
                np.array(self._cols, np.int64, copy=True),
                np.array(self._vals, copy=True))

    @property
    def perm(self) -> np.ndarray:
        """Sorted position → original row (identity when unsorted)."""
        return self._perm

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the plans and of K7's table on the device."""
        extra = (self.invperm_dev.numel() * 4 if self.invperm_dev is not None
                 else 0)
        return self.parts.stream_bytes + extra

    @staticmethod
    def cpu_spmv(slice_ptr, data, cols, perm, x, nrows: int) -> np.ndarray:
        """Host recompute from the classical sliced arrays — the redundancy
        check the reference lacks for this format."""
        slice_ptr = np.asarray(slice_ptr, np.int64)
        data = np.asarray(data, np.float64).reshape(-1)
        cols = np.asarray(cols).reshape(-1)
        x = np.asarray(x, np.float64)
        n = data.size
        s = np.searchsorted(slice_ptr, np.arange(n), side="right") - 1
        sr = s * _LANES + (np.arange(n) - slice_ptr[s]) % _LANES
        orig = sr if perm is None else np.asarray(perm, np.int64)[sr]
        y = np.zeros(max(int(orig.max(initial=0)) + 1, nrows), np.float64)
        np.add.at(y, orig, data * x[cols])
        return y[:nrows]

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the plan's device."""
        xt = x_to_device(x, self.ncols, self.dev.device)
        if not self.sorted_rows:  # identity permutation: no epilogue
            return self.parts.spmv(xt)[:self.nrows]
        return sorted_panel_and_spill_spmv(self.dev, self.dev_spill, self.invperm_dev,
                                           xt, self.nrows)

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``: the
        parts' multi-RHS passes in sorted row space, then one K7 launch over
        rows of R floats, as ``matvec`` does for one vector (``api.spmm``
        takes any R)."""
        Xt = X_to_device(X, self.ncols, self.dev.device)
        if not self.sorted_rows:  # identity permutation: no epilogue
            return self.parts.spmm(Xt)[:self.nrows]
        return sorted_panel_and_spill_spmm(self.dev, self.dev_spill, self.invperm_dev,
                                           Xt, self.nrows)

    __matmul__ = matvec

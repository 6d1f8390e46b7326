"""HYB — hybrid ELL + spill (the JAX package's framework extension,
cuSPARSE's HYB).

Counterpart of ``spmv_tpu/formats/hyb.py``: the byte-priced split
(``formats.split``) is the format. Each 32-row slice of the panel is capped
at its byte-optimal width, the rest of each row spills to a CSR plan on the
segmented engine, and the split keeps the cheapest of pure panel, capped
panel plus spill, and pure spill. ``matvec`` runs the parts it has, and
K7 adds the spill's y into the panel's (``kernels.panel.
panel_and_spill_spmv``). A matrix with no elements is an empty panel and
launches nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import X_to_device, x_to_device
from spmv_tpu_torch.formats.split import PanelSpill, PanelSpillFormat, split_triplets

__all__ = ["HybMatrix"]


@dataclass
class HybMatrix(PanelSpillFormat):
    nrows: int
    ncols: int
    nnz: int
    parts: PanelSpill = field(repr=False)
    # triplets in (row, col) order (the split's order), for to_coo
    _rows: np.ndarray = field(repr=False)
    _cols: np.ndarray = field(repr=False)
    _vals: np.ndarray = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 device) -> "HybMatrix":
        r, c, v, keep, shape = split_triplets(rows, cols, vals, nrows)
        return cls(nrows=nrows, ncols=ncols, nnz=r.size,
                   parts=PanelSpill.from_split(nrows, ncols, r, c, v, keep,
                                               shape, device=device),
                   _rows=r, _cols=c.astype(np.int32), _vals=v)

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` in (row, col) order, as fresh copies (the
        same set as JAX's, whose order follows its TPU layout)."""
        return (np.array(self._rows, np.int64, copy=True),
                np.array(self._cols, np.int64, copy=True),
                np.array(self._vals, copy=True))

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the plan's device."""
        return self.parts.spmv(x_to_device(x, self.ncols, self.dev.device))

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``, in
        one multi-RHS pass over each part (``api.spmm`` takes any R)."""
        return self.parts.spmm(X_to_device(X, self.ncols, self.dev.device))

    __matmul__ = matvec

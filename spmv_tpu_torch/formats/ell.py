"""ELL — ELLPACK (global padded row length K).

Counterpart of ``spmv_tpu/formats/ell.py`` (reference: ``ell.c`` +
``kernels/Ell.cl``). The format's surface is the JAX container's: ``K``,
the row-length stats (``ell.c:103-104``), the classical row-major
``(nrows, K)`` arrays with explicit zero pads (``ell.c:147-151`` left them
uninitialized) and ``from_ell``. The device lowering is the port's: the
byte-priced panel/spill split (``formats.split``) over 32-row sliced
ELLPACK, so a power-law matrix spills its long rows to the CSR engine
instead of padding every slice to them; ``split=False`` keeps the whole
matrix in the panel (bench.py's ``ell_pure``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import X_to_device, x_to_device
from spmv_tpu_torch.formats.split import (PanelSpill, PanelSpillFormat,
                                          split_triplets)

__all__ = ["EllMatrix"]


@dataclass
class EllMatrix(PanelSpillFormat):
    nrows: int
    ncols: int
    nnz: int
    K: int  # max row length (the ELL width)
    row_length_stats: dict  # average / shortest / longest (ell.c:103-104)
    parts: PanelSpill = field(repr=False)
    # triplets in (row, col) order, for the classical arrays and to_coo
    _rows: np.ndarray = field(repr=False)
    _cols: np.ndarray = field(repr=False)
    _vals: np.ndarray = field(repr=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 split: bool = True, device) -> "EllMatrix":
        r, c, v, keep, shape = split_triplets(rows, cols, vals, nrows, split)
        lengths = (np.bincount(r, minlength=nrows) if r.size
                   else np.zeros(nrows, np.int64))
        K = int(lengths.max()) if nrows else 0
        stats = {
            "average": float(lengths.mean()) if nrows else 0.0,
            "shortest": int(lengths.min()) if nrows else 0,
            "longest": K,
        }
        return cls(nrows=nrows, ncols=ncols, nnz=r.size, K=K,
                   row_length_stats=stats,
                   parts=PanelSpill.from_split(nrows, ncols, r, c, v, keep,
                                               shape, device=device),
                   _rows=r, _cols=c.astype(np.int32), _vals=v)

    @classmethod
    def from_ell(cls, nrows: int, ncols: int, data, cols, **kwargs) -> "EllMatrix":
        """Ingest the classical row-major padded arrays ``data``/``cols`` of
        shape (nrows, K), as ``ell.c:121-158`` builds them. Zero values are
        padding (explicitly stored zeros too, the ELL convention)."""
        data = np.asarray(data)
        cols = np.asarray(cols)
        if data.shape != cols.shape or data.ndim != 2 or data.shape[0] != nrows:
            raise ValueError(f"data/cols must both be (nrows, K); got "
                             f"{data.shape} / {cols.shape}")
        mask = data != 0
        r, _ = np.nonzero(mask)
        return cls.from_coo(nrows, ncols, r, cols[mask], data[mask], **kwargs)

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` in (row, col) order, as fresh copies."""
        return (np.array(self._rows, np.int64, copy=True),
                np.array(self._cols, np.int64, copy=True),
                np.array(self._vals, copy=True))

    def ell_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The classical row-major (nrows, max(K, 1)) ``(data, cols)``
        arrays (``ell.c:121-158``), float64 and int32, zero-padded."""
        data = np.zeros((self.nrows, max(self.K, 1)), dtype=np.float64)
        colsa = np.zeros((self.nrows, max(self.K, 1)), dtype=np.int32)
        if self._rows.size:
            starts = np.zeros(self.nrows + 1, dtype=np.int64)
            np.cumsum(np.bincount(self._rows, minlength=self.nrows),
                      out=starts[1:])
            k = np.arange(self._rows.size, dtype=np.int64) - starts[self._rows]
            data[self._rows, k] = self._vals
            colsa[self._rows, k] = self._cols
        return data, colsa

    @staticmethod
    def cpu_spmv(data, cols, x) -> np.ndarray:
        """Host recompute from the classical arrays (``ell.c:357-383``): a
        conversion that kept the triplets but mislaid the format arrays
        fails this, not only the device check."""
        x = np.asarray(x, dtype=np.float64)
        return (np.asarray(data, np.float64) * x[cols]).sum(axis=1)

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the plan's device."""
        return self.parts.spmv(x_to_device(x, self.ncols, self.dev.device))

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ ``MULTI_RHS_MAX``, in
        one multi-RHS pass over each part (``api.spmm`` takes any R)."""
        return self.parts.spmm(X_to_device(X, self.ncols, self.dev.device))

    __matmul__ = matvec

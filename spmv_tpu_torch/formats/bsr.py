"""BSR — 128×128 block-sparse, the multi-RHS (SpMM) format.

Counterpart of ``spmv_tpu/formats/bsr.py``. Only the nonempty (128-row
block, 128-column stripe) tiles are held, densely, as float32 on the
device. ``Y = A @ X`` gathers each tile's 128-row stripe of X, multiplies
all tiles at once with ``torch.bmm`` (JAX does the same with
``dot_general`` outside any Pallas kernel), and sums each block row's tiles
with ``torch.segment_reduce`` over the block-row-sorted tiles: a fixed
order, no float atomics, so two calls give the same bits.

Dense tiles cost ``fill = dense slots / nnz`` times the bytes of the
nonzeros; with R right-hand sides the arithmetic per tile byte is R times
SpMV's, so the format pays for its fill at large R. ``from_coo`` refuses
a matrix whose fill exceeds ``max_fill`` once the tiles are large (the JAX
guard, same message), and a caller should loop a matvec format instead.

Precision, as in JAX:

* ``"highest"`` (default): float32 products and sums, with TF32 off for
  the call (``_fp32_matmul``; the global setting is restored after it).
  Per row, the error is that of any fp32 sum of the row's nonzeros.
* ``"default"``: bf16 operands, as the TPU's default matmul precision has
  it (``spmv_tpu/formats/bsr.py:40-41``): tiles and X are rounded to
  bfloat16, the products are exact in float32 and summed in float32. The
  result carries bf16's tolerance, a relative 2⁻⁸ per operand (about 8e-3
  of Σ|a||x| per row), not float32's.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from spmv_tpu_torch.device import X_to_device, x_to_device
from spmv_tpu_torch.formats.base import cdiv

__all__ = ["BSRMatrix", "BLOCK"]

BLOCK = 128  # tile side (spmv_tpu/formats/base.py LANES)


@contextlib.contextmanager
def _fp32_matmul():
    """float32 matmuls in full float32 (no TF32) inside the block; the
    global setting is restored after it. TF32 keeps about three decimal
    digits, which reads as a ~1e-3 mismatch against the fp64 oracle."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):  # torch ≥ 2.9; do not mix in the old flag
        prev = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = prev
    else:
        prev = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = prev


@dataclass
class BSRMatrix:
    nrows: int
    ncols: int
    nnz: int
    fill: float  # dense tile slots per nonzero
    precision: str  # "highest" (f32) or "default" (bf16 operands)
    tiles: torch.Tensor = field(repr=False)  # (T, 128, 128) float32
    tile_blk: torch.Tensor = field(repr=False)  # (T,) int32, nondecreasing
    tile_stp: torch.Tensor = field(repr=False)  # (T,) int32
    blk_tiles: torch.Tensor = field(repr=False)  # (nb,) int64: tiles per block row

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 max_fill: float = 64.0, precision: str = "highest",
                 device) -> "BSRMatrix":
        if precision not in ("highest", "default"):
            raise ValueError(f"precision must be 'highest' or 'default', got "
                             f"{precision!r}")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        nnz = rows.size
        if nnz and (rows.min() < 0 or rows.max() >= nrows
                    or cols.min() < 0 or cols.max() >= ncols):
            raise ValueError("row or column index out of bounds")
        ns = cdiv(max(ncols, 1), BLOCK)
        nb = cdiv(max(nrows, 1), BLOCK)
        pair = (rows >> 7) * ns + (cols >> 7)
        upair, inv = np.unique(pair, return_inverse=True)  # sorted: by block row
        T = max(upair.size, 1)
        fill = T * BLOCK * BLOCK / max(nnz, 1)
        # guard only when the dense blowup is material (spmv_tpu/formats/bsr.py:79-84)
        if nnz and fill > max_fill and T * BLOCK * BLOCK * 4 > 16 * 2**20:
            raise ValueError(
                f"block density too low for BSR (fill {fill:.0f}x > "
                f"max_fill {max_fill}); use a matvec format instead")
        tiles = np.zeros((T, BLOCK, BLOCK), np.float32)
        if nnz:  # duplicates sum
            np.add.at(tiles, (inv, rows & (BLOCK - 1), cols & (BLOCK - 1)), vals)
        tile_blk = (upair // ns).astype(np.int32) if nnz else np.zeros(1, np.int32)
        tile_stp = (upair % ns).astype(np.int32) if nnz else np.zeros(1, np.int32)
        if precision == "default":  # bf16 operands: round once, here
            tiles = torch.from_numpy(tiles).bfloat16().float().numpy()
        device = torch.device(device)
        return cls(nrows=nrows, ncols=ncols, nnz=nnz, fill=fill,
                   precision=precision, tiles=torch.from_numpy(tiles).to(device),
                   tile_blk=torch.from_numpy(tile_blk).to(device),
                   tile_stp=torch.from_numpy(tile_stp).to(device),
                   blk_tiles=torch.from_numpy(np.bincount(
                       tile_blk, minlength=nb).astype(np.int64)).to(device))

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def stream_bytes(self) -> int:
        """Exact bytes of the tiles and their indices on the device."""
        return sum(t.numel() * t.element_size()
                   for t in (self.tiles, self.tile_blk, self.tile_stp, self.blk_tiles))

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(rows, cols, vals)`` from the dense tiles. Lossy by the
        format's nature, as in JAX: explicitly stored zeros vanish and
        duplicates arrive summed — the triplets give the operator."""
        if self.nnz == 0:
            z = np.zeros(0, np.int64)
            return z, z.copy(), np.zeros(0)
        tiles = self.tiles.cpu().numpy()
        t, rr, cc = np.nonzero(tiles)
        blk = self.tile_blk.cpu().numpy().astype(np.int64)[t]
        stp = self.tile_stp.cpu().numpy().astype(np.int64)[t]
        return (blk * BLOCK + rr, stp * BLOCK + cc,
                tiles[t, rr, cc].astype(np.float64))

    def matmat(self, X) -> torch.Tensor:
        """Y = A·X for X of shape (ncols, R), any R ≥ 0 (R = 0 gives an
        empty (nrows, 0) Y, as JAX's BSR does), as a float32 (nrows, R)
        tensor on the container's device."""
        X = X_to_device(X, self.ncols, self.device)
        R = X.shape[1]
        ns = cdiv(max(self.ncols, 1), BLOCK)
        Xp = torch.zeros(ns * BLOCK, R, dtype=torch.float32, device=self.device)
        Xp[:self.ncols] = X
        if self.precision == "default":
            Xp = Xp.bfloat16().float()
        Xg = Xp.view(ns, BLOCK, R)[self.tile_stp.long()]  # (T, 128, R)
        with _fp32_matmul():
            P = torch.bmm(self.tiles, Xg)  # (T, 128, R)
        Y = torch.segment_reduce(P, "sum", lengths=self.blk_tiles, axis=0,
                                 initial=0.0)  # (nb, 128, R), tiles in order
        return Y.reshape(Y.shape[0] * BLOCK, R)[:self.nrows]  # R may be 0

    def matvec(self, x) -> torch.Tensor:
        """y = A·x as a float32 tensor on the container's device."""
        return self.matmat(x_to_device(x, self.ncols, self.device)[:, None])[:, 0]

    __matmul__ = matmat

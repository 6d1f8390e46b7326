"""The plain reference: SpMV, conjugate gradients and power iteration in
plain PyTorch, at a precision the caller names.

It imports nothing of the program. It takes the benchmark's own triplets
and works out everything from them again. ``Operator(..., dtype=float64)``
is the reference that judges the program. The same algorithms at a lower
precision are the control that the comparison has to refuse
(``benchmark/readings.py``, ``benchmark/tests/test_bench_control.py``).
In the control, values and vectors are stored in that type, and products
and sums run in float32, as a kernel that stores bfloat16 would run them.

The SpMV works in blocks of rows. Its temporaries then stay near
``BLOCK_NNZ`` entries whatever the matrix.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Operator", "cg", "power_iteration", "BLOCK_NNZ"]

BLOCK_NNZ = 1 << 25
_EPS = 1e-30


class Operator:
    """A CSR matrix on ``device``: the triplets' values and ``x`` stored in
    ``dtype``; products and sums in float64 for float64, else float32."""

    def __init__(self, nrows: int, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, *, dtype: torch.dtype, device):
        self.n = int(nrows)
        self.dtype = dtype
        self.acc = torch.float64 if dtype == torch.float64 else torch.float32
        self.device = torch.device(device)
        ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=self.n), out=ptr[1:])
        self.ptr = ptr
        self.cols = torch.from_numpy(np.asarray(cols)).to(self.device).long()
        self.vals = torch.from_numpy(np.asarray(vals, np.float64)).to(self.device).to(dtype)
        # blocks of whole rows, each at most BLOCK_NNZ entries unless one
        # row is longer; each block's rows counted from its first
        cuts = [0]
        while cuts[-1] < self.n:
            r0 = cuts[-1]
            r1 = int(np.searchsorted(ptr, ptr[r0] + BLOCK_NNZ, side="right")) - 1
            cuts.append(min(max(r1, r0 + 1), self.n))
        self.blocks = []
        for r0, r1 in zip(cuts[:-1], cuts[1:]):
            lo, hi = int(ptr[r0]), int(ptr[r1])
            local = torch.from_numpy(np.asarray(rows[lo:hi], np.int64) - r0)
            self.blocks.append((r0, r1, lo, hi, local.to(self.device)))

    def vector(self, v) -> torch.Tensor:
        """``v`` stored as this operator stores vectors."""
        return torch.as_tensor(v).to(self.device).to(self.dtype)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        xa = x.to(self.acc)
        y = torch.zeros(self.n, dtype=self.acc, device=self.device)
        for r0, r1, lo, hi, local in self.blocks:
            prod = self.vals[lo:hi].to(self.acc) * xa[self.cols[lo:hi]]
            y[r0:r1].index_add_(0, local, prod)
        return y.to(self.dtype)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(a.to(self.acc), b.to(self.acc)).to(self.dtype)


def cg(op: Operator, b, *, tol: float, maxiter: int):
    """Conjugate gradients from x0 = 0 with the program's stopping rule
    (``rs > tol²·max(b·b, 1e-30)`` and ``k < maxiter``): (x, k)."""
    b = op.vector(b)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = op.dot(r, r)
    bound = float(tol) ** 2 * max(float(op.dot(b, b)), _EPS)
    k = 0
    while float(rs) > bound and k < maxiter:
        ap = op.matvec(p)
        alpha = rs / op.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = op.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return x, k


def power_iteration(op: Operator, v0, *, iters: int):
    """``iters`` steps of ``v = w / sqrt(w·w + 1e-30)``, ``w = A·v``, from
    ``v0``; returns (v·A·v, v)."""
    v = op.vector(v0)
    for _ in range(iters):
        w = op.matvec(v)
        v = w * torch.rsqrt(op.dot(w, w) + _EPS)
    return float(op.dot(v, op.matvec(v))), v

"""Ring-rotated SpMV: x stays column-blocked and travels round the ranks.

Counterpart of ``spmv_tpu/dist/ring.py``. Rank r owns row slab r of A,
split into D column blocks, one container each (``blocks[j]``: rows
``[r·rps, (r+1)·rps)`` × columns ``[j·cps, (j+1)·cps)``), and starts with
x block r. At step k it holds block j = (r − k) mod D. It first issues
the shift of that block to rank r + 1 and the receive of rank r − 1's
(``mesh.ring_shift``, both in flight), then multiplies ``blocks[j]`` by
the block it holds into its y slab, in step order, and then waits for the
shift: the double buffer of JAX's ``ring.py:172-178``, with the transfer
independent of the step's kernels. A rank never holds more than two x
blocks, O(ncols/D) instead of the whole x.

Each block's container returns its partial y in row order, so JAX's one
σ-sort per row slab, shared by the slab's blocks, has no counterpart:
every SELL block sorts (or not) on its own and unsorts with its own K7.

The last step's shift is not issued: nothing reads the block it would
bring. A ring of one rank has no neighbour (gloo refuses a send to the
rank itself), so at D = 1 there is no shift at all and the one block is
the whole slab. BSR is refused, as in JAX.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.dist.mesh import Mesh, all_gather, ring_shift
from spmv_tpu_torch.dist.sharded import (Sharded, _triplets, columns, container,
                                         rhs_count, slab, slab_of)

__all__ = ["RingShardedSpmv", "ring_schedule"]


def ring_schedule(rank: int, D: int) -> list[int]:
    """The column block rank ``rank`` multiplies at each step k:
    (rank − k) mod D."""
    return [(rank - k) % D for k in range(D)]


class RingShardedSpmv(Sharded):
    """y = A·x, A row-partitioned × column-blocked, x rotated on a ring.
    ``spmm`` for 2 ≤ R ≤ ``MULTI_RHS_MAX`` passes the (cps, R) blocks of
    all R columns round the ring together, one multi-RHS pass per step;
    otherwise one ring ``matvec`` per column."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, **fmt_kwargs):
        format = format.lower()
        if format == "bsr":
            raise NotImplementedError(
                "ring-sharded BSR not supported (block-dense container); "
                "use RowShardedSpmv('bsr', ...) or csr/coo/cmrs/ell/sell/"
                "hyb")
        super().__init__(format, nrows, ncols, mesh)
        D, r = mesh.size, mesh.rank
        self.rps, self.cps = slab(nrows, D), slab(ncols, D)
        rows, cols, vals = _triplets(rows, cols, vals, False)
        lo = r * self.rps
        mine = (rows >= lo) & (rows < lo + self.rps)
        rows, cols, vals = rows[mine] - lo, cols[mine], vals[mine]
        block = cols // self.cps
        self.blocks = [
            container(format, self.rps, self.cps, rows[block == j],
                      cols[block == j] - j * self.cps, vals[block == j],
                      mesh.device, **fmt_kwargs)
            for j in range(D)]
        self.schedule = ring_schedule(r, D)

    def _ring(self, held: torch.Tensor, mul) -> torch.Tensor:
        """This rank's y slab from its own x block ``held``: one step per
        block, each shift in flight during the step's multiply."""
        y = None
        last = len(self.schedule) - 1
        for k, j in enumerate(self.schedule):
            nxt, works = ring_shift(held, self.mesh) if k < last else (None, ())
            part = mul(self.blocks[j], held)
            y = part if y is None else y + part
            for w in works:
                w.wait()
            held = nxt
        return y

    def _local(self, xb: torch.Tensor) -> torch.Tensor:
        """x block (``cps`` entries) → this rank's y slab (``rps``)."""
        return self._ring(xb, lambda a, x: a.matvec(x))

    def matvec(self, x) -> torch.Tensor:
        """y = A·x, the whole y on every rank; x whole on every rank."""
        from spmv_tpu_torch.device import x_to_device

        xt = x_to_device(x, self._ncols, self.device)
        y = self._local(slab_of(xt, self.mesh.rank, self.cps))
        return all_gather(y, self.mesh)[: self._nrows]

    def spmm(self, X) -> torch.Tensor:
        """Y = A·X for X (ncols, R), the whole Y on every rank."""
        from spmv_tpu_torch.device import X_to_device
        from spmv_tpu_torch.kernels.engines import MULTI_RHS_MAX

        R = rhs_count(X)
        if R < 2 or R > MULTI_RHS_MAX:
            return columns(self, X, False)
        Xt = X_to_device(X, self._ncols, self.device)
        Y = self._ring(slab_of(Xt, self.mesh.rank, self.cps), lambda a, X: a.matmat(X))
        return all_gather(Y, self.mesh)[: self._nrows]


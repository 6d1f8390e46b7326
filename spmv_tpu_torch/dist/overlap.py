"""Chunked-gather row-sharded SpMV: the x gather split into C chunks, each
in flight during the previous chunk's multiply.

Counterpart of ``spmv_tpu/dist/overlap.py``. ``RowShardedSpmv(gather_x=
True)`` gathers the whole x, then multiplies: the collective and the
kernels run one after the other. ``ChunkedRowSpmv`` splits the gather
into C all-gathers and this rank's row slab into C matching containers.
It issues chunk c's all-gather (``async_op``) before chunk c − 1's
multiply and waits for it before chunk c's, so each transfer can run
while the card multiplies the chunk before it. A rank holds at most two
gathered chunks, O(ncols/C) of x, and the gathers move what one whole
gather moves.

The x layout is JAX's (``overlap.py:15-20, 88-93``): x as a table of
S = ``round_up(max(cdiv(ncols, 128), 8), D·C)`` rows of 128 entries, rank
d holding rows ``[d·S/D, (d+1)·S/D)``, and chunk c the all-gather of every
rank's local rows ``[c·s, (c+1)·s)``, s = S/(D·C), which lands rank-major:
a column in table row t = o·(S/D) + l lands at row o·s + (l − c·s).
Container c holds the columns whose local row l lies in chunk c,
renumbered so. The 128 and the 8 are the TPU's lanes and sublanes; they
are kept so that rank d holds JAX shard d's part of x. The slab of rows
is ``sharded.slab``. At D = 1 with C = 4 there are still four gathers and
four containers: the one overlap structure a single card can run.

The y slab is the containers' partials summed in chunk order, so it
agrees with the single container within float32 rounding, not bit for
bit. BSR is refused, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.dist.mesh import Mesh, all_gather
from spmv_tpu_torch.dist.sharded import (LANES, Sharded, _triplets, container,
                                         round_up, slab, slab_of)

__all__ = ["ChunkedRowSpmv", "chunk_columns"]

_SUBLANES = 8  # JAX's x table has at least 8 rows (``x_stripes``)


def chunk_columns(cols, ncols: int, D: int, C: int):
    """JAX's chunk layout for ``cols``: ``(S, chunk_of, new_cols)``: the x
    table's rows S, each column's chunk, and its column in the gathered
    chunk of ``D·S/(D·C)·128`` entries."""
    cols = np.asarray(cols, dtype=np.int64)
    S = round_up(max(-(-max(ncols, 1) // LANES), _SUBLANES), D * C)
    s_loc, spd = S // (D * C), S // D
    stripe = cols >> 7
    owner, lrow = stripe // spd, stripe % spd
    new_cols = ((owner * s_loc + lrow % s_loc) << 7) | (cols & (LANES - 1))
    return S, lrow // s_loc, new_cols


class ChunkedRowSpmv(Sharded):
    """y = A·x, A row-partitioned, x held as this rank's part of the table
    and all-gathered in C chunks interleaved with the chunks' multiplies
    (the overlapped form of ``RowShardedSpmv(gather_x=True)``)."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, *, chunks: int = 4, **fmt_kwargs):
        format = format.lower()
        if format == "bsr":
            raise NotImplementedError(
                "chunked-gather BSR not supported; use "
                "RowShardedSpmv('bsr', ...)")
        super().__init__(format, nrows, ncols, mesh)
        D, C = mesh.size, max(int(chunks), 1)
        self.C, self.rps = C, slab(nrows, D)
        rows, cols, vals = _triplets(rows, cols, vals, False)
        self.S, chunk_of, new_cols = chunk_columns(cols, ncols, D, C)
        self.s_loc = self.S // (D * C)
        self.width = self.s_loc * LANES  # x entries per rank per chunk
        lo = mesh.rank * self.rps
        mine = (rows >= lo) & (rows < lo + self.rps)
        self.chunks = [
            container(format, self.rps, D * self.width, rows[sel] - lo,
                      new_cols[sel], vals[sel], mesh.device, **fmt_kwargs)
            for sel in (mine & (chunk_of == c) for c in range(C))]

    def _local(self, xt: torch.Tensor) -> torch.Tensor:
        """This rank's x table rows (``S/D·128`` entries) → its y slab."""
        w = self.width

        def gather(c):
            return all_gather(xt[c * w:(c + 1) * w], self.mesh, async_op=True)

        pending, y = gather(0), None
        for c, a in enumerate(self.chunks):
            nxt = gather(c + 1) if c + 1 < self.C else None
            g, work = pending
            work.wait()
            part = a.matvec(g)
            y = part if y is None else y + part
            pending = nxt
        return y

    def matvec(self, x) -> torch.Tensor:
        """y = A·x, the whole y on every rank; x whole on every rank."""
        from spmv_tpu_torch.device import x_to_device

        xt = x_to_device(x, self._ncols, self.device)
        held = slab_of(xt, self.mesh.rank, self.S // self.mesh.size * LANES)
        return all_gather(self._local(held), self.mesh)[: self._nrows]


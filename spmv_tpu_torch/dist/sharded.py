"""Row- and column-sharded SpMV over a ``mesh.Mesh``.

Counterpart of ``spmv_tpu/dist/sharded.py``, with its constructors,
properties and refusals:

* **Row partition** (``RowShardedSpmv``): rank d owns the rows
  ``[d·rps, (d+1)·rps)`` and computes their y. x is given whole on every
  rank (``gather_x=False``), or each rank holds its x slab (the columns
  ``[d·cps, (d+1)·cps)``) and all-gathers the whole x once per call
  (``gather_x=True``). ``matvec`` all-gathers the y slabs and returns the
  whole y on every rank, as JAX's returns the global y.
* **Column partition** (``ColShardedSpmv``): rank d owns the columns
  ``[d·cps, (d+1)·cps)`` and the matching x slab, computes a partial y of
  every row, and the partials are summed over the ranks.

JAX's layout exists for one jitted ``shard_map`` over identical static
shapes: every shard's plan padded to one shape and split into DMA arrays
(``_unify_plans``), a ``Dev`` rebuilt from stacked slices, the HYB spill
unified on its own, and, for the column form of SELL, one global σ-sort
so that sorted partials can be summed before a single unsort. None of it
is ported. Each rank builds the port's own container from its slab of the
triplets (``api.from_coo``, or ``X2Matrix.from_coo`` in the fp64-grade
mode) on ``mesh.device``: its plan, its kernels and its K7 epilogue, a HYB
spill inside it. A column shard's container returns y in row order, so
the partials sum without a global σ-sort; the cost is one K7 per shard
instead of one in all. The ell and sell shards keep the port's priced
panel/spill split, as a single container does (JAX builds its panel
shards whole, ``split=False``); ``split=False`` passes through like any of
the containers' arguments (``sigma``, ``height``, ``split``, BSR's
``precision``). JAX's TPU layout keys (``pack``, ``panel_pack``,
``chunk``, ``bank``) have no counterpart: the containers refuse them.

The slab sizes are JAX's, ``round_up(max(cdiv(n, D), 128), 128)``, so rank
d owns the rows and columns of JAX's shard d. The 128 is the TPU's lane
width and means nothing to the card; a shard's container has ``rps``
rows (``cps`` columns), the last ones empty where n is ragged.

The fp64-grade mode (``dtype="f32x2"``) holds an ``X2Matrix`` per shard,
which computes in fp64 (JAX: double-single). The column form gathers the D
fp64 partials and sums them in rank order on every rank, the counterpart
of JAX's TwoSum chain, so every rank holds the same bits whatever order a
reduction would pick. The float32 column form sums with ``all_reduce``
(JAX's ``psum``).
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.dist.mesh import Mesh, all_gather, all_reduce

__all__ = ["RowShardedSpmv", "ColShardedSpmv", "Sharded", "LANES", "slab"]

# JAX's lane width: the slab sizes are multiples of it (see the docstring)
LANES = 128
# the construction arguments JAX's sharded f32x2 honours
_X2_SHARD_KWARGS = {"pack", "sigma", "chunk"}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def slab(n: int, D: int) -> int:
    """Rows (columns) per shard: JAX's ``round_up(max(cdiv(n, D), 128), 128)``."""
    return round_up(max(cdiv(n, D), LANES), LANES)


def _x2_mode(dtype: str) -> bool:
    if dtype not in ("f32", "f32x2"):
        raise ValueError(f"dtype must be 'f32' or 'f32x2', got {dtype!r}")
    return dtype == "f32x2"


def _refuse_x2(format: str, fmt_kwargs: dict) -> None:
    """JAX's refusals of the sharded f32x2 mode (``sharded.py:265-273``)."""
    if format == "hyb":
        raise NotImplementedError(
            "sharded f32x2 covers the five reference formats "
            "(csr/coo/cmrs/ell/sell); single-chip f32x2 HYB is "
            "X2Matrix.from_coo('hyb', ...)")
    if not set(fmt_kwargs) <= _X2_SHARD_KWARGS:
        raise ValueError(
            f"f32x2 sharding honors {sorted(_X2_SHARD_KWARGS)}; got "
            f"{sorted(set(fmt_kwargs) - _X2_SHARD_KWARGS)}")


def _member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError(f"this rank is outside the mesh of the first {mesh.size} "
                         f"ranks; only its members build a sharded container")


def _triplets(rows, cols, vals, x2: bool):
    return (np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64),
            np.asarray(vals, dtype=np.float64 if x2 else None))


def container(format: str, nrows: int, ncols: int, rows, cols, vals, device,
              x2: bool = False, **fmt_kwargs):
    """One shard's container: the port's own, built on ``device``."""
    if x2:
        from spmv_tpu_torch.x2 import X2Matrix

        return X2Matrix.from_coo(format, nrows, ncols, rows, cols, vals,
                                 device=device, **fmt_kwargs)
    from spmv_tpu_torch.api import from_coo

    return from_coo(format, nrows, ncols, rows, cols, vals, device=device,
                    **fmt_kwargs)


def slab_of(v: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rows ``[rank·size, (rank+1)·size)`` of ``v``, zero-padded past its end."""
    lo = rank * size
    part = v[lo:lo + size]
    if part.shape[0] == size:
        return part.contiguous()
    out = v.new_zeros((size, *v.shape[1:]))
    out[:part.shape[0]] = part
    return out


def columns(a, X, x2: bool) -> torch.Tensor:
    """One sharded ``matvec`` per column of X, stacked: the spmm of R = 1,
    of R > ``MULTI_RHS_MAX`` and of the fp64-grade mode, as JAX's ``spmm``
    of a sharded container runs it (``spmv_tpu/api.py:145-176``)."""
    from spmv_tpu_torch.api import _stack_columns
    from spmv_tpu_torch.device import X_to_device

    if x2:
        X = X_to_device(X, a.ncols, a.device, dtype=torch.float64)
        return _stack_columns(a, X, "need at least one array to stack")
    X = X_to_device(X, a.ncols, a.device)
    return _stack_columns(a, X, "Need at least one array to stack.")


def rhs_count(X) -> int:
    shape = tuple(X.shape) if hasattr(X, "shape") else np.shape(X)
    return shape[1] if len(shape) == 2 else 0


class Sharded:
    """What every sharded container has: its shape, its mesh and device,
    ``a @ x`` for ``a.matvec(x)``, and ``spmm`` as one sharded ``matvec``
    per column (the forms with a multi-RHS pass override it)."""

    x2 = False  # the fp64-grade mode (RowShardedSpmv, ColShardedSpmv)

    def __init__(self, format: str, nrows: int, ncols: int, mesh: Mesh):
        _member(mesh)
        self.format, self.mesh = format, mesh
        self._nrows, self._ncols = nrows, ncols

    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def ncols(self) -> int:
        return self._ncols

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def dtype(self) -> torch.dtype:
        """y's dtype: float64 in the fp64-grade mode, else float32."""
        return torch.float64 if self.x2 else torch.float32

    def __matmul__(self, x) -> torch.Tensor:
        return self.matvec(x)

    def spmm(self, X) -> torch.Tensor:
        """Y = A·X for X (ncols, R), the whole Y on every rank."""
        return columns(self, X, self.x2)


class RowShardedSpmv(Sharded):
    """y = A·x with A row-partitioned over ``mesh``: this rank's container
    holds its row slab (``shard``).

    ``spmm`` for 2 ≤ R ≤ ``MULTI_RHS_MAX`` all-gathers the (cps, R) slab of
    X once and runs one multi-RHS pass on the shard (K8 + K9, or K10 then
    K7); otherwise one sharded ``matvec`` per column, as JAX does. BSR has
    the row form only: each rank holds its block-row slab's
    ``BSRMatrix``, X given whole or all-gathered."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, *, gather_x: bool = True, dtype: str = "f32",
                 **fmt_kwargs):
        format = format.lower()
        self.x2 = _x2_mode(dtype)
        self._bsr = format == "bsr"
        if self._bsr and self.x2:
            raise NotImplementedError("f32x2 BSR is not supported")
        if self.x2:
            _refuse_x2(format, fmt_kwargs)
        super().__init__(format, nrows, ncols, mesh)
        self.gather_x = gather_x
        D = mesh.size
        self.rps, self.cps = slab(nrows, D), slab(ncols, D)
        rows, cols, vals = _triplets(rows, cols, vals, self.x2)
        lo = mesh.rank * self.rps
        sel = (rows >= lo) & (rows < lo + self.rps)
        self.shard = container(format, self.rps, ncols, rows[sel] - lo, cols[sel],
                               vals[sel], mesh.device, self.x2, **fmt_kwargs)

    def _x(self, xt: torch.Tensor) -> torch.Tensor:
        """The whole x (X) from what this rank holds: its slab, gathered, or
        the whole x as given."""
        if not self.gather_x:
            return xt
        return all_gather(xt, self.mesh)[: self._ncols]

    def _local(self, xs: torch.Tensor) -> torch.Tensor:
        """x slab (``cps`` entries; the whole x without ``gather_x``) → this
        rank's y slab (``rps``), with no y gather: the step that
        ``bench.scaling`` chains (JAX's ``sh._fn``)."""
        return self.shard.matvec(self._x(xs))

    def _held(self, x, matrix: bool = False) -> torch.Tensor:
        """What this rank holds of the x (X) a caller gives whole."""
        from spmv_tpu_torch.device import X_to_device, x_to_device

        to = X_to_device if matrix else x_to_device
        xt = to(x, self._ncols, self.device, dtype=self.dtype)
        return slab_of(xt, self.mesh.rank, self.cps) if self.gather_x else xt

    def _rows(self, y: torch.Tensor) -> torch.Tensor:
        return all_gather(y, self.mesh)[: self._nrows]

    def matvec(self, x) -> torch.Tensor:
        """y = A·x, the whole y on every rank (float64 in the fp64-grade
        mode); x whole on every rank."""
        if self._bsr:
            from spmv_tpu_torch.device import x_to_device

            return self.spmm(x_to_device(x, self._ncols, self.device)[:, None])[:, 0]
        return self._rows(self._local(self._held(x)))

    def spmm(self, X) -> torch.Tensor:
        """Y = A·X for X (ncols, R), the whole Y on every rank."""
        from spmv_tpu_torch.kernels.engines import MULTI_RHS_MAX

        R = rhs_count(X)
        if not self._bsr and (self.x2 or R < 2 or R > MULTI_RHS_MAX):
            return columns(self, X, self.x2)
        return self._rows(self.shard.matmat(self._x(self._held(X, matrix=True))))


class ColShardedSpmv(Sharded):
    """y = A·x with A column-partitioned over ``mesh``: this rank's
    container holds its column slab (``shard``) and returns a partial y of
    every row; the partials are summed over the ranks (``all_reduce``, or
    in rank order in the fp64-grade mode). ``spmm`` for 2 ≤ R ≤
    ``MULTI_RHS_MAX`` runs one multi-RHS pass per shard and one reduction
    of the (nrows, R) partials; otherwise one ``matvec`` per column."""

    def __init__(self, format: str, nrows: int, ncols: int, rows, cols, vals,
                 mesh: Mesh, *, dtype: str = "f32", **fmt_kwargs):
        format = format.lower()
        self.x2 = _x2_mode(dtype)
        if format == "bsr":  # the row form only (spmv_tpu/dist/sharded.py:60-67)
            raise NotImplementedError(
                "column-sharded BSR not supported (a dense-Y psum per "
                "step defeats the block-dense format); use RowShardedSpmv"
                "('bsr', ...) or shard csr/coo/cmrs/ell/sell/hyb")
        if self.x2:
            _refuse_x2(format, fmt_kwargs)
        super().__init__(format, nrows, ncols, mesh)
        self.cps = slab(ncols, mesh.size)
        rows, cols, vals = _triplets(rows, cols, vals, self.x2)
        lo = mesh.rank * self.cps
        sel = (cols >= lo) & (cols < lo + self.cps)
        self.shard = container(format, nrows, self.cps, rows[sel], cols[sel] - lo,
                               vals[sel], mesh.device, self.x2, **fmt_kwargs)

    def _sum(self, part: torch.Tensor) -> torch.Tensor:
        if not self.x2:
            return all_reduce(part, self.mesh)
        parts = all_gather(part[None], self.mesh)
        y = parts[0]
        for d in range(1, self.mesh.size):  # rank order, the same on every rank
            y = y + parts[d]
        return y

    def _local(self, xs: torch.Tensor) -> torch.Tensor:
        """x slab (``cps`` entries) → the whole y, summed over the ranks."""
        return self._sum(self.shard.matvec(xs))

    def matvec(self, x) -> torch.Tensor:
        """y = A·x, the whole y on every rank; x whole on every rank."""
        from spmv_tpu_torch.device import x_to_device

        xt = x_to_device(x, self._ncols, self.device, dtype=self.dtype)
        return self._local(slab_of(xt, self.mesh.rank, self.cps))

    def spmm(self, X) -> torch.Tensor:
        """Y = A·X for X (ncols, R), the whole Y on every rank."""
        from spmv_tpu_torch.device import X_to_device
        from spmv_tpu_torch.kernels.engines import MULTI_RHS_MAX

        R = rhs_count(X)
        if self.x2 or R < 2 or R > MULTI_RHS_MAX:
            return columns(self, X, self.x2)
        Xt = X_to_device(X, self._ncols, self.device)
        return self._sum(self.shard.matmat(slab_of(Xt, self.mesh.rank, self.cps)))

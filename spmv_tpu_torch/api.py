"""High-level API: load → convert → spmv / spmm.

Counterpart of ``spmv_tpu/api.py``, for all eight formats.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch import trace
from spmv_tpu_torch.big import TiledSpmv, fits_single_plan
from spmv_tpu_torch.device import X_to_device
from spmv_tpu_torch.dist.sharded import Sharded
from spmv_tpu_torch.formats.bsr import BSRMatrix
from spmv_tpu_torch.formats.cmrs import CMRSMatrix
from spmv_tpu_torch.formats.coo import COOMatrix
from spmv_tpu_torch.formats.csr import CSRMatrix
from spmv_tpu_torch.formats.ell import EllMatrix
from spmv_tpu_torch.formats.hyb import HybMatrix
from spmv_tpu_torch.formats.sell import SellMatrix
from spmv_tpu_torch.sym import SymmetricMatrix

__all__ = ["FORMATS", "NOT_PORTED", "from_coo", "route", "load", "spmv", "spmm",
           "from_reference"]

FORMATS = {
    "coo": COOMatrix,
    "csr": CSRMatrix,
    "ell": EllMatrix,
    "sell": SellMatrix,
    "sell_c_sigma": SellMatrix,
    "cmrs": CMRSMatrix,
    "hyb": HybMatrix,  # ELL panel + CSR spill (the JAX framework extension)
    "bsr": BSRMatrix,  # 128x128 block-dense SpMM (the JAX framework extension)
    "sym": SymmetricMatrix,  # lower-triangle storage, two segmented passes
}

# The JAX package's formats still to be ported: none (``format`` names in
# it would be refused with NotImplementedError).
NOT_PORTED = ()

# JAX container class → port format name, for ``from_reference``
_REFERENCE_CLASSES = {"COOMatrix": "coo", "CSRMatrix": "csr",
                      "CMRSMatrix": "cmrs", "EllMatrix": "ell",
                      "SellMatrix": "sell", "HybMatrix": "hyb",
                      "BSRMatrix": "bsr", "SymmetricMatrix": "sym"}
# JAX container class → the construction parameters it carries
_REFERENCE_KWARGS = {"CMRSMatrix": ("height",), "SellMatrix": ("sigma",),
                     "BSRMatrix": ("precision",)}


def _format_class(format: str):
    name = format.lower()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"format {format!r} is not ported to PyTorch yet (see ROADMAP.md)")
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown format {format!r}; choose from {sorted(FORMATS)}")


def from_coo(format: str, nrows: int, ncols: int, rows, cols, vals, *, device,
             **kwargs):
    """Convert COO triplets to the named format's container on ``device``.
    Where ``trace`` is armed, the call is a ``plan.from_coo`` span with the
    triplets' count (``nnz``) and the plans' device bytes."""
    cls = _format_class(format)
    rows = np.asarray(rows)
    with trace.maybe("plan.from_coo", nnz=rows.size) as span:
        a = cls.from_coo(nrows, ncols, rows, np.asarray(cols), np.asarray(vals),
                         device=device, **kwargs)
        if span is not None:
            span.counts["bytes"] = a.stream_bytes
    return a


def route(format: str, nrows: int, ncols: int, rows, cols, vals, *, device,
          **kwargs):
    """``load``'s conversion, as ``spmv_tpu/api.py:65-71`` routes: the
    slab-tiled ``TiledSpmv`` where one plan of the format cannot hold the
    matrix (``big.fits_single_plan``: the port's bound is a plan's int32
    index range, JAX's the TPU's VMEM), else ``from_coo``'s container.
    ``sym`` past the bound raises ``NotImplementedError``, as in JAX."""
    _format_class(format)
    if not fits_single_plan(format, nrows, ncols, rows, cols):
        if format.lower() == "sym":
            raise NotImplementedError(
                "symmetric triangle storage is a single-kernel container; "
                "use TiledSpmv/dist on the expanded form for this size")
        return TiledSpmv(format, nrows, ncols, rows, cols, vals, device=device,
                         **kwargs)
    return from_coo(format, nrows, ncols, rows, cols, vals, device=device, **kwargs)


def load(path: str, format: str = "csr", *, device, synth: dict | None = None,
         **kwargs):
    """Read a MatrixMarket file (or synthesize a cant-like matrix when it is
    a git-LFS pointer or missing; ``synth`` kwargs go to
    ``synth.synthetic_cant``) and convert it (``route``): a matrix past one
    plan's int32 index range comes back as a ``TiledSpmv``, as JAX's ``load``
    tiles one past its VMEM budget; ``from_coo`` itself never tiles. ``sym``
    reads the stored triangle of a symmetric file (no expansion), as
    ``spmv_tpu/api.py:62-64`` does; a synthesized matrix, whose pattern is
    not symmetric, is then folded onto its lower triangle (``sym``'s
    semantics, kept for parity)."""
    from spmv_tpu_torch.io.mmio import read_path_or_synthesize

    _format_class(format)  # refuse an unknown format before reading
    info, rows, cols, vals = read_path_or_synthesize(
        path, expand_symmetry=format.lower() != "sym", **(synth or {}))
    return route(format, info.nrows, info.ncols, rows, cols, vals, device=device,
                 **kwargs)


def spmv(a, x):
    """y = A @ x for any format container."""
    return a.matvec(x)


def spmm(a, X) -> torch.Tensor:
    """Y = A @ X for X of shape (ncols, R), as a float32 (nrows, R) tensor
    on the container's device (float64 for an ``X2Matrix``).

    The branches of ``spmv_tpu/api.py:145-176``: BSR runs its batched
    matmul for any R. The engine formats run one multi-RHS pass over each
    plan for 2 ≤ R ≤ ``MULTI_RHS_MAX`` (``matmat``: K8 + K9 on CSR plans and
    spill parts, K10 then one K7 on panels, σ-sorted or not), and one
    ``matvec`` per column for R = 1 or R > ``MULTI_RHS_MAX`` — the JAX
    envelope, not a fallback: a kernel that fails raises. An ``X2Matrix``
    keeps X in float64 and runs one fp64 ``matvec`` per column, as
    ``spmv_tpu/api.py:161-169`` does: the float32 multi-RHS kernels would
    drop it to fp32 grade. A sharded container (``dist``) runs its own
    ``spmm``: these branches per shard, or one sharded ``matvec`` per
    column where the form has no multi-RHS pass (``ChunkedRowSpmv``), as
    JAX's stack of ``matvec`` calls does there. A ``TiledSpmv`` takes the
    engine formats' branches, each tile's pass summed per slab (JAX stacks
    its ``matvec``s)."""
    from spmv_tpu_torch.kernels.engines import MULTI_RHS_MAX

    if isinstance(a, Sharded):
        return a.spmm(X)
    if isinstance(a, BSRMatrix):
        return a.matmat(X)
    if getattr(a, "x2", False):  # before any float32 cast of X
        X = X_to_device(X, a.ncols, a.dev.device, dtype=torch.float64)
        return _stack_columns(a, X, "need at least one array to stack")
    X = X_to_device(X, a.ncols, a.device if isinstance(a, TiledSpmv) else a.dev.device)
    if 2 <= X.shape[1] <= MULTI_RHS_MAX:
        return a.matmat(X)
    return _stack_columns(a, X, "Need at least one array to stack.")


def _stack_columns(a, X: torch.Tensor, empty: str) -> torch.Tensor:
    """One ``matvec`` per column of X, stacked. X with no columns raises
    the ``ValueError`` the JAX package's stack raises there (``empty``:
    ``jnp.stack``'s message, or ``np.stack``'s for an ``X2Matrix``)."""
    if X.shape[1] == 0:
        raise ValueError(empty)
    return torch.stack([a.matvec(X[:, j]) for j in range(X.shape[1])], dim=1)


def from_reference(a, device):
    """The port's container holding the same matrix as the JAX package's
    container ``a``: its ``to_coo()`` triplets (fresh numpy copies, original
    order for COO) go through the port's ``from_coo``, with the CMRS height,
    the SELL σ and the BSR precision; a ``SymmetricMatrix`` carries its
    stored triangle (``tri_rows``, ``tri_cols``, ``tri_vals``), not its
    expansion. A ``TiledSpmv`` becomes the port's on the same grid (``rps``,
    ``cps``): its tiles' triplets, shifted back to the matrix's rows and
    columns. Needs no JAX import; the parity tests use it."""
    kind = type(a).__name__
    if kind == "X2Matrix":
        raise NotImplementedError(
            "the JAX X2Matrix keeps no triplets (it has no to_coo): build "
            "spmv_tpu_torch.X2Matrix.from_coo from the same triplets instead")
    if kind == "TiledSpmv":
        return _tiled_from_reference(a, device)
    if kind not in _REFERENCE_CLASSES:
        raise NotImplementedError(
            f"{kind} has no PyTorch counterpart (see ROADMAP.md, queue A)")
    if kind == "SymmetricMatrix":
        rows, cols, vals = (np.array(t, copy=True)
                            for t in (a.tri_rows, a.tri_cols, a.tri_vals))
    else:
        rows, cols, vals = a.to_coo()
    kwargs = {k: getattr(a, k) for k in _REFERENCE_KWARGS.get(kind, ())}
    return from_coo(_REFERENCE_CLASSES[kind], a.nrows, a.ncols, rows, cols,
                    vals, device=device, **kwargs)


def _tiled_from_reference(a, device) -> TiledSpmv:
    """The port's ``TiledSpmv`` of a JAX one: every tile's ``to_coo()``
    shifted by its slab's and panel's first row and column, on JAX's grid,
    with the tiles' CMRS height or SELL σ."""
    parts, kwargs = [], {}
    for d, slab in enumerate(a.tiles):
        for j, c in slab:
            r, col, v = c.to_coo()
            parts.append((np.asarray(r, np.int64) + d * a.rps,
                          np.asarray(col, np.int64) + j * a.cps, np.asarray(v)))
            kwargs = {k: getattr(c, k)
                      for k in _REFERENCE_KWARGS.get(type(c).__name__, ())}
    rows, cols, vals = (np.concatenate(t) for t in zip(*parts))
    return TiledSpmv(a.format, a.nrows, a.ncols, rows, cols, vals, device=device,
                     slab_rows=a.rps, panel_cols=a.cps, **kwargs)

"""High-level API: load → convert → spmv.

Counterpart of ``spmv_tpu/api.py:23-77`` for the formats ported so far.
"""

from __future__ import annotations

import numpy as np

from spmv_tpu_torch.formats.cmrs import CMRSMatrix
from spmv_tpu_torch.formats.coo import COOMatrix
from spmv_tpu_torch.formats.csr import CSRMatrix

__all__ = ["FORMATS", "NOT_PORTED", "from_coo", "load", "spmv",
           "from_reference"]

FORMATS = {
    "coo": COOMatrix,
    "csr": CSRMatrix,
    "cmrs": CMRSMatrix,
}

# The JAX package's other formats, still to be ported (ROADMAP.md, queue A).
NOT_PORTED = ("ell", "sell", "sell_c_sigma", "hyb", "bsr", "sym")

# JAX container class → port format name, for ``from_reference``
_REFERENCE_CLASSES = {"COOMatrix": "coo", "CSRMatrix": "csr",
                      "CMRSMatrix": "cmrs"}


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
    """Convert COO triplets to the named format's container on ``device``."""
    cls = _format_class(format)
    return cls.from_coo(nrows, ncols, np.asarray(rows), np.asarray(cols),
                        np.asarray(vals), device=device, **kwargs)


def load(path: str, format: str = "csr", *, device, synth: dict | None = None,
         **kwargs):
    """Read a MatrixMarket file (or synthesize a cant-like matrix when it is
    a git-LFS pointer or missing; ``synth`` kwargs go to
    ``synth.synthetic_cant``) and convert it."""
    from spmv_tpu_torch.io.mmio import read_path_or_synthesize

    _format_class(format)  # refuse an unported format before reading
    info, rows, cols, vals = read_path_or_synthesize(path, **(synth or {}))
    return from_coo(format, info.nrows, info.ncols, rows, cols, vals,
                    device=device, **kwargs)


def spmv(a, x):
    """y = A @ x for any format container."""
    return a.matvec(x)


def from_reference(a, device):
    """The port's container holding the same matrix as the JAX package's
    container ``a``: its ``to_coo()`` triplets (fresh numpy copies, original
    order for COO) go through the port's ``from_coo``. Needs no JAX import;
    the parity tests use it."""
    kind = type(a).__name__
    if kind not in _REFERENCE_CLASSES:
        raise NotImplementedError(
            f"{kind} has no PyTorch counterpart yet (see ROADMAP.md)")
    rows, cols, vals = a.to_coo()
    kwargs = {"height": a.height} if kind == "CMRSMatrix" else {}
    return from_coo(_REFERENCE_CLASSES[kind], a.nrows, a.ncols, rows, cols,
                    vals, device=device, **kwargs)

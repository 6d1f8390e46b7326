"""MatrixMarket (``.mtx``) reading, pure NumPy.

The read half of ``spmv_tpu/io/mmio.py``, copied: that module belongs to
the JAX package, whose import pulls in JAX. It reads coordinate bodies
(real, integer, pattern, complex) and expands symmetric, skew-symmetric
and hermitian storage; ``read_banner`` also accepts dense ``array``
banners. The body parser is ``np.fromfile(sep=' ')``; the JAX package's
optional C++ parser (``spmv_tpu/io/native.py``) is not ported yet
(``ROADMAP.md``). The write path and dense reads are not ported either.

Everything returns 0-based indices (the reference decrements in each driver,
``coo.c:82-83``).
"""

from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "MMInfo",
    "MMError",
    "read_banner",
    "read_coo",
    "typecode_str",
    "is_real_mtx",
    "read_path_or_synthesize",
]


class MMError(ValueError):
    """Malformed MatrixMarket input (banner, sizes, or body)."""


_OBJECTS = ("matrix", "vector")
_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "complex", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclass(frozen=True)
class MMInfo:
    """Parsed banner + size line — the analog of the reference's
    ``MM_typecode`` 4-char code (``mmio.h:31-73``) plus
    ``mm_read_mtx_crd_size`` output (``mmio.c:189-217``)."""

    object: str
    format: str
    field: str
    symmetry: str
    nrows: int
    ncols: int
    nnz: int  # stored entries (file count, pre symmetry expansion)

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry != "general"


def typecode_str(info: "MMInfo | tuple[str, str, str, str]") -> str:
    """Human-readable typecode, e.g. ``"matrix coordinate real general"``
    (the analog of ``mm_typecode_to_str``, ``mmio.c:455-510``)."""
    if isinstance(info, MMInfo):
        parts = (info.object, info.format, info.field, info.symmetry)
    else:
        parts = tuple(info)
    return " ".join(parts)


def _parse_banner_line(line: str) -> tuple[str, str, str, str]:
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise MMError(f"not a MatrixMarket file (banner: {line!r})")
    obj, fmt, field, sym = (p.lower() for p in parts[1:5])
    if obj not in _OBJECTS:
        raise MMError(f"unsupported object {obj!r}")
    if fmt not in _FORMATS:
        raise MMError(f"unsupported format {fmt!r}")
    if field not in _FIELDS:
        raise MMError(f"unsupported field {field!r}")
    if sym not in _SYMMETRIES:
        raise MMError(f"unsupported symmetry {sym!r}")
    return obj, fmt, field, sym


def _open(path_or_file):
    if hasattr(path_or_file, "read"):
        return path_or_file, False
    if str(path_or_file).endswith(".gz"):
        import gzip

        return gzip.open(path_or_file, "rb"), True
    return open(path_or_file, "rb"), True


def read_banner(path_or_file) -> MMInfo:
    """Read banner + size line (``mm_read_banner`` +
    ``mm_read_mtx_crd_size``, ``mmio.c:96-179, 189-217``)."""
    f, should_close = _open(path_or_file)
    try:
        return _read_banner_open(f)
    finally:
        if should_close:
            f.close()


def _read_banner_open(f) -> MMInfo:
    banner = f.readline()
    if isinstance(banner, bytes):
        banner = banner.decode("ascii", errors="replace")
    obj, fmt, field, sym = _parse_banner_line(banner)

    # Skip comment/blank lines to the size line (mmio.c:129-141 analog).
    while True:
        line = f.readline()
        if isinstance(line, bytes):
            line = line.decode("ascii", errors="replace")
        if not line:
            raise MMError("EOF before size line")
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        break

    sizes = s.split()
    if fmt == "coordinate":
        if len(sizes) != 3:
            raise MMError(f"bad coordinate size line: {s!r}")
        nrows, ncols, nnz = (int(x) for x in sizes)
    else:
        if len(sizes) != 2:
            raise MMError(f"bad array size line: {s!r}")
        nrows, ncols = (int(x) for x in sizes)
        nnz = nrows * ncols
    if nrows < 0 or ncols < 0 or nnz < 0:
        raise MMError(f"negative size: {s!r}")
    return MMInfo(obj, fmt, field, sym, nrows, ncols, nnz)


def _parse_body_tokens(f, count: int) -> np.ndarray:
    """Parse ``count`` whitespace-separated numeric tokens at C speed."""
    if isinstance(f, (_io.BufferedReader, _io.FileIO)) and f.seekable():
        toks = np.fromfile(f, dtype=np.float64, count=count, sep=" ")
    else:
        data = f.read()
        if isinstance(data, bytes):
            data = data.decode("ascii")
        toks = np.array(data.split()[:count], dtype=np.float64)
    if toks.size != count:
        raise MMError(f"truncated body: expected {count} tokens, got {toks.size}")
    return toks


def read_coo(
    path_or_file,
    *,
    expand_symmetry: bool = True,
    dtype=np.float64,
    index_dtype=np.int32,
) -> tuple[MMInfo, np.ndarray, np.ndarray, np.ndarray]:
    """Read a sparse matrix as COO triplets ``(info, rows, cols, vals)``.

    Indices are 0-based; ``pattern`` entries get value 1.0; complex values
    keep their real part unless ``dtype`` is complex. With
    ``expand_symmetry`` (default) symmetric, skew-symmetric and hermitian
    storage is expanded to general form.
    """
    f, should_close = _open(path_or_file)
    try:
        info = _read_banner_open(f)
        if info.format != "coordinate":
            raise MMError("read_coo requires coordinate format, file is "
                          f"[{typecode_str(info)}]")

        tokens_per_entry = {"real": 3, "integer": 3, "pattern": 2, "complex": 4}[
            info.field
        ]
        toks = _parse_body_tokens(f, info.nnz * tokens_per_entry)
        body = toks.reshape(info.nnz, tokens_per_entry)
        rows = body[:, 0].astype(np.int64) - 1
        cols = body[:, 1].astype(np.int64) - 1
        if info.field == "pattern":
            vals = np.ones(info.nnz, dtype=np.float64)
        elif info.field == "complex":
            vals = body[:, 2] + 1j * body[:, 3]
            if not np.issubdtype(np.dtype(dtype), np.complexfloating):
                vals = vals.real
        else:
            vals = body[:, 2]

        if (
            (rows < 0).any()
            or (cols < 0).any()
            or (rows >= info.nrows).any()
            or (cols >= info.ncols).any()
        ):
            raise MMError("index out of declared bounds")

        if expand_symmetry and info.is_symmetric:
            off = rows != cols
            if info.symmetry == "skew-symmetric":
                mirror_vals = -vals[off]
            elif info.symmetry == "hermitian":
                mirror_vals = np.conj(vals[off])
            else:
                mirror_vals = vals[off]
            rows = np.concatenate([rows, cols[off]])
            cols = np.concatenate([cols, rows[: info.nnz][off]])
            vals = np.concatenate([vals, mirror_vals])

        return (
            info,
            rows.astype(index_dtype),
            cols.astype(index_dtype),
            np.asarray(vals, dtype=dtype),
        )
    finally:
        if should_close:
            f.close()


def is_real_mtx(path: str) -> bool:
    """True when ``path`` exists and is an actual MatrixMarket file rather
    than a git-LFS pointer (the bundled cant.mtx, ``databases/cant.mtx:1-3``
    in the reference, is a pointer)."""
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        head = f.read(64)
    return not head.startswith(b"version https://git-lfs")


def read_path_or_synthesize(path: str, expand_symmetry: bool = True,
                            **synth_kwargs):
    """Load ``path`` if it is a real .mtx; if it is a git-LFS pointer or
    missing, synthesize a cant-like matrix (``synth.synthetic_cant`` with
    ``synth_kwargs``) instead."""
    from spmv_tpu_torch import synth

    if is_real_mtx(path):
        return read_coo(path, expand_symmetry=expand_symmetry)
    return synth.synthetic_cant(**synth_kwargs)

"""ctypes binding to the C++ MatrixMarket body parser
(``io/csrc/mm_parse.cpp``), built on first use, with the NumPy parser of
``io.mmio`` as the fallback.

Counterpart of ``spmv_tpu/io/native.py``, with the same contract:
``available()``, ``parse_body()`` and ``ensure_built()``. The source is the
port's own copy of ``native/mm_parse.cpp`` (the same C ABI,
``mm_native_abi_version() == 1``); nothing here reads or writes
``native/``. The host C++ compiler (``$CXX``, else ``c++`` or ``g++``)
builds it with ``-O3 -shared -fPIC`` into the gitignored
``spmv_tpu_torch/_build/``, under a name that carries a hash of the source
and the flags. The library is written to a temporary name and moved into
place with ``os.replace``, so processes that build it at the same time
(test workers) never load half a file.

Set ``SPMV_TPU_NO_NATIVE=1`` to force the fallback, as in JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from spmv_tpu_torch.kernels._build import BUILD_DIR, BuildError

__all__ = ["available", "parse_body", "ensure_built", "library_path", "SOURCE",
           "CXX_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "mm_parse.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags lies once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmparse-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    for c in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if c:
            return c
    raise BuildError("no C++ compiler found (set CXX, or put c++ or g++ on PATH)")


def ensure_built(*, check: bool = False) -> bool:
    """Build the shared library if missing; returns availability. With
    ``check`` a failed build raises ``BuildError`` with the compiler's
    output instead of returning False."""
    so = library_path()
    if so.exists():
        return True
    try:
        cxx = _compiler()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"{cxx} failed ({proc.returncode}):\n"
                             f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    except BuildError:
        if check:
            raise
        return False
    except (OSError, subprocess.TimeoutExpired) as e:
        if check:
            raise BuildError(f"cannot build {SOURCE.name}: {e}") from e
        return False
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("SPMV_TPU_NO_NATIVE"):
        return None
    if not ensure_built():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
        lib.mm_parse_body.restype = ctypes.c_int64
        lib.mm_parse_body.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.mm_native_abi_version.restype = ctypes.c_int
        lib.mm_native_abi_version.argtypes = []
        if lib.mm_native_abi_version() != 1:
            return None
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_body(buf: bytes, count: int, tokens_per_entry: int):
    """Parse ``count`` coordinate entries from a body buffer.

    Returns (rows_i32_1based, cols_i32_1based, vals_f64_or_None).
    Raises ValueError on truncation; returns None if native unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    rows = np.empty(count, dtype=np.int32)
    cols = np.empty(count, dtype=np.int32)
    if tokens_per_entry == 2:
        vals = None
        vptr = None
    elif tokens_per_entry == 3:
        vals = np.empty(count, dtype=np.float64)
        vptr = vals.ctypes.data_as(ctypes.c_void_p)
    else:
        vals = np.empty(2 * count, dtype=np.float64)
        vptr = vals.ctypes.data_as(ctypes.c_void_p)
    got = lib.mm_parse_body(
        buf, len(buf), count, tokens_per_entry,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vptr, 0,
    )
    if got != count:
        raise ValueError(f"truncated body: expected {count} entries, got {got}")
    return rows, cols, vals

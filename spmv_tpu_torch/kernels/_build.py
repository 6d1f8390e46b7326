"""Builds the port's CUDA kernels on first use and binds them with ctypes.

``nvcc`` compiles ``csrc/*.cu`` for ``sm_90a`` into one shared library
under ``spmv_tpu_torch/_build/`` (listed in ``.gitignore``). The library
exposes plain C launchers, so the build needs no PyTorch headers and takes
seconds. Its file name carries a hash of the sources and flags: an edited
source builds anew, an unchanged one is loaded as it is. A failed build
raises ``BuildError``; nothing falls back to the plain PyTorch versions.

Every pointer and the stream cross ctypes as ``c_void_p``. Without the
declared ``argtypes`` ctypes would pass a Python int as a 32-bit C int and
cut a 64-bit device pointer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuildError", "Built", "library", "build", "nvcc_path",
           "NVCC_FLAGS", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher name → argument types, in the order of csrc/seg_spmv.cu
SIGNATURES = {
    # ptr, cols, vals, tile_row0, x, y, carry, nnz, ntiles, tile, stream
    "seg_spmv_tiles": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ptr, carry_rows, carry, y, ncarry, tile, stream
    "carry_fixup": (_P, _P, _P, _P, _I, _I, _P),
    # ptr, cols, vals, x, y, nrows, vec, stream
    "csr_spmv_fused": (_P, _P, _P, _P, _P, _I, _I, _P),
}


class BuildError(RuntimeError):
    """nvcc is missing, or it refused the sources."""


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc run; 0.0 when an earlier build was loaded
    log: str  # nvcc's output, with the -Xptxas -v register and spill lines


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels cannot be built")


def _declare(lib) -> None:
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int


def build(sources, out_dir: Path, nvcc: str | None = None) -> Built:
    """Compile ``sources`` into ``out_dir`` (or load the earlier build of
    the same sources and flags) and declare the launchers' signatures."""
    sources = sorted(Path(s) for s in sources)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = Path(out_dir) / f"libspmv_kernels-{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        nvcc = nvcc or nvcc_path()
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                   *map(str, sources)],
                                  capture_output=True, text=True, check=False)
        except OSError as e:
            raise BuildError(f"cannot run {nvcc}: {e}") from e
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                             f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    log = log_path.read_text() if log_path.exists() else ""
    return Built(lib=lib, path=so, seconds=seconds, log=log)


@functools.cache
def library() -> Built:
    """The kernels' library, built from ``csrc/`` on the first call."""
    return build(CSRC.glob("*.cu"), BUILD_DIR)

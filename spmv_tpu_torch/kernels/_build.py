"""Builds the port's CUDA kernels on first use and binds them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` into a shared library
of its own under ``spmv_tpu_torch/_build/`` (listed in ``.gitignore``), one
``nvcc`` per source, all started together. The libraries expose plain C
launchers, so the build needs no PyTorch headers and takes seconds. Each
file name carries a hash of its source, the ``csrc/*.cuh`` headers beside
it and the flags: an edited source or header builds anew, an unchanged one
is loaded as it is. A failed build raises
``BuildError``; nothing falls back to the plain PyTorch versions.

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
from types import SimpleNamespace

__all__ = ["BuildError", "Built", "library", "build", "nvcc_path",
           "NVCC_FLAGS", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# launcher name → argument types, in the order of its csrc/*.cu parameters
SIGNATURES = {
    # seg_spmv.cu
    # ptr, cols, vals, tile_row0, x, y, carry, nnz, ntiles, tile, stream
    "seg_spmv_tiles": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ptr, carry_rows, carry, y, ncarry, tile, stream
    "carry_fixup": (_P, _P, _P, _P, _I, _I, _P),
    # ptr, cols, vals, tile_row0, x, y, pub (a word per tile), nnz, ntiles,
    # nrows, tile, vec (0: the tiles; 4-32: lanes per row), stream
    "csr_spmv_fused": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # device: K3's grid cap there (resident blocks per SM times the SMs)
    "csr_spmv_fused_resident": (_I,),
    # ptr, cols, vals, tile_row0, X, Y, carry, nnz, ntiles, tile, rhs, stream
    "seg_spmm_tiles": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # ptr, carry_rows, carry, Y, ncarry, tile, rhs, stream
    "carry_fixup_multi": (_P, _P, _P, _P, _I, _I, _I, _P),
    # K1 and K2 in float64: the arguments of seg_spmv_tiles and carry_fixup
    "seg_spmv_tiles_x2": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "carry_fixup_x2": (_P, _P, _P, _P, _I, _I, _P),
    # fp64 (0 or 1), rhs: K1's, K12's or K8's resident blocks per SM
    "seg_tiles_occupancy": (_I, _I),
    # panel_spmv.cu
    # slice_ptr, cols, vals, tile_slice0, tile_own0, x, y, part, ncolumns,
    # ntiles, tile, nrows, stream
    "panel_spmv_tiles": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # slice_ptr, cols, vals, tile_slice0, tile_own0, x, y, words (2·ntiles·32
    # int64), nslices, ncolumns, ntiles, tile, nrows, mode (0: a warp per
    # slice; 1: K4's tiles), stream
    "panel_spmv_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # device: K6's grid cap there in its tile mode (resident blocks per SM
    # times the SMs)
    "panel_spmv_fused_resident": (_I,),
    # invperm, slice_ptr, split_slices, part, y_sorted, spill, y, nrows,
    # nsplit, tile, rhs, stream (invperm, slice_ptr, split_slices, part and
    # spill may be null; without invperm y is y_sorted, updated in place)
    "inverse_permute": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # slice_ptr, cols, vals, tile_slice0, tile_own0, X, Y, part, ncolumns,
    # ntiles, tile, nrows, rhs, stream
    "panel_spmm_tiles": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # K4 in float64: the arguments of panel_spmv_tiles
    "panel_spmv_tiles_x2": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # K7 in float64: the arguments of inverse_permute but rhs (1)
    "inverse_permute_x2": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # fp64 (0 or 1), rhs: K4's, K14's or K10's resident blocks per SM
    "panel_tiles_occupancy": (_I, _I),
    # probe_spmv.cu
    # K1 and K12 with uint16 columns, and K1 at another tile: the arguments
    # of seg_spmv_tiles; K2 at another tile: those of carry_fixup
    "seg_spmv_tiles_u16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "seg_spmv_tiles_u16_x2": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "seg_spmv_tiles_at": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "carry_fixup_at": (_P, _P, _P, _P, _I, _I, _P),
    # ptr, cols, vals, tile_row0, x, y, carry, out, nnz, ntiles, mode, stream
    "seg_ablate": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "seg_ablate_x2": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # K1 + K2 in one launch: ptr, cols, vals, tile_row0, x, y, carry,
    # carry_rows, arrived, nnz, ntiles, ncarry, tile, stream
    "seg_spmv_tiles_fold": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # stream: one launch of a kernel that does nothing
    "launch_floor": (_P,),
    # K4 and K14 with x̃(c) synthesized: the arguments of panel_spmv_tiles
    # (x may be null)
    "panel_ablate_nogather": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "panel_ablate_x2_nogather": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


class BuildError(RuntimeError):
    """nvcc (or, for the MatrixMarket parser of ``io.native``, the host C++
    compiler) is missing, or it refused the sources."""


@dataclass(frozen=True)
class Built:
    lib: SimpleNamespace  # every declared launcher found, by name
    paths: tuple  # the shared libraries, one per source
    seconds: float  # wall time of the nvcc runs; 0.0 when all were loaded
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


def _so_path(source: Path, out_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.name.encode())
    h.update(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):  # what a source may include
        h.update(header.read_bytes())
    return Path(out_dir) / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources, out_dir: Path, nvcc: str | None = None) -> Built:
    """Compile each of ``sources`` into ``out_dir``, all at once (or load
    the earlier build of the same source and flags), and declare the
    launchers' signatures."""
    sources = sorted(Path(s) for s in sources)
    targets = [(s, _so_path(s, out_dir)) for s in sources]
    todo = [(s, so) for s, so in targets if not so.exists()]
    seconds = 0.0
    if todo:
        nvcc = nvcc or nvcc_path()
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        try:
            for s, so in todo:
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                procs.append((so, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        except OSError as e:
            for _, _, p in procs:
                p.kill()
                p.wait()
            raise BuildError(f"cannot run {nvcc}: {e}") from e
        failed = []
        for so, tmp, p in procs:
            out = p.communicate()[0]
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{so.name}: nvcc failed ({p.returncode}):\n{out}")
                continue
            so.with_suffix(".log").write_text(out)
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        seconds = time.perf_counter() - t0
        if failed:
            raise BuildError("\n".join(failed))
    fns, log = {}, []
    for _, so in targets:
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                fns[name] = fn
        log_path = so.with_suffix(".log")
        if log_path.exists():
            log.append(log_path.read_text())
    return Built(lib=SimpleNamespace(**fns), paths=tuple(so for _, so in targets),
                 seconds=seconds, log="".join(log))


@functools.cache
def library() -> Built:
    """The kernels' libraries, built from ``csrc/`` on the first call."""
    return build(CSRC.glob("*.cu"), BUILD_DIR)

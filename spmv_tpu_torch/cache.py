"""Caches of parsed triplets and built plans, both as ``.npz``.

Counterpart of ``spmv_tpu/cache.py``, with its two levels:

* **triplets** keyed by a fingerprint of the file's content (skips the
  parse);
* **plans** keyed by a content hash of the inputs of a plan build (skips
  the conversion), used by ``formats.base.build_csr_plan`` and
  ``build_panel_plan`` while a cache directory is set (``plan_cache``),
  the spill parts and the sym container's two plans included.

The port's plans are not the JAX package's: every key carries this
module's namespace (``NAMESPACE``), and a plan's key the values' dtype
and the tile, so neither package reads the other's files and a float64
plan never answers a float32 build.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os

import numpy as np

__all__ = ["NAMESPACE", "cache_key", "save_plan", "load_plan", "plan_cache",
           "plan_lookup", "plan_store", "load_triplets"]

# bump the version when a plan's layout changes
NAMESPACE = "torch-v2"

_PLAN_CACHE_DIR: str | None = None


def _set_plan_cache(cache_dir: str | None) -> None:
    """Turn plan caching on (a directory) or off (None)."""
    global _PLAN_CACHE_DIR
    _PLAN_CACHE_DIR = cache_dir or None


@contextlib.contextmanager
def plan_cache(cache_dir: str | None):
    """Plan caching in ``cache_dir`` (None: off) for the ``with`` body,
    then the setting that was there before."""
    prev = _PLAN_CACHE_DIR
    _set_plan_cache(cache_dir)
    try:
        yield
    finally:
        _set_plan_cache(prev)


def _plan_key(kind: str, arrays, nrows: int, ncols: int, params: dict) -> str:
    h = hashlib.sha256()
    p = json.dumps(params, sort_keys=True)
    h.update(f"{NAMESPACE}|{kind}|{nrows}|{ncols}|{p}".encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return f"plan-{kind}-{h.hexdigest()[:24]}"


def plan_lookup(kind: str, arrays, nrows: int, ncols: int, params: dict,
                plan_cls):
    """The cached plan built from these inputs, or None (caching off, or
    a miss). ``params`` holds the build's other arguments (the tile and
    the values' dtype)."""
    if _PLAN_CACHE_DIR is None:
        return None
    hit = load_plan(_PLAN_CACHE_DIR, _plan_key(kind, arrays, nrows, ncols, params))
    if hit is None:
        return None
    meta, arrays = hit
    return plan_cls(**arrays, **meta)


def plan_store(kind: str, arrays, nrows: int, ncols: int, params: dict,
               plan) -> None:
    """Save ``plan`` under the key of its inputs (no-op with caching off)."""
    if _PLAN_CACHE_DIR is None:
        return
    meta, out = {}, {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        (out if isinstance(v, np.ndarray) else meta)[f.name] = v
    save_plan(_PLAN_CACHE_DIR, _plan_key(kind, arrays, nrows, ncols, params),
              meta, out)


def _fingerprint(path: str) -> str:
    """sha256 of the size and the first and last 64 KB: fast on a 60 MB
    file and strong enough for a local cache."""
    h = hashlib.sha256()
    size = os.path.getsize(path)
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(65536))
        if size > 131072:
            f.seek(-65536, 2)
            h.update(f.read(65536))
    return h.hexdigest()[:24]


def cache_key(path: str, format: str, params: dict) -> str:
    p = json.dumps(params, sort_keys=True, default=str)
    h = hashlib.sha256(f"{NAMESPACE}|{format}|{p}".encode()).hexdigest()[:12]
    return f"{_fingerprint(path)}-{format}-{h}"


def save_plan(cache_dir: str, key: str, meta: dict, arrays: dict) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, key + ".npz")
    tmp = out + ".tmp.npz"
    np.savez_compressed(tmp, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, out)
    return out


def load_plan(cache_dir: str, key: str):
    """``(meta, arrays)`` saved under ``key``, or None."""
    path = os.path.join(cache_dir, key + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def load_triplets(path: str, cache_dir: str | None = None,
                  expand_symmetry: bool = True, **synth_kwargs):
    """``read_path_or_synthesize(path, …)``, with the triplets cached in
    ``cache_dir`` under the file's fingerprint where the file exists (a
    git-LFS pointer too: its synthesized matrix is cached under the
    synthesis arguments)."""
    from spmv_tpu_torch.io import mmio

    if not cache_dir or not os.path.exists(path):
        return mmio.read_path_or_synthesize(path, expand_symmetry, **synth_kwargs)
    key = cache_key(path, "coo-triplets",
                    {"expand_symmetry": expand_symmetry, **synth_kwargs})
    hit = load_plan(cache_dir, key)
    if hit is not None:
        meta, arrays = hit
        info = mmio.MMInfo(**meta)
        return info, arrays["rows"], arrays["cols"], arrays["vals"]
    info, rows, cols, vals = mmio.read_path_or_synthesize(path, expand_symmetry,
                                                          **synth_kwargs)
    save_plan(cache_dir, key, dataclasses.asdict(info),
              {"rows": rows, "cols": cols, "vals": vals})
    return info, rows, cols, vals


"""Deterministic synthetic sparse matrices.

The reference benchmarks against SuiteSparse Boeing/cant
(its ``databases/cant.mtx``), which ships only as a git-LFS
pointer.  These generators produce structurally similar matrices (FEM-style
banded, ~64 nnz/row) plus adversarial edge-case matrices covering exactly
the patterns where the reference harbors latent bugs (empty rows, trailing
longest row, rows % C != 0 — SURVEY.md §2.2).

All generators return ``(info, rows, cols, vals)`` in the same shape as
``spmv_tpu_torch.io.mmio.read_coo`` so they are drop-in file substitutes.

A copy of ``spmv_tpu/synth.py``, kept so that both packages build the same
triplets bit for bit from the same seed (``tests/test_torch_host.py`` and
``tests/test_torch_big.py`` check it); the port cannot import the original
without importing JAX. ``synthetic_cant`` reaches the same arrays by
another route, without a sort (its docstring says how).
"""

from __future__ import annotations

import numpy as np

from spmv_tpu_torch.io.mmio import MMInfo

__all__ = ["synthetic_cant", "random_coo", "power_law", "EDGE_CASES", "edge_case"]

# source vertices per pass of ``synthetic_cant`` (its peak working memory)
_CHUNK_VERTICES = 1 << 20


def _as_result(nrows, ncols, rows, cols, vals, index_dtype=np.int32, dtype=np.float64):
    order = np.lexsort((cols, rows))
    rows = np.ascontiguousarray(rows[order], dtype=index_dtype)
    cols = np.ascontiguousarray(cols[order], dtype=index_dtype)
    vals = np.ascontiguousarray(vals[order], dtype=dtype)
    info = MMInfo("matrix", "coordinate", "real", "general", nrows, ncols, rows.size)
    return info, rows, cols, vals


def _cant_grid(n: int, avg_nnz_per_row: int, bandwidth: int):
    """``synthetic_cant``'s mesh: ``(nx, ny, nz, offs)``, the (nx, ny, nz)
    vertex grid and the stencil offsets in the greedy (distance) order in
    which the JAX generator makes its triplets."""
    n = int(n)
    nodes = max(-(-n // 3), 1)
    a = max(int(round((max(bandwidth, 3) / 3.0) ** 0.5)), 1)
    ny = nz = min(a, nodes)
    nx = max(-(-nodes // (ny * nz)), 1)

    # Candidate stencil offsets sorted by distance (then lexicographic for
    # determinism); radius grows until the box can hold avg/3 neighbors.
    r = 1
    while (2 * r + 1) ** 3 * 3 < 2 * avg_nnz_per_row and r < 8:
        r += 1
    d = np.arange(-r, r + 1)
    dx, dy, dz = np.meshgrid(d, d, d, indexing="ij")
    offs = np.stack([dx.ravel(), dy.ravel(), dz.ravel()], axis=1)
    order = np.lexsort((offs[:, 2], offs[:, 1], offs[:, 0],
                        (offs ** 2).sum(axis=1)))
    offs = offs[order]
    # Greedy: include nearest offsets until expected nnz reaches target
    # (each valid vertex pair contributes a 3x3 dof block).
    valid_count = ((np.maximum(nx - np.abs(offs[:, 0]), 0))
                   * np.maximum(ny - np.abs(offs[:, 1]), 0)
                   * np.maximum(nz - np.abs(offs[:, 2]), 0))
    target_pairs = n * avg_nnz_per_row / 9.0
    csum = np.cumsum(valid_count)
    k = int(np.searchsorted(csum, target_pairs)) + 1
    k = min(max(k, 1), offs.shape[0])
    offs = offs[:k]

    return nx, ny, nz, offs


def synthetic_cant(
    n: int = 62_451,
    avg_nnz_per_row: int = 64,
    bandwidth: int = 350,
    seed: int = 0,
    *,
    sorted_by_row_length: bool = False,
    index_dtype=np.int32,
    dtype=np.float64,
):
    """A cant-like FEM matrix: 3-dof nodes on an (nx, a, a) beam grid with
    a box-stencil adjacency — the structure of the real Boeing/cant (a 3D
    FEM cantilever: 62,451 dofs = 20,817 vertices × 3, ~4.0M nnz ≈
    64.17/row, row lengths spread ~19–78 by boundary truncation).

    Round 4 replaced the old uniform-random-in-band fill: real FEM columns
    come in 3-wide vertex blocks at deterministic mesh-stencil offsets, so
    per-(row, 128-col stripe) counts are set by geometry, not by a Poisson
    max-statistic — the property that makes the matrix ELL/SELL-friendly
    (the reference benchmarks exactly this class, ``ell.c:43``,
    ``sigma_c.c:44``).  ``tests/test_synth.py`` validates the row-length
    histogram against cant's published shape.

    * ``bandwidth`` sets the beam cross-section (a ≈ sqrt(bandwidth/3)
      vertices per side), so column offsets stay within ±~``bandwidth``;
    * ``avg_nnz_per_row`` sets how many nearest stencil offsets each
      vertex couples to (greedy by distance until the expected nnz
      matches ``n · avg_nnz_per_row``);
    * ``seed`` affects only the values (the structure is deterministic,
      like a real mesh);
    * ``sorted_by_row_length=True`` mimics ``cant-sorted.mtx`` (rows
      reordered by descending length — the offline σ-sort the reference
      relies on, SURVEY.md §2.2 SELL-C-σ).

    The JAX generator makes the vertex pairs offset by offset, expands
    them to 3 × 3 dof blocks in int64 and sorts the triplets by (row,
    col); this one gives the same arrays bit for bit without those
    temporaries or the sort, so it also serves matrices of billions of
    nonzeros (16 B each as int32/int32/float64). Each nonzero's place is
    known before it is made: a row is one of the 3 dofs of a mesh vertex,
    its columns come vertex block by vertex block in the order of their
    stencil offset's vertex shift, and the values are drawn in the JAX
    generator's order (offset by offset, vertex by vertex, 3 × 3 per
    pair), ``_CHUNK_VERTICES`` source vertices at a time. Besides the
    result it holds one uint16 per (vertex, offset). Only
    ``sorted_by_row_length`` sorts.
    """
    rng = np.random.default_rng(seed)
    n = int(n)
    nx, ny, nz, offs = _cant_grid(n, avg_nnz_per_row, bandwidth)
    nodes = max(-(-n // 3), 1)  # vertices with a row; the rest of the grid has none
    shift = offs[:, 0] * (ny * nz) + offs[:, 1] * nz + offs[:, 2]
    by_shift = np.argsort(shift, kind="stable")
    chunk = _CHUNK_VERTICES

    def coords(v0, v1):
        v = np.arange(v0, v1, dtype=np.int64)
        return v, v // (ny * nz), (v // nz) % ny, v % nz

    def valid(k, vx, vy, vz):
        ox, oy, oz = offs[k]
        return ((vx + ox >= 0) & (vx + ox < nx) & (vy + oy >= 0) & (vy + oy < ny)
                & (vz + oz >= 0) & (vz + oz < nz))

    # pass 1: each vertex's row length and, per offset, the entries its
    # lower-shift neighbours put before that offset's block in the row
    rank = np.zeros((nodes, offs.shape[0]), dtype=np.uint16)
    length = np.zeros(nodes, dtype=np.int64)
    for v0 in range(0, nodes, chunk):
        v, vx, vy, vz = coords(v0, min(v0 + chunk, nodes))
        run = np.zeros(v.size, dtype=np.int64)
        for k in by_shift:
            rank[v0:v0 + v.size, k] = run
            run += valid(k, vx, vy, vz) * np.clip(n - 3 * (v + shift[k]), 0, 3)
        length[v0:v0 + v.size] = run
    nrows_of = np.clip(n - 3 * np.arange(nodes, dtype=np.int64), 0, 3)
    vstart = np.zeros(nodes + 1, dtype=np.int64)
    np.cumsum(nrows_of * length, out=vstart[1:])
    nnz = int(vstart[-1])
    rows = np.empty(nnz, dtype=index_dtype)
    cols = np.empty(nnz, dtype=index_dtype)
    vals = np.empty(nnz, dtype=dtype)

    # pass 2: the JAX generator's order, each entry to its place
    ab = np.arange(3, dtype=np.int64)
    for k in range(offs.shape[0]):
        for v0 in range(0, nodes, chunk):
            v, vx, vy, vz = coords(v0, min(v0 + chunk, nodes))
            src = v[valid(k, vx, vy, vz)]
            if not src.size:
                continue
            dst = src + shift[k]
            r = 3 * src[:, None, None] + ab[None, :, None]
            c = np.broadcast_to(3 * dst[:, None, None] + ab[None, None, :], r.shape[:2] + (3,))
            r = np.broadcast_to(r, c.shape)
            pos = (vstart[src][:, None, None] + ab[None, :, None] * length[src][:, None, None]
                   + rank[src, k].astype(np.int64)[:, None, None] + ab[None, None, :])
            if 3 * (src[-1] + 1) <= n and 3 * (dst.max() + 1) <= n:  # every entry kept
                pos, r, c = pos.reshape(-1), r.reshape(-1), c.reshape(-1)
            else:
                keep = (r < n) & (c < n)
                pos, r, c = pos[keep], r[keep], c[keep]
            rows[pos] = r
            cols[pos] = c
            vals[pos] = rng.standard_normal(pos.size)

    if sorted_by_row_length:
        lengths = np.repeat(length, nrows_of)
        perm = np.argsort(-lengths, kind="stable")  # new order of old rows
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n, dtype=np.int64)
        return _as_result(n, n, inv[rows], cols, vals, index_dtype, dtype)
    return MMInfo("matrix", "coordinate", "real", "general", n, n, nnz), rows, cols, vals


def power_law(
    n: int = 32_768,
    avg_nnz_per_row: int = 16,
    alpha: float = 1.8,
    max_row: int | None = None,
    bandwidth: int | None = None,
    seed: int = 0,
    *,
    index_dtype=np.int32,
    dtype=np.float64,
):
    """A scale-free matrix: Zipf-distributed row lengths (a few hub rows
    hundreds long, a long tail of 1-2 nnz rows) — the row-length profile of
    web/social-graph adjacency and locally-refined meshes, and the matrix
    class where SELL-C-σ's row sort pays: natural order mixes hubs with
    tail rows in every 128-row block so ELL's per-block max padding
    explodes, while the σ-sort groups like-length rows.

    ``bandwidth`` clusters columns within ±bandwidth of the diagonal
    (locality-ordered graphs / adaptive meshes); ``None`` = uniform random
    columns (worst case for any padded layout)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(alpha, size=n).astype(np.int64)
    cap = max_row if max_row is not None else max(n // 16, 8)
    lengths = np.minimum(raw, cap)
    # rescale to the requested density
    lengths = np.maximum(1, (lengths * (avg_nnz_per_row / max(lengths.mean(), 1e-9))
                             ).astype(np.int64))
    lengths = np.minimum(lengths, n if bandwidth is None else 2 * bandwidth)
    rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
    if bandwidth is None:
        cols = rng.integers(0, n, size=rows.size)
    else:
        offs = rng.integers(-bandwidth, bandwidth + 1, size=rows.size)
        cols = np.clip(rows + offs, 0, n - 1)
    key = rows * np.int64(n) + cols
    _, keep = np.unique(key, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size)
    return _as_result(n, n, rows, cols, vals, index_dtype, dtype)


def random_coo(
    nrows: int,
    ncols: int,
    nnz: int,
    seed: int = 0,
    *,
    allow_duplicates: bool = False,
    index_dtype=np.int32,
    dtype=np.float64,
):
    """Uniform random COO; with ``allow_duplicates`` the triplets may repeat
    (duplicates sum, as in raw MatrixMarket semantics)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nrows, size=nnz)
    cols = rng.integers(0, ncols, size=nnz)
    if not allow_duplicates:
        key = rows * np.int64(ncols) + cols
        _, keep = np.unique(key, return_index=True)
        rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.size)
    return _as_result(nrows, ncols, rows, cols, vals, index_dtype, dtype)


def _empty_rows(seed=0):
    # Rows 0, 3, 7 empty; row 9 (last) is the longest — both reference bugs.
    rows = np.array([1, 1, 1, 2, 4, 5, 5, 6, 8, 9, 9, 9, 9, 9])
    cols = np.array([0, 4, 9, 2, 4, 1, 8, 6, 3, 0, 2, 5, 7, 9])
    vals = np.linspace(1.0, 2.3, rows.size)
    return _as_result(10, 10, rows, cols, vals)


def _single_row(seed=0):
    cols = np.arange(7)
    return _as_result(1, 7, np.zeros(7, np.int64), cols, np.arange(1.0, 8.0))


def _single_col(seed=0):
    rows = np.arange(7)
    return _as_result(7, 1, rows, np.zeros(7, np.int64), np.arange(1.0, 8.0))


def _ragged(seed=0):
    # Wildly varying row lengths; nrows=13 (prime, not divisible by C=8 or
    # height=8 — the reference CMRS OOB case, SURVEY.md §2.2 CMRS).
    rng = np.random.default_rng(seed)
    lengths = np.array([1, 40, 2, 0, 0, 13, 1, 1, 40, 5, 0, 2, 39])
    n = 13
    rows = np.repeat(np.arange(n), lengths)
    cols = np.concatenate([rng.choice(41, size=l, replace=False) for l in lengths if l]) if lengths.sum() else np.array([], np.int64)
    vals = rng.standard_normal(rows.size)
    return _as_result(13, 41, rows, cols, vals)


def _all_empty(seed=0):
    z = np.array([], dtype=np.int64)
    return _as_result(5, 5, z, z, z.astype(np.float64))


def _dense_small(seed=0):
    n = 9
    rows, cols = np.divmod(np.arange(n * n), n)
    rng = np.random.default_rng(seed)
    return _as_result(n, n, rows, cols, rng.standard_normal(n * n))


def _one_element(seed=0):
    return _as_result(
        3, 4, np.array([2]), np.array([3]), np.array([5.5])
    )


def _rectangular(seed=0):
    rng = np.random.default_rng(seed)
    return random_coo(17, 33, 120, seed=seed + 1)


EDGE_CASES = {
    "empty_rows": _empty_rows,
    "single_row": _single_row,
    "single_col": _single_col,
    "ragged": _ragged,
    "all_empty": _all_empty,
    "dense_small": _dense_small,
    "one_element": _one_element,
    "rectangular": _rectangular,
}


def edge_case(name: str, seed: int = 0):
    return EDGE_CASES[name](seed)

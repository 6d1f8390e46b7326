"""A small Kronecker graph and HPCG's stencil for the column relabel's tests
(``test_torch_relabel.py`` on the CPU, ``test_torch_gpu.py`` on the card):
numpy only, so the card's tests can import it."""

import numpy as np


def kronecker(scale: int, edgefactor: int, seed: int = 0):
    """``(n, rows, cols, vals)``: the Graph500 generator's graph (A, B, C =
    0.57, 0.19, 0.19, vertex labels permuted) at 2^scale vertices, as its
    symmetric adjacency, each (row, col) once in (row, col) order, float32
    weights in (0, 1]. Hub columns are few and spread over all labels."""
    rng = np.random.default_rng(seed)
    n, m = 1 << scale, edgefactor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for level in range(scale):
        src_bit = rng.random(m) > 0.76
        dst_bit = rng.random(m) > np.where(src_bit, 0.19 / 0.24, 0.57 / 0.76)
        src += src_bit.astype(np.int64) << level
        dst += dst_bit.astype(np.int64) << level
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    key = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    vals = (1.0 - rng.random(key.size)).astype(np.float32)
    return n, key // n, key % n, vals


def shifted(n, rows, cols, vals):
    """The graph's adjacency plus a diagonal of 1 + its row sums: symmetric
    and strictly diagonally dominant, so SPD, for cg."""
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    diag = (1.0 + np.bincount(rows, vals, n)).astype(np.float32)
    d = np.arange(n)
    r = np.concatenate([rows, d])
    c = np.concatenate([cols, d])
    order = np.lexsort((c, r))
    return n, r[order], c[order], np.concatenate([vals, diag])[order]


def stencil27(m: int):
    """HPCG's 27-point stencil on an m³ grid."""
    g = np.arange(m ** 3).reshape(m, m, m)
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                src = g[max(-dz, 0):m - max(dz, 0), max(-dy, 0):m - max(dy, 0),
                        max(-dx, 0):m - max(dx, 0)]
                rows.append(src.ravel())
                cols.append(src.ravel() + dz * m * m + dy * m + dx)
    r, c = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    return m ** 3, r, c, np.where(r == c, 26.0, -1.0).astype(np.float32)

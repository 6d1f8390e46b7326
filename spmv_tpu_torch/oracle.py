"""Golden SpMV oracle + result checker.

``golden_spmv``, ``check_result``, ``CheckReport``, ``default_x``,
``EPSILON`` and ``fp32_rel_tol`` are copied from ``spmv_tpu/oracle.py``
(whose import pulls in JAX). The oracle recomputes ``y[r] += v * x[c]``
from raw COO triplets in fp64 (``np.add.at``) — the analog of the
reference's ``check_result`` (its ``inc/helper_functions.h:184-236``).

The JAX package's window scale (``seg_engine_scale``, ``container_scale``)
describes the rounding of its TPU plan layout and has no counterpart here:
every kernel of the port sums each row over that row's own elements only,
so the per-row scale ``Σ|v||x|`` bounds its rounding (``kernel_check``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["golden_spmv", "check_result", "CheckReport", "default_x",
           "EPSILON", "fp32_rel_tol", "KERNEL_TOL_ABS", "row_scale",
           "kernel_check"]

# Reference absolute tolerance (helper_functions.h:11) — valid for its fp64
# path.  The port computes in fp32, so ``check_result`` also supports a
# mixed abs+rel criterion scaled by the accumulation length.
EPSILON = 1e-6

# Absolute floor of the fp32 kernel check (the JAX package's validator uses
# the same, ``spmv_tpu/cli.py:87``).
KERNEL_TOL_ABS = 1e-5


def golden_spmv(
    nrows: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    x: np.ndarray,
) -> np.ndarray:
    """fp64 scatter-accumulate SpMV from COO triplets (duplicates sum)."""
    y = np.zeros(nrows, dtype=np.float64)
    np.add.at(
        y,
        np.asarray(rows, dtype=np.int64),
        np.asarray(vals, dtype=np.float64) * np.asarray(x, dtype=np.float64)[cols],
    )
    return y


def default_x(ncols: int, dtype=np.float64) -> np.ndarray:
    """The reference's input vector: ``x[i] = i`` (``coo.c:88-92``)."""
    return np.arange(ncols, dtype=dtype)


@dataclass
class CheckReport:
    ok: bool
    max_abs_err: float
    max_rel_err: float
    first_bad: int | None
    tol_abs: float
    tol_rel: float

    def __bool__(self) -> bool:  # truthy like the reference's bool return
        return self.ok

    def __str__(self) -> str:
        verdict = "result is ok" if self.ok else "result is wrong"
        return (
            f"{verdict} (max_abs_err={self.max_abs_err:.3e}, "
            f"max_rel_err={self.max_rel_err:.3e}, "
            f"tol_abs={self.tol_abs:.1e}, tol_rel={self.tol_rel:.1e})"
        )


def check_result(
    expected: np.ndarray,
    actual: np.ndarray,
    *,
    tol_abs: float = EPSILON,
    tol_rel: float = 0.0,
    scale: np.ndarray | None = None,
) -> CheckReport:
    """Elementwise ``|expected - actual| <= tol_abs + tol_rel * scale``.

    ``scale`` defaults to ``|expected|``.  For a numerically honest fp32
    check pass ``scale = golden_spmv(|vals|, |x|)`` (the per-row Σ|v·x|):
    an ill-conditioned row (large Σ|v·x|, tiny Σv·x) cannot beat κ·eps in
    any summation order.  With defaults this is exactly the reference
    criterion (``helper_functions.h:221-230``).
    """
    expected = np.asarray(expected, dtype=np.float64)
    actual = np.asarray(actual, dtype=np.float64)
    if expected.shape != actual.shape:
        raise ValueError(f"shape mismatch: {expected.shape} vs {actual.shape}")
    err = np.abs(expected - actual)
    s = np.abs(expected) if scale is None else np.asarray(scale, dtype=np.float64)
    bound = tol_abs + tol_rel * s
    bad = err > bound
    denom = np.maximum(np.abs(expected), 1e-300)
    rel = err / denom
    first_bad = int(np.argmax(bad)) if bad.any() else None
    return CheckReport(
        ok=not bad.any(),
        max_abs_err=float(err.max()) if err.size else 0.0,
        max_rel_err=float(rel.max()) if rel.size else 0.0,
        first_bad=first_bad,
        tol_abs=tol_abs,
        tol_rel=tol_rel,
    )


def fp32_rel_tol(max_row_nnz: int) -> float:
    """Relative tolerance model for an fp32 kernel vs the fp64 oracle:
    accumulated rounding grows ~sqrt(k)·eps for k-term sums (random signs);
    use a conservative linear-in-k bound with headroom."""
    k = max(int(max_row_nnz), 1)
    return 32.0 * np.finfo(np.float32).eps * np.sqrt(k)


def row_scale(nrows: int, rows, cols, vals, x) -> np.ndarray:
    """Per-row ``Σ|v||x|`` in fp64: the magnitude that an fp32 row sum
    rounds at, whatever its order."""
    return golden_spmv(nrows, rows, cols, np.abs(np.asarray(vals)),
                       np.abs(np.asarray(x)))


def kernel_check(expected, actual, scale, max_row_nnz: int) -> CheckReport:
    """The port's criterion for an fp32 SpMV result, per row:
    ``|Δ| ≤ KERNEL_TOL_ABS + fp32_rel_tol(max_row_nnz) · Σ|v||x|``.

    Every kernel of the port (and each plain version) sums a row over its
    own elements only — in a tree, a scan or a sequence, never mixed with
    another row's — so a k-term row's error is at most about k·eps·Σ|v||x|
    and usually √k·eps·Σ|v||x|; ``fp32_rel_tol`` allows 32·√k·eps."""
    return check_result(expected, actual, tol_abs=KERNEL_TOL_ABS,
                        tol_rel=fp32_rel_tol(max_row_nnz), scale=scale)

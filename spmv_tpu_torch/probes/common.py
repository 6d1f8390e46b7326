"""What the probes share: the matrices they run on, the extreme tile
shapes of the segmented and the panel tile kernels, the checks that hold
each member's result to an independent definition, and the two ceiling
members every probe co-samples."""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from spmv_tpu_torch import synth
from spmv_tpu_torch.formats.base import PAD_COL, TILE_NNZ
from spmv_tpu_torch.io.mmio import MMInfo
from spmv_tpu_torch.kernels import probes as KP
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale, x2_check)
from spmv_tpu_torch.probes.bounds import stream_bytes
from spmv_tpu_torch.probes.timing import Member, l2_bytes, synthetic_stream

__all__ = ["MATRICES", "TILE_SHAPES", "PANEL_SHAPES", "PANEL_SPLIT",
           "HBM_STREAM_L2S", "vector", "spmv_check", "panel_triplets",
           "tile_sum_bound", "tile_sums_check", "ceiling_members"]

# The HBM ceiling's stream, in L2 sizes: 250 MiB on the H100's 50 MiB L2.
HBM_STREAM_L2S = 5

# bench.py's main-suite matrix (bench.py:84-85), its 524k-row power-law
# matrix (bench.py:211), the same without its column band (12,373,741 nnz,
# a plan above the 50 MB L2), its 32k-row power-law matrix (bench.py:164)
# and the 1024-row band matrix of the parity tests; then the rest of
# chip_smoke.py's sweep of the one-dispatch threshold: the 512-row matrix
# of ``__graft_entry__.entry()``, cant's generator at 8,192 and 16,384 rows
# and the 32k-row power-law matrix without its band; then the plans of K6's
# sweep there: cant's generator at 4,096 rows (a regular panel under 4 MB),
# bench.py's power-law generator at 2,048-16,384 rows (skewed panels under 4
# MB as sell_pure) and at 16,384 rows with its Zipf lengths capped at 16 and
# 96; partials, so that ``probes.turns`` can name them to a checkout of its
# own
MATRICES = {
    "cant": partial(synth.synthetic_cant, n=62464, avg_nnz_per_row=64,
                    bandwidth=350, seed=0),
    "pl_big": partial(synth.power_law, n=524_288, avg_nnz_per_row=24,
                      bandwidth=512, seed=0),
    "pl_wide": partial(synth.power_law, n=524_288, avg_nnz_per_row=24, seed=0),
    "pl": partial(synth.power_law, n=32768, avg_nnz_per_row=24, bandwidth=512,
                  seed=0),
    "band": partial(synth.synthetic_cant, n=1024, avg_nnz_per_row=16,
                    bandwidth=60, seed=5),
    "entry": partial(synth.synthetic_cant, n=512, avg_nnz_per_row=8, bandwidth=40,
                     seed=0),
    "cant_8192": partial(synth.synthetic_cant, n=8192),
    "cant_16384": partial(synth.synthetic_cant, n=16384),
    "pl_wide_32768": partial(synth.power_law, n=32768, avg_nnz_per_row=24, seed=0),
    "cant_4096": partial(synth.synthetic_cant, n=4096),
    **{f"pl_{n}": partial(synth.power_law, n=n, avg_nnz_per_row=24, bandwidth=512,
                          seed=0) for n in (2048, 4096, 8192, 16384)},
    **{f"pl_cap{m}_16384": partial(synth.power_law, n=16384, avg_nnz_per_row=24,
                                   bandwidth=512, seed=0, max_row=m) for m in (16, 96)},
}

# The SELL panel the ``panel`` probe and ``probes.turns`` run K4 and K14 on:
# cant's as the panel/spill split builds it (1.011 slots per nonzero), the
# power-law matrices' whole (``split=False``, bench.py's ``sell_pure``), as
# chip_smoke.py times them; any other matrix whole
PANEL_SPLIT = {"cant": True}


def _triplets(lengths, ncols: int, seed: int):
    """Row-ordered triplets with ``lengths[i]`` nonzeros in row i, in
    distinct consecutive columns (mod ncols) from a random start, and
    standard-normal values."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    first = np.cumsum(lengths) - lengths
    start = rng.integers(0, ncols, lengths.size)
    cols = (start[rows] + np.arange(rows.size) - first[rows]) % ncols
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(rows.size)
    info = MMInfo("matrix", "coordinate", "real", "general", lengths.size, ncols,
                  rows.size)
    return info, rows, cols, vals


def one_nonzero_rows(seed: int = 0):
    """100 rows of 7 nonzeros, 2,048 rows of one, 100 rows of 5: the tile
    of nonzeros 1024-2047 holds 1024 one-nonzero rows, the most nonempty
    rows a K1 tile can hold."""
    return _triplets([7] * 100 + [1] * 2048 + [5] * 100, 700, seed)


def empty_row_gaps(seed: int = 0):
    """40 rows of 10 nonzeros, 2,500 empty rows, then every sixth of 3,600
    rows with 3 nonzeros, then 400 rows of 8: tiles whose row span is
    thousands of rows, beside tiles of short rows."""
    sparse = np.zeros(3600, np.int64)
    sparse[::6] = 3
    return _triplets([10] * 40 + [0] * 2500 + list(sparse) + [8] * 400, 700, seed)


def hub_row(seed: int = 0):
    """300 rows of 2 nonzeros, one row of 5,000 over six tiles, 300 rows
    of 3."""
    return _triplets([2] * 300 + [5000] + [3] * 300, 6000, seed)


def wide_hub(seed: int = 0):
    """A power-law matrix whose hub row of 22,000 nonzeros spans 22 tiles or
    more: 1,200 rows of Zipf lengths (α = 1.8, at most 64), the hub in
    their middle."""
    tail = np.minimum(np.random.default_rng(seed).zipf(1.8, 1200), 64)
    return _triplets([*tail[:600], 22_000, *tail[600:]], 24_000, seed)


def empty_row_edges(seed: int = 0):
    """Runs of empty rows at every place a tile can meet one: 30 before the
    first nonzero; a row of exactly one tile, then 1,500 empty rows at the
    boundary of tiles 0 and 1 (tile 0's span over the stage's cap); a row
    of 1,536 over tiles 1 and 2, so tile 1 holds no row of its own; 500
    empty rows inside tile 2, a row of 512 that ends at its end and 100
    empty rows at that boundary; 40 rows of 3, then 50 empty rows after the
    last nonzero."""
    return _triplets([0] * 30 + [1024] + [0] * 1500 + [1536] + [0] * 500 + [512]
                     + [0] * 100 + [3] * 40 + [0] * 50, 2000, seed)


# The extreme tiles of the segmented tile kernel (K1, K12) and of the
# one-launch K3's fix-up and zero rows, from a seed: the tests, the gpu
# tests and chip_smoke.py run both engines on them
TILE_SHAPES = {"one_nonzero_rows": one_nonzero_rows,
               "empty_row_gaps": empty_row_gaps, "hub_row": hub_row,
               "wide_hub": wide_hub, "empty_row_edges": empty_row_edges}


def unread_column(seed: int = 0):
    """300 rows over 300 columns, none of them in column 0: row 0 holds 6
    nonzeros and every other row 1, so the first slice pads 31 rows to 6
    columns and the others pad nothing. A non-finite x[0] must reach no
    row; a non-finite entry at a column some row reads (that of the last
    nonzero), only the rows that read it."""
    _, rows, cols, vals = _triplets([6] + [1] * 299, 299, seed)
    info = MMInfo("matrix", "coordinate", "real", "general", 300, 300, rows.size)
    return info, rows, cols + 1, vals


def _slices(widths, seed: int, nrows: int | None = None, ncols: int = 500):
    """Triplets whose 32-row slices have the given widths: the first row of
    each slice holds ``widths[s]`` nonzeros, the other rows up to as many;
    the matrix is cut to ``nrows`` rows."""
    rng = np.random.default_rng(seed)
    widths = np.asarray(widths, np.int64)
    lengths = rng.integers(0, widths[:, None] + 1, (widths.size, 32))
    lengths[:, 0] = widths
    lengths = lengths.reshape(-1)
    return _triplets(lengths[:nrows] if nrows is not None else lengths, ncols, seed)


def empty_at_tile_start(seed: int = 0):
    """Slices of 20 and 12 columns fill tile 0; three empty slices sit at
    tile 1's first column, 50 inside it (one step of the walk passes them
    all) and two at tile 2's first column."""
    return _slices([20, 12, 0, 0, 0, 7, *[0] * 50, 25, 0, 0, 14, 18], seed)


def leading_trailing_empty(seed: int = 0):
    """70 empty slices before the first column (more than one pass of 32
    over tile 0's slices) and 40 after the last."""
    return _slices([0] * 70 + [9, 30, 40, 5] + [0] * 40, seed)


def slice_fills_tile(seed: int = 0):
    """Slices of exactly 32 columns, each a whole tile, and two of 16 that
    share one."""
    return _slices([32, 32, 16, 16, 32], seed)


def hub_slice(seed: int = 0):
    """A slice of 300 columns over ten tiles (its head and tail in other
    tiles, and tiles it only passes through) between narrow slices."""
    return _slices([3, 5, 300, 4, 2], seed)


def one_column_slices(seed: int = 0):
    """Tile 1 holds 32 one-column slices, an empty slice after each (the
    walk steps 62 times in one tile)."""
    return _slices([5, 27] + [1, 0] * 32 + [6], seed)


def cut_last_slice(seed: int = 0):
    """103 rows: the last slice holds 7 real rows and 25 past ``nrows``,
    which have no row of y to write."""
    return _slices([10, 33, 8, 40], seed, nrows=103)


# The cases of the panel tile kernel's ownership and walk (K4, K14): the
# tests, the gpu tests and chip_smoke.py run both on them
PANEL_SHAPES = {"empty_at_tile_start": empty_at_tile_start,
                "leading_trailing_empty": leading_trailing_empty,
                "slice_fills_tile": slice_fills_tile, "hub_slice": hub_slice,
                "one_column_slices": one_column_slices,
                "cut_last_slice": cut_last_slice}


def panel_triplets(dev):
    """The triplets a panel plan holds, pads (column ``PAD_COL``) left out,
    in its own row space: row ``s·32 + l`` of slice s, ``nrows`` rows (the
    last slice's rows past it hold only pads)."""
    sp = dev.slice_ptr.long().cpu().numpy()
    slot = np.arange(int(sp[-1]))
    s = np.searchsorted(sp, slot, side="right") - 1
    rows = s * 32 + slot % 32
    real = (rows < dev.nrows) & (dev.cols.cpu().numpy() != PAD_COL)
    info = MMInfo("matrix", "coordinate", "real", "general", dev.nrows, dev.ncols,
                  int(real.sum()))
    return (info, rows[real], dev.cols.cpu().numpy()[real].astype(np.int64),
            dev.vals.cpu().numpy()[real])


def vector(n: int, dtype: torch.dtype, device, seed: int = 3, R: int | None = None):
    """A standard-normal x (or (n, R) X) from ``seed``, made with numpy."""
    shape = (n,) if R is None else (n, R)
    xh = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(xh).to(dtype).to(device).contiguous()


def spmv_check(trip, x: torch.Tensor, *, fixup=None, x2: bool = False):
    """A check of y = A·x (or Y = A·X, column by column) against the fp64
    oracle: per row within ``1e-5 + fp32_rel_tol(k)·Σ|v||x|`` in float32,
    JAX's ``x2_check`` for a float64 plan. ``fixup`` turns a member's
    result into y (the plain K2 for a tile kernel's ``(y, carry)``)."""
    info, rows, cols, vals = trip
    v = np.asarray(vals, np.float64 if x2 else np.float32)
    X = x.cpu().double().numpy()
    X = X[:, None] if X.ndim == 1 else X
    want = [golden_spmv(info.nrows, rows, cols, v, X[:, j]) for j in range(X.shape[1])]
    scale = [row_scale(info.nrows, rows, cols, v, X[:, j]) for j in range(X.shape[1])]
    k = int(np.bincount(rows, minlength=max(info.nrows, 1)).max()) if rows.size else 1

    def check(out) -> str:
        y = (fixup(out) if fixup else out).cpu().double().numpy()
        y = y[:, None] if y.ndim == 1 else y
        worst = 0.0
        for j in range(y.shape[1]):
            rep = (x2_check(want[j], y[:, j], scale[j]) if x2
                   else kernel_check(want[j], y[:, j], scale[j], k))
            if not rep.ok:
                raise AssertionError(f"column {j} against the fp64 oracle: {rep}")
            worst = max(worst, rep.max_abs_err)
        return f"max abs err {worst:.3e} against the fp64 oracle"
    return check


def _tile_sums(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor | None):
    """numpy's fp64 sums over each 1024 nonzeros of the terms ``noseg``
    (with x: v·x[c]) or ``dma`` (without: v + x̃(c), x̃(c) = (c & 1023)·
    2⁻¹⁰) adds, and of their magnitudes."""
    v = vals.cpu().double().numpy()
    c = cols.cpu().numpy()
    terms = v * x.cpu().double().numpy()[c] if x is not None else v + (c & 1023) * 2.0 ** -10
    if not terms.size:
        return np.zeros(0), np.zeros(0)
    starts = np.arange(0, terms.size, TILE_NNZ)
    return np.add.reduceat(terms, starts), np.add.reduceat(np.abs(terms), starts)


def tile_sum_bound(vals: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor | None = None) -> np.ndarray:
    """How far apart two sums of one tile of ``noseg`` (with x) or ``dma``
    may lie when they add its 1024 terms in other orders: ``1e-5 +
    fp32_rel_tol(1024)·Σ|term|`` in float32, ``1024·2⁻⁵⁰·Σ|term|`` in
    float64."""
    scale = _tile_sums(vals, cols, x)[1]
    if vals.dtype == torch.float32:
        return KERNEL_TOL_ABS + fp32_rel_tol(TILE_NNZ) * scale
    return TILE_NNZ * 2.0 ** -50 * scale


def tile_sums_check(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor | None = None):
    """A check of per-tile sums (``noseg`` with x, ``dma`` without)
    against numpy's fp64 ``add.reduceat`` of the same terms, within
    ``tile_sum_bound``."""
    want = _tile_sums(vals, cols, x)[0]
    bound = tile_sum_bound(vals, cols, x)

    def check(out) -> str:
        err = np.abs(out.cpu().double().numpy() - want)
        if err.shape != want.shape or (err > bound).any():
            raise AssertionError(f"tile sums: max error {err.max():.3e} over "
                                 f"{want.size} tiles")
        return f"max abs err {err.max() if err.size else 0.0:.3e} against numpy's tile sums"
    return check


def ceiling_members(vals: torch.Tensor, cols: torch.Tensor, device) -> list[Member]:
    """``dma`` over the plan's values and columns, and ``hbm``: ``dma`` over
    a synthetic float32 stream of ``HBM_STREAM_L2S`` times the card's L2
    (on the CPU, where nothing is timed, one tile of it)."""
    device = torch.device(device)
    size = HBM_STREAM_L2S * l2_bytes(device) if device.type == "cuda" else 0
    hv, hc = synthetic_stream(size, torch.float32, device)
    # x̃'s multiply and the two adds per nonzero
    return [Member("dma", lambda: KP.ablate_dma(vals, cols), stream_bytes(vals, cols),
                   3 * vals.numel(), vals.dtype, tile_sums_check(vals, cols)),
            Member("hbm", lambda: KP.ablate_dma(hv, hc), stream_bytes(hv, hc),
                   3 * hv.numel(), torch.float32, tile_sums_check(hv, hc))]

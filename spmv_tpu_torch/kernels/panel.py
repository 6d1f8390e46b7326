"""The panel engine: wrappers of the four CUDA kernels of
``csrc/panel_spmv.cu``, each with its plain PyTorch version beside it.

Counterpart of ``spmv_tpu/kernels/engines.py:326-372``, ``:689`` and
``:735``.

==========================  ======================  =====================================
wrapper                     kernel (csrc/)          replaces (spmv_tpu/kernels/)
==========================  ======================  =====================================
panel_spmv_partials         K4 panel_spmv_tiles     engines.py:269 ``_panel_kernel``
panel_spmv_fused            K6 panel_spmv_fused     engines.py:283 ``_panel_kernel_fused``
inverse_permute             K7 inverse_permute      engines.py:719 ``_perm_kernel``; as
                                                    the panel's fix-up, engines.py:171
                                                    ``_scatter_kernel`` and :537
                                                    ``_scatter_kernel_multi``
panel_spmv_multi_partials   K10 panel_spmm_tiles    engines.py:623 ``_panel_kernel_multi``
==========================  ======================  =====================================

K7 is every panel's one epilogue after its tile kernel. It sums the split
slices' partials in tile order and adds the spill part's y, and on a
σ-sorted SELL it also gathers back to row order. Without a row order
(``invperm`` None) it updates the panel's y′ in place: ``panel_fixup``
(``panel_fixup_multi``; ``engines_x2.panel_fixup_x2``) is that identity mode
without a spill, which rewrites the split slices' rows alone.

``panel_spmv`` picks K6 for plans of at most
``device.FUSED_STREAM_BYTES_MAX`` bytes and K4 then K7 otherwise — the JAX
engine's fused and two-dispatch shapes, on the segmented engine's
predicate. K6 walks one slice per warp where every slice is narrow, and
runs K4's tiles, finishing each split slice in the same launch, where one
is wider than ``FUSED_SLICE_COLS_MAX`` columns (``fused_mode``): there its y
is K4 + K7's, bit for bit. ``panel_and_spill_spmv`` adds a CSR spill part
to the panel's y (the panel/spill split of ELL, HYB and unsorted
SELL-C-σ): the tile kernel, the spill part's engine, then K7's identity
mode with the spill, no torch add. ``panel_spmv_multi`` (K10 then K7) and ``panel_and_spill_spmm`` are
the same for X of shape (ncols, R), 2 ≤ R ≤ ``engines.MULTI_RHS_MAX``.
A σ-sorted SELL takes ``sorted_panel_and_spill_spmv`` (``_spmm``): the
same chain with K7 given the row order.

Pad slots (column ``formats.base.PAD_COL``) add nothing in any kernel or
plain version: no x entry is read for them.

Routing, as in ``kernels.engines``: CPU tensors run the plain version
(``*_reference``), CUDA tensors launch the kernel or raise, and each
launch adds one to ``engines.LAUNCHES[kernel]``.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.device import DevCsr, DevPanel
from spmv_tpu_torch.formats.base import SLICE_ROWS, TILE_COLS
from spmv_tpu_torch.kernels.engines import (MULTI_RHS_MAX, _check_X, _check_x,
                                            _launch, _lead, _on_cuda,
                                            segmented_spmv, segmented_spmv_multi,
                                            wrapper)

__all__ = ["panel_spmv", "panel_spmv_partials", "panel_fixup",
           "panel_spmv_fused", "inverse_permute", "panel_and_spill_spmv",
           "panel_spmv_partials_reference", "panel_fixup_reference",
           "panel_spmv_fused_reference", "inverse_permute_reference",
           "panel_spmv_multi", "panel_spmv_multi_partials",
           "panel_fixup_multi", "panel_and_spill_spmm",
           "panel_spmv_multi_partials_reference",
           "panel_fixup_multi_reference", "sorted_panel_and_spill_spmv",
           "sorted_panel_and_spill_spmm", "fused_mode", "FUSED_SLICE_COLS_MAX"]

_C = SLICE_ROWS


def _check_cuda_panel(dev: DevPanel) -> None:
    if dev.tile != TILE_COLS:
        raise ValueError(f"the CUDA kernel takes tile={TILE_COLS}, plan has {dev.tile}")


def _products(dev: DevPanel, x: torch.Tensor) -> torch.Tensor:
    """Each slot's product v·x[c] (a row of R for an (ncols, R) X), exactly
    0 for a pad: x is gathered at a clamped column, so no pad reads x[-1]
    and a non-finite x entry reaches only the slots of its column."""
    c = dev.cols.long()
    return (_lead(dev.vals, x) * x[c.clamp(min=0)]).masked_fill_(_lead(c < 0, x), 0.0)


def _slice_rows(dev: DevPanel, slices: torch.Tensor):
    """Rows of ``slices`` as an (n, 32) index, and which of them are real
    (the last slice may run past ``nrows``)."""
    rows = slices[:, None] * _C + torch.arange(_C, device=slices.device)
    return rows, rows < dev.nrows


# ---------------------------------------------------------------- K4


def _panel_tiles(kernel: str, dtype: torch.dtype, dev: DevPanel, x: torch.Tensor):
    """K4 (float32) or K14 (float64, ``engines_x2``): the wrapper both
    share, so their tile bounds and partial slots cannot drift apart."""
    _check_x(dev, x)
    if not _on_cuda(dev, x, dtype=dtype):
        return panel_spmv_partials_reference(dev, x)
    return _launch_panel_tiles(kernel, dtype, dev, x)


def _launch_panel_tiles(kernel: str, dtype: torch.dtype, dev: DevPanel,
                        x: torch.Tensor | None, key: str | None = None):
    """The launch of K4, K14, K10 (the tile kernel at R columns: x an
    (ncols, R) X, y and the partials R wide, R passed after nrows) or the
    probe's K4 without the gather (``kernels.probes``; x None, not read),
    counted under ``key``. The kernel writes every row of y and every
    partial slot, so neither is filled first."""
    _check_cuda_panel(dev)
    tail = () if x is None else tuple(x.shape[1:])
    if not (dev.nslots and dev.nrows):  # a zero-sized grid is refused
        return (torch.zeros((dev.nrows, *tail), dtype=dtype, device=dev.device),
                torch.zeros((2 * dev.ntiles, _C, *tail), dtype=dtype, device=dev.device))
    y = torch.empty((dev.nrows, *tail), dtype=dtype, device=dev.device)
    part = torch.empty((2 * dev.ntiles, _C, *tail), dtype=dtype, device=dev.device)
    _launch(kernel, dev, dev.slice_ptr, dev.cols, dev.vals, dev.tile_slice0,
            dev.tile_own0, x, y, part, dev.nslots // _C, dev.ntiles, dev.tile,
            dev.nrows, *tail, key=key)
    return y, part


def _panel_fixup(launcher: str, dtype: torch.dtype, dev: DevPanel,
                 y: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """K7's identity mode without a spill, in float32 (``launcher``
    ``inverse_permute``) or float64 (``inverse_permute_x2``): the wrapper
    of ``panel_fixup``, ``panel_fixup_multi`` and ``panel_fixup_x2``."""
    tail = y.shape[1:] if y.dim() == 2 else ()
    if (y.dim() not in (1, 2) or y.shape[0] != dev.nrows
            or part.shape != (2 * dev.ntiles, _C, *tail)):
        raise ValueError("y or part does not match the plan")
    if tail == (0,):  # no columns: nothing to sum
        return y
    return _epilogue(launcher, dtype, None, y, dev.nrows, dev, part, None)


def panel_spmv_partials(dev: DevPanel, x: torch.Tensor):
    """K4: ``(y, part)``. y holds the rows of every slice that lies wholly
    inside one tile (0 for the rest); ``part`` (2·ntiles, 32) holds each
    tile's head and tail partials of the split slices (0 in a slot no
    split slice uses), for ``panel_fixup``."""
    return _panel_tiles("panel_spmv_tiles", torch.float32, dev, x)


def panel_fixup(dev: DevPanel, y: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """Each split slice's rows of ``y`` from its partials, summed in tile
    order: K7's identity mode without a spill (a launch of
    ``inverse_permute``). Updates ``y`` in place and returns it."""
    return _panel_fixup("inverse_permute", torch.float32, dev, y, part)


def panel_spmv_partials_reference(dev: DevPanel, x: torch.Tensor):
    """Plain K4 on the same tile schedule: a segment per (tile, slice)
    pair of slice columns, summed row by row with ``index_add_``; whole
    slices go to y, the head and tail partials to their slots. Given an
    (ncols, R) X it is plain K10: the same with a trailing R axis. Sums
    are in the plan's dtype, so a float64 panel makes it plain K14."""
    dv, dt, tail = dev.device, dev.vals.dtype, x.shape[1:]
    y = torch.zeros((dev.nrows, *tail), dtype=dt, device=dv)
    part = torch.zeros((2 * dev.ntiles, _C, *tail), dtype=dt, device=dv)
    ncol = dev.nslots // _C
    if ncol == 0:
        return y, part
    scol = dev.slice_ptr.long() // _C
    g = torch.arange(ncol, device=dv)
    sl = torch.searchsorted(scol, g, right=True) - 1  # slice of each column
    tile = g // dev.tile
    head = torch.ones(ncol, dtype=torch.bool, device=dv)
    head[1:] = (sl[1:] != sl[:-1]) | (tile[1:] != tile[:-1])
    seg = torch.cumsum(head, 0) - 1
    prod = _products(dev, x).view(ncol, _C, *tail)
    sums = torch.zeros((int(head.sum()), _C, *tail), dtype=dt, device=dv)
    sums.index_add_(0, seg, prod)
    ss, st = sl[head], tile[head]
    cs, ce = scol[ss], scol[ss + 1]
    ts = st * dev.tile
    te = torch.clamp(ts + dev.tile, max=ncol)
    whole = (cs >= ts) & (ce <= te)
    rows, real = _slice_rows(dev, ss[whole])
    y[rows[real]] = sums[whole][real]
    slot = 2 * st + (cs >= ts).long()  # head slot 2t, tail slot 2t+1
    part[slot[~whole]] = sums[~whole]
    return y, part


def panel_fixup_reference(dev: DevPanel, y: torch.Tensor,
                          part: torch.Tensor) -> torch.Tensor:
    """Plain ``panel_fixup``: each split slice's rows of ``y`` summed from
    its partial slots in tile order (the tail slot of its first tile, then
    the head slot of each later tile), one later tile at a time for all
    split slices at once; updates ``y`` in place. Every add is an
    elementwise one in a fixed order, so on either device it gives the
    kernel's bits. Given (nrows, R) Y and (2·ntiles, 32, R) partials it is
    plain ``panel_fixup_multi``; in float64, plain ``panel_fixup_x2``."""
    if dev.nsplit == 0:
        return y
    s = dev.split_slices.long()
    scol = dev.slice_ptr.long() // _C
    ta = scol[s] // dev.tile
    span = (scol[s + 1] - 1) // dev.tile - ta + 1  # tiles each slice touches
    acc = part[2 * ta + 1]
    for k in range(1, int(span.max())):
        later = span > k
        acc[later] += part[2 * (ta[later] + k)]
    rows, real = _slice_rows(dev, s)
    y[rows[real]] = acc[real]
    return y


# ---------------------------------------------------------------- K6

# The widest slice, in slice columns, on which K6 runs its slice mode (a
# warp per slice): a panel with a wider one runs K6's tile mode (K4's tiles,
# each split slice finished by its last tile in the same launch). From
# chip_smoke.py's sweep on an H100 (PERF.md §6): the slice mode's
# time grows with the widest slice (2.8 µs at 9 columns, 9.4 at 75, 12.4 at
# 111, 62 at 672), the tile mode's stays near one tile's walk (6.5-9.1 µs on
# every panel of 4 MB or less); the tile mode won on every skewed panel
# (widest slice 111 columns or more), and the cap lies above the widest
# slice of every regular panel measured (75, cant-8192), which keeps those
# on the slice mode and its bits.
FUSED_SLICE_COLS_MAX = 96


def fused_mode(dev: DevPanel) -> int:
    """K6's mode for a panel: 0, a warp per slice, where no slice is wider
    than ``FUSED_SLICE_COLS_MAX`` columns; else 1, K4's tiles."""
    return int(dev.max_width > FUSED_SLICE_COLS_MAX)


def panel_spmv_fused(dev: DevPanel, x: torch.Tensor) -> torch.Tensor:
    """K6: y = A·x in one launch. In its tile mode (``fused_mode`` 1) the
    last tile of each split slice waits for the pieces the slice's other
    tiles publish in ``dev.fused_words`` and adds them in K7's order, so y
    is K4 + K7's, bit for bit; the words are the plan's, so two K6 launches
    on one plan must not overlap (one stream, as every caller of the port
    launches). Its slice mode sums each row in column order, as K4 does
    within a tile."""
    _check_x(dev, x)
    if not _on_cuda(dev, x):
        return panel_spmv_fused_reference(dev, x)
    _check_cuda_panel(dev)
    if dev.nslots == 0 or dev.nrows == 0:  # nothing to launch: y is all zeros
        return torch.zeros(dev.nrows, dtype=torch.float32, device=dev.device)
    y = torch.empty(dev.nrows, dtype=torch.float32, device=dev.device)
    _launch("panel_spmv_fused", dev, dev.slice_ptr, dev.cols, dev.vals, dev.tile_slice0,
            dev.tile_own0, x, y, dev.fused_words, dev.nslices,
            dev.nslots // _C, dev.ntiles, dev.tile, dev.nrows, fused_mode(dev))
    return y


def panel_spmv_fused_reference(dev: DevPanel, x: torch.Tensor,
                               mode: int | None = None) -> torch.Tensor:
    """Plain K6 in ``mode`` (None: the one ``fused_mode`` picks). The slice
    mode (0): the products as (slice column, row) rows, summed per slice
    (``segment_reduce`` over each slice's K_s columns). The tile mode (1):
    plain K4, then plain ``panel_fixup``, so plain K4 + K7's y bit for bit.
    A plan with no slots or no rows gives zeros, as the kernel's wrapper
    does."""
    if dev.nslots == 0 or dev.nrows == 0:
        return torch.zeros(dev.nrows, dtype=torch.float32, device=dev.device)
    if fused_mode(dev) if mode is None else mode:
        return panel_fixup_reference(dev, *panel_spmv_partials_reference(dev, x))
    prod = _products(dev, x).view(-1, _C)
    widths = torch.diff(dev.slice_ptr.long()) // _C
    per_slice = torch.segment_reduce(prod, "sum", lengths=widths, axis=0,
                                     initial=0.0)
    return per_slice.reshape(-1)[:dev.nrows].contiguous()


# ---------------------------------------------------------------- dispatch


def panel_spmv(dev: DevPanel, x: torch.Tensor) -> torch.Tensor:
    """y = A·x over the panel: K6 for small plans (``dev.fused``), else K4
    then K7's identity mode on the split slices."""
    if dev.fused:
        return panel_spmv_fused(dev, x)
    y, part = panel_spmv_partials(dev, x)
    return panel_fixup(dev, y, part)


@wrapper
def panel_and_spill_spmv(dev: DevPanel, dev_spill: DevCsr | None,
                         x: torch.Tensor) -> torch.Tensor:
    """y = panel part + spill part, two plans over the same rows: the
    panel's tile kernel K4 (K6 for a small plan), the spill part's engine,
    then K7's identity mode, which sums the split slices' partials and adds
    the spill's y into the panel's y in place, one rounding per row as a
    torch add gives (JAX adds the two engines' y with an XLA add, not a
    Pallas kernel). An empty part launches nothing."""
    if dev_spill is None:
        return panel_spmv(dev, x)
    if dev.nslots == 0:  # pure spill: no dispatch for an empty panel
        return segmented_spmv(dev_spill, x)
    y, part = (panel_spmv_fused(dev, x), None) if dev.fused else panel_spmv_partials(dev, x)
    spill = segmented_spmv(dev_spill, x)
    return inverse_permute(None, y, dev.nrows, dev=dev, part=part, spill=spill)


# ---------------------------------------------------------------- K10


def panel_spmv_multi_partials(dev: DevPanel, X: torch.Tensor):
    """K10, K4 at R columns: ``(Y, part)`` for X of shape (ncols, R).
    Y (nrows, R) holds the rows of every slice that lies wholly inside one
    tile (0 for the rest); ``part`` (2·ntiles, 32, R) holds the split
    slices' head and tail partials (0 in a slot no split slice uses), for
    ``panel_fixup_multi``."""
    _check_X(dev, X)
    if not _on_cuda(dev, X):
        return panel_spmv_multi_partials_reference(dev, X)
    return _launch_panel_tiles("panel_spmm_tiles", torch.float32, dev, X)


def panel_fixup_multi(dev: DevPanel, Y: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """``panel_fixup`` at R columns: each split slice's rows of ``Y``
    (nrows, R) from K10's partials, summed in tile order, by K7's identity
    mode without a spill (one thread per row carrying R sums). Updates
    ``Y`` in place and returns it."""
    if Y.dim() != 2:
        raise ValueError("Y or part does not match the plan")
    return _panel_fixup("inverse_permute", torch.float32, dev, Y, part)


# Plain K10 and its fix-up: plain K4 and ``panel_fixup``, which take a
# trailing R axis.
panel_spmv_multi_partials_reference = panel_spmv_partials_reference
panel_fixup_multi_reference = panel_fixup_reference


def panel_spmv_multi(dev: DevPanel, X: torch.Tensor) -> torch.Tensor:
    """Y = A·X over the panel for X of shape (ncols, R), 2 ≤ R ≤
    MULTI_RHS_MAX: K10, then K7's identity mode on the split slices."""
    Y, part = panel_spmv_multi_partials(dev, X)
    return panel_fixup_multi(dev, Y, part)


@wrapper
def panel_and_spill_spmm(dev: DevPanel, dev_spill: DevCsr | None,
                         X: torch.Tensor) -> torch.Tensor:
    """Y = panel part + spill part for X of shape (ncols, R): one
    multi-RHS pass over each plan (K10, K8 + K9), then K7's identity mode
    over rows of R, as ``panel_and_spill_spmv`` does for one vector."""
    if dev_spill is None:
        return panel_spmv_multi(dev, X)
    if dev.nslots == 0:  # pure spill: no dispatch for an empty panel
        return segmented_spmv_multi(dev_spill, X)
    Y, part = panel_spmv_multi_partials(dev, X)
    spill = segmented_spmv_multi(dev_spill, X)
    return inverse_permute(None, Y, dev.nrows, dev=dev, part=part, spill=spill)


# ---------------------------------------------------------------- K7


def _epilogue(launcher: str, dtype: torch.dtype, invperm: torch.Tensor | None,
              y_sorted: torch.Tensor, nrows: int, dev: DevPanel | None,
              part: torch.Tensor | None, spill: torch.Tensor | None) -> torch.Tensor:
    """K7 in float32 (``inverse_permute``) or float64 (``launcher``
    ``inverse_permute_x2``): the wrapper both share, counted under
    ``inverse_permute``. ``invperm`` None is the identity, in place on
    ``y_sorted``."""
    identity = invperm is None
    if not identity and (invperm.dtype != torch.int32 or not invperm.is_contiguous()):
        raise ValueError(f"invperm must be contiguous int32, got {invperm.dtype}")
    rows = y_sorted.shape[0] if identity else invperm.numel()
    R = y_sorted.shape[1] if y_sorted.dim() == 2 else 1
    if ((not identity and invperm.dim() != 1) or y_sorted.dim() not in (1, 2)
            or y_sorted.shape[0] != rows or not 1 <= R <= MULTI_RHS_MAX
            or not (nrows == rows if identity else 0 <= nrows <= rows)):
        shown = "identity" if identity else tuple(invperm.shape)
        raise ValueError(f"invperm {shown}, y_sorted "
                         f"{tuple(y_sorted.shape)} and nrows {nrows} do not match")
    if launcher.endswith("_x2") and y_sorted.dim() != 1:
        raise ValueError(f"the float64 K7 takes one column, y_sorted is "
                         f"{tuple(y_sorted.shape)}")
    if spill is not None and spill.shape != y_sorted.shape:
        raise ValueError(f"spill {tuple(spill.shape)} is not y_sorted's "
                         f"{tuple(y_sorted.shape)}")
    if part is not None and (
            dev is None or dev.nrows != rows
            or part.shape != (2 * dev.ntiles, _C, *y_sorted.shape[1:])):
        raise ValueError("partials need the panel plan they belong to")
    if not identity and invperm.device != y_sorted.device:
        raise ValueError(f"invperm on {invperm.device}, y_sorted on {y_sorted.device}")
    extra = tuple(t for t in (part, spill) if t is not None)
    anchor = dev if part is not None else y_sorted if identity else invperm
    if not _on_cuda(anchor, y_sorted, *extra, dtype=dtype):
        return inverse_permute_reference(invperm, y_sorted, nrows, dev=dev,
                                         part=part, spill=spill)
    if part is not None and not dev.nsplit:  # no split slice: y′ is whole
        part = None
    if part is not None and dev.tile != TILE_COLS:
        raise ValueError(f"the CUDA kernel takes tile={TILE_COLS}, plan has {dev.tile}")
    if identity:
        y = y_sorted
        if part is None and spill is None:  # nothing to sum or add: y′ is y
            return y
    else:
        y = torch.empty((nrows, *y_sorted.shape[1:]), dtype=dtype, device=y_sorted.device)
    if not nrows:  # a zero-sized grid is refused
        return y
    rhs = () if launcher.endswith("_x2") else (R,)
    slice_ptr, split_slices, nsplit = ((None, None, 0) if part is None else
                                       (dev.slice_ptr, dev.split_slices, dev.nsplit))
    _launch(launcher, y_sorted, invperm, slice_ptr, split_slices, part, y_sorted, spill, y,
            nrows, nsplit, TILE_COLS, *rhs, key="inverse_permute")
    return y


def inverse_permute(invperm: torch.Tensor | None, y_sorted: torch.Tensor, nrows: int, *,
                    dev: DevPanel | None = None, part: torch.Tensor | None = None,
                    spill: torch.Tensor | None = None) -> torch.Tensor:
    """K7, every panel's epilogue: ``y[i] = v(invperm[i])`` for ``i <
    nrows``, where ``invperm`` maps an original row to its sorted position
    and v(p) is row p of the panel's ``y_sorted`` (y′, a vector or an
    (nrows_pad, R) Y, 1 ≤ R ≤ MULTI_RHS_MAX) — or, given the tile kernel's
    partials ``part`` of panel plan ``dev``, the sum of a split slice's
    partials in tile order (y′'s rows of split slices are not read) — plus
    row p of ``spill`` (the spill part's y′ over the same rows) where
    given. With neither it is the index gather that undoes the sort and
    cuts y to ``nrows``. ``invperm`` None is the identity (p = i, ``nrows``
    all of y′'s rows): y′ is updated in place and returned, every row where
    a spill is given, else only the split slices' rows. On the card it is a
    programmatic dependent launch: the kernel ahead of it on the stream
    writes y′, the partials or the spill, never ``invperm`` or the plan."""
    return _epilogue("inverse_permute", torch.float32, invperm, y_sorted, nrows,
                     dev, part, spill)


def inverse_permute_reference(invperm: torch.Tensor | None, y_sorted: torch.Tensor,
                              nrows: int, *, dev: DevPanel | None = None,
                              part: torch.Tensor | None = None,
                              spill: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K7: the plain versions in the order the kernel folds them —
    plain ``panel_fixup`` (at R columns, in float64, by shape and dtype) of
    the partials into a copy of y′, the spill's y′ added, then an index
    gather (of rows, for an (nrows_pad, R) Y). ``invperm`` None is the
    identity: the same steps in place on y′, no gather."""
    if invperm is None:
        if part is not None:
            panel_fixup_reference(dev, y_sorted, part)
        if spill is not None:
            y_sorted.add_(spill)
        return y_sorted
    y = y_sorted
    if part is not None:
        y = panel_fixup_reference(dev, y_sorted.clone(), part)
    if spill is not None:
        y = y + spill
    return y[invperm[:nrows].long()]


# ---------------------------------------------------------------- sorted SELL


@wrapper
def sorted_panel_and_spill_spmv(dev: DevPanel, dev_spill: DevCsr | None,
                                invperm: torch.Tensor, x: torch.Tensor,
                                nrows: int) -> torch.Tensor:
    """y = A·x for a σ-sorted SELL, in original row order and cut to
    ``nrows``: the panel's tile kernel K4 (K6 for a small plan), the spill
    part's engine where there is one, then K7, which sums the split slices'
    partials, adds the spill and gathers in one launch: the chain of
    ``panel_and_spill_spmv`` with the row order given to K7."""
    y, part = (panel_spmv_fused(dev, x), None) if dev.fused else panel_spmv_partials(dev, x)
    spill = segmented_spmv(dev_spill, x) if dev_spill is not None else None
    return inverse_permute(invperm, y, nrows, dev=dev, part=part, spill=spill)


@wrapper
def sorted_panel_and_spill_spmm(dev: DevPanel, dev_spill: DevCsr | None,
                                invperm: torch.Tensor, X: torch.Tensor,
                                nrows: int) -> torch.Tensor:
    """``sorted_panel_and_spill_spmv`` for X of shape (ncols, R), 2 ≤ R ≤
    MULTI_RHS_MAX: K10, the spill's K8 + K9, then K7 over rows of R."""
    Y, part = panel_spmv_multi_partials(dev, X)
    spill = segmented_spmv_multi(dev_spill, X) if dev_spill is not None else None
    return inverse_permute(invperm, Y, nrows, dev=dev, part=part, spill=spill)

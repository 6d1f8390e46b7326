"""The segmented SpMV engine: wrappers of the five CUDA kernels, each with
its plain PyTorch version beside it.

Counterpart of ``spmv_tpu/kernels/engines.py:464-531`` and ``:553-685``.

=============================  =====================  ======================================
wrapper                        kernel (csrc/)         replaces (spmv_tpu/kernels/)
=============================  =====================  ======================================
segmented_spmv_partials        K1 seg_spmv_tiles      engines.py:414 ``_seg_kernel``
carry_fixup                    K2 carry_fixup         engines.py:171 ``_scatter_kernel``
segmented_spmv_fused           K3 csr_spmv_fused      engines.py:430 ``_seg_kernel_fused``
segmented_spmv_multi_partials  K8 seg_spmm_tiles      engines.py:571 ``_seg_kernel_multi``
carry_fixup_multi              K9 carry_fixup_multi   engines.py:537 ``_scatter_kernel_multi``
=============================  =====================  ======================================

``segmented_spmv`` picks K3 for plans of at most
``device.FUSED_STREAM_BYTES_MAX`` bytes and K1 then K2 otherwise — the
JAX engine's fused and two-dispatch shapes. K3 runs K1's tiles and does
K2's adds in the same launch, so both shapes give the same bits, on every
plan with a long row; on plans of short rows it runs a sub-warp per row
(``fused_lanes``). ``segmented_spmv_multi`` is
Y = A·X for 2 ≤ R ≤ ``MULTI_RHS_MAX`` right-hand sides in one pass over
the plan, K8 then K9, on the same tile schedule: X is row-major
(ncols, R), Y row-major (nrows, R), carries (2·ntiles, R).

Routing: a wrapper given CPU tensors runs its plain version (``*_reference``,
which the CPU tests use); given CUDA tensors it launches its kernel or
raises. There is no fallback from one to the other. Each launch adds one
to ``LAUNCHES[kernel]``, so a run can show that it went through the
kernels. The dispatch wrappers the containers call (``segmented_spmv``,
``segmented_spmv_multi``, and the panel and fp64-grade ones, ``wrapper``)
are ``spmv.wrapper`` spans of ``trace`` while it is armed, with the
launches each made.

On a plan whose columns are relabelled (``DevCsr.col_order``, set by
``DevCsr.from_plan``'s rule), every function here that reads x (or X) at
the plan's columns, kernel or plain version, first gathers it into the
plan's order (``plan_x``): callers pass x in the matrix's own labels. K1's
launch on such a plan in float32 runs K1's hot-head kernel
(``seg_spmv_tiles_hot``, ``hot_head``), which reads the hottest
``hot_cols()`` labels' x from shared memory and gives K1's y and carries
bit for bit.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch import trace
from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.formats.base import TILE_NNZ

__all__ = ["segmented_spmv", "segmented_spmv_partials", "carry_fixup",
           "segmented_spmv_fused", "segmented_spmv_partials_reference",
           "carry_fixup_reference", "segmented_spmv_fused_reference",
           "segmented_spmv_multi", "segmented_spmv_multi_partials",
           "carry_fixup_multi", "segmented_spmv_multi_partials_reference",
           "carry_fixup_multi_reference", "MULTI_RHS_MAX", "carry_slot_rows",
           "tile_outputs", "LAUNCHES", "GATHERS", "reset_launches", "plan_x",
           "fused_lanes", "row_lanes", "ROWS_MAX_STEPS", "KernelError", "hot_head",
           "hot_cols"]

# Launch counts per kernel, this engine's, the panel engine's
# (``kernels.panel``) and the fp64-grade ones (``kernels.engines_x2``); the
# probes' kernels (``kernels.probes``) add their own keys. The plain
# versions never touch them.
LAUNCHES = {"seg_spmv_tiles": 0, "carry_fixup": 0, "csr_spmv_fused": 0,
            "panel_spmv_tiles": 0, "panel_spmv_fused": 0, "inverse_permute": 0,
            "seg_spmm_tiles": 0, "carry_fixup_multi": 0, "panel_spmm_tiles": 0,
            "seg_spmv_tiles_x2": 0, "carry_fixup_x2": 0, "panel_spmv_tiles_x2": 0,
            "seg_spmv_tiles_hot": 0}

# Gathers of x (or X's rows) into a relabelled plan's column order
# (``plan_x``), on either device; not a kernel of the port, so not a key of
# LAUNCHES.
GATHERS = {"x_gathers": 0}

# The widest X the multi-RHS kernels take (K8 and K10 are built for R = 2..8;
# ``spmv_tpu/kernels/engines.py:74``). ``api.spmm`` runs one ``matvec`` per
# column outside 2 ≤ R ≤ MULTI_RHS_MAX, as the JAX package does.
MULTI_RHS_MAX = 8


class KernelError(RuntimeError):
    """A launcher returned a CUDA error code."""


def reset_launches() -> None:
    """Set LAUNCHES and GATHERS to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GATHERS["x_gathers"] = 0


def _launched() -> dict:
    return {"launches": sum(LAUNCHES.values()), **GATHERS}


# A dispatch wrapper that a container's matvec or matmat calls: each call
# while ``trace`` is armed is an ``spmv.wrapper`` span with its launches
# and x gathers (a wrapper called inside another is part of it).
wrapper = trace.traced("spmv.wrapper", tally=_launched)


def plan_x(dev, x: torch.Tensor) -> torch.Tensor:
    """x (or an (ncols, R) X) in the plan's column order: ``x`` itself, or
    on a relabelled plan its rows gathered through ``dev.col_order``, one
    ``index_select`` counted in GATHERS."""
    if dev.col_order is None:
        return x
    GATHERS["x_gathers"] += 1
    return x.index_select(0, dev.col_order)


def _on_cuda(dev, *tensors: torch.Tensor, dtype: torch.dtype = torch.float32) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises for anything else. ``dev`` is a device
    plan, or any object with a ``device`` (a tensor). A plan's values and
    every tensor must be ``dtype``, the type the kernel reads: a float64
    plan handed to a float32 kernel (or the reverse) is refused here, on
    either device, before anything is launched."""
    vals = getattr(dev, "vals", None)
    if vals is not None and vals.dtype != dtype:
        raise ValueError(f"the plan holds {vals.dtype} values; this kernel "
                         f"takes {dtype}")
    for t in tensors:
        if t.device != dev.device:
            raise ValueError(f"tensor on {t.device}, plan on {dev.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype}, got {t.dtype}")
    kind = dev.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev.device}")
    return kind == "cuda"


def _check_x(dev, x: torch.Tensor) -> None:
    if x.shape != (dev.ncols,):
        raise ValueError(f"x must have shape ({dev.ncols},), got {tuple(x.shape)}")


def _check_X(dev, X: torch.Tensor) -> int:
    """R of an (ncols, R) X with 2 ≤ R ≤ MULTI_RHS_MAX; raises otherwise.
    (``_on_cuda`` checks that X is contiguous float32.)"""
    if X.dim() != 2 or X.shape[0] != dev.ncols:
        raise ValueError(f"X must be ({dev.ncols}, R), got {tuple(X.shape)}")
    R = X.shape[1]
    if not 2 <= R <= MULTI_RHS_MAX:
        raise ValueError(f"the multi-RHS kernels take 2 ≤ R ≤ {MULTI_RHS_MAX}, "
                         f"got R = {R}")
    return R


def _lead(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``vals`` shaped to multiply ``x[cols]``: (n,) for a vector x, (n, 1)
    for an (ncols, R) X — the plain versions take either."""
    return vals.view(-1, *([1] * (x.dim() - 1)))


def _launch(name: str, dev, *args, key: str | None = None,
            counts: dict = LAUNCHES) -> None:
    """Call launcher ``name`` on the current stream of the plan's device;
    tensors pass as their data pointers, None as a null pointer. The launch
    counts in ``counts`` under ``key`` (default ``name``)."""
    from spmv_tpu_torch.kernels import _build

    lib = _build.library().lib
    with torch.cuda.device(dev.device):
        stream = torch.cuda.current_stream(dev.device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(lib, name)(*cargs, stream)
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc}")
    counts[key or name] += 1


# ---------------------------------------------------------------- K1 + K2


def _seg_tiles(kernel: str, dtype: torch.dtype, dev: DevCsr, x: torch.Tensor):
    """K1 (float32) or K12 (float64, ``engines_x2``): the wrapper both
    share, so their tile bounds and carry slots cannot drift apart."""
    _check_x(dev, x)
    if not _on_cuda(dev, x, dtype=dtype):
        return segmented_spmv_partials_reference(dev, x)
    return _launch_seg_tiles(kernel, dtype, dev, x)


def tile_outputs(dev: DevCsr, dtype: torch.dtype, tail=()):
    """y and carry for a launch of the tile kernel (K1, K8, K12 and the
    probes' instantiations): y zero-filled, since rows with no nonzeros are
    not written; carry not filled, since the kernel writes every slot a
    split row uses and the fix-ups read no other (``carry_slot_rows``)."""
    y = torch.zeros((dev.nrows, *tail), dtype=dtype, device=dev.device)
    carry = torch.empty((2 * dev.ntiles, *tail), dtype=dtype, device=dev.device)
    return y, carry


def hot_head(dev: DevCsr, x: torch.Tensor) -> bool:
    """Whether a launch of the tile kernel on ``dev`` with ``x`` runs K1's
    hot-head kernel in K1's place: a relabelled float32 plan and a vector
    x. K12 (float64), K8 (an (ncols, R) X) and every plan that is not
    relabelled keep their kernels."""
    return (dev.col_order is not None and dev.vals.dtype == torch.float32
            and x.dim() == 1)


def hot_cols() -> int:
    """The labels whose x K1's hot-head kernel reads from shared memory
    (``kHotCols``, derived in ``csrc/seg_hot.cu``), from the built
    library."""
    from spmv_tpu_torch.kernels import _build

    return _build.library().lib.seg_spmv_tiles_hot_cols()


def _launch_seg_tiles(kernel: str, dtype: torch.dtype, dev: DevCsr, x: torch.Tensor):
    """The launch of K1, K12 or K8 (the tile kernel at R columns: x an
    (ncols, R) X, y and the carries R wide, R passed after the tile), into
    ``tile_outputs``; K1's hot-head kernel where ``hot_head`` says so (the
    entries of x passed after the tile)."""
    if dev.tile != TILE_NNZ:
        raise ValueError(f"the CUDA kernel takes tile={TILE_NNZ}, plan has {dev.tile}")
    for t in (dev.cols, dev.vals):  # 4 nonzeros per step, in 16-byte loads
        if t.data_ptr() % 16:
            raise ValueError("plan tensors must be 16-byte aligned")
    tail = tuple(x.shape[1:])
    y, carry = tile_outputs(dev, dtype, tail)
    if dev.nnz:  # a zero-sized grid is refused: nothing to launch
        xp = plan_x(dev, x)
        if hot_head(dev, x):
            kernel, tail = "seg_spmv_tiles_hot", (xp.numel(),)
        _launch(kernel, dev, dev.ptr, dev.cols, dev.vals, dev.tile_row0,
                xp, y, carry, dev.nnz, dev.ntiles, dev.tile, *tail)
    return y, carry


def _seg_fixup(kernel: str, dtype: torch.dtype, dev: DevCsr, y: torch.Tensor,
               carry: torch.Tensor) -> torch.Tensor:
    """K2 (float32) or K13 (float64): the wrapper both share."""
    if y.shape != (dev.nrows,) or carry.shape != (2 * dev.ntiles,):
        raise ValueError("y or carry does not match the plan")
    if not _on_cuda(dev, y, carry, dtype=dtype):
        return carry_fixup_reference(dev, y, carry)
    if dev.tile != TILE_NNZ:
        raise ValueError(f"the CUDA kernel takes tile={TILE_NNZ}, plan has {dev.tile}")
    if dev.ncarry:  # no row crosses a tile boundary: nothing to launch
        _launch(kernel, dev, dev.ptr, dev.carry_rows, carry, y, dev.ncarry,
                dev.tile)
    return y


def segmented_spmv_partials(dev: DevCsr, x: torch.Tensor):
    """K1: ``(y, carry)``. y holds every row that lies wholly inside one
    tile (and 0 for empty rows); ``carry`` (2 slots per tile, see
    ``formats.base``) holds the partials of the rows that cross a tile
    boundary, for ``carry_fixup``. On a relabelled plan the card runs K1's
    hot-head kernel, with K1's bits (``hot_head``). On the card a slot
    that no split row uses (``carry_slot_rows`` -1) holds whatever the
    memory held: the kernel does not write it and nothing reads it. The
    plain version leaves such slots 0."""
    return _seg_tiles("seg_spmv_tiles", torch.float32, dev, x)


def carry_fixup(dev: DevCsr, y: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """K2: adds each split row's partials, in tile order, into ``y``.
    Updates ``y`` in place (no second y buffer) and returns it. On the
    card K2 is a programmatic dependent launch: it reads its rows and their
    offsets while the kernel ahead of it on the stream (K1) finishes, then
    waits for that kernel before it reads ``carry``. So ``dev``'s plan must
    not be written by that kernel, as no kernel of the port does."""
    return _seg_fixup("carry_fixup", torch.float32, dev, y, carry)


def segmented_spmv_partials_reference(dev: DevCsr, x: torch.Tensor):
    """Plain K1 on the same tile schedule: a segment per (tile, row) pair,
    summed with ``index_add_``; whole rows go to y, the head and tail
    partials to their carry slots. Given an (ncols, R) X it is plain K8:
    the same with a trailing R axis on y, carry and every sum. Sums are in
    the plan's dtype, so a float64 plan makes it plain K12."""
    dv, dt, tail = dev.device, dev.vals.dtype, x.shape[1:]
    y = torch.zeros((dev.nrows, *tail), dtype=dt, device=dv)
    carry = torch.zeros((2 * dev.ntiles, *tail), dtype=dt, device=dv)
    if dev.nnz == 0:
        return y, carry
    ptr = dev.ptr.long()
    e = torch.arange(dev.nnz, device=dv)
    row = torch.searchsorted(ptr, e, right=True) - 1
    tile = e // dev.tile
    head = torch.ones(dev.nnz, dtype=torch.bool, device=dv)
    head[1:] = (row[1:] != row[:-1]) | (tile[1:] != tile[:-1])
    seg = torch.cumsum(head, 0) - 1
    prod = _lead(dev.vals, x) * plan_x(dev, x)[dev.cols.long()]
    sums = torch.zeros((int(head.sum()), *tail), dtype=dt, device=dv)
    sums.index_add_(0, seg, prod)
    srow, stile = row[head], tile[head]
    rs, re = ptr[srow], ptr[srow + 1]
    ts = stile * dev.tile
    te = torch.clamp(ts + dev.tile, max=dev.nnz)
    whole = (rs >= ts) & (re <= te)
    y[srow[whole]] = sums[whole]
    slot = 2 * stile + (rs >= ts).long()  # head slot 2t, tail slot 2t+1
    carry[slot[~whole]] = sums[~whole]
    return y, carry


def carry_slot_rows(dev: DevCsr) -> torch.Tensor:
    """The split row whose partial each of the plan's ``2·ntiles`` carry
    slots holds, -1 for a slot no row uses, on the plan's device: row r
    with ``ta = ptr[r] // tile`` and ``tb = (ptr[r+1] - 1) // tile`` owns
    the tail slot ``2ta+1`` and the head slots ``2t``, ``ta < t <= tb``.
    These are the slots the tile kernel writes and the fix-ups read; the
    checks of a carry compare these slots only."""
    owner = torch.full((2 * dev.ntiles,), -1, dtype=torch.long, device=dev.device)
    if dev.ncarry == 0:
        return owner
    r = dev.carry_rows.long()
    ptr = dev.ptr.long()
    ta = ptr[r] // dev.tile
    counts = (ptr[r + 1] - 1) // dev.tile - ta + 1
    first = torch.repeat_interleave(ta, counts)  # each slot's row's first tile
    step = torch.arange(int(counts.sum()), device=dev.device) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    t = first + step
    owner[2 * t + (step == 0).long()] = torch.repeat_interleave(r, counts)
    return owner


def carry_fixup_reference(dev: DevCsr, y: torch.Tensor,
                          carry: torch.Tensor) -> torch.Tensor:
    """Plain K2: gathers each split row's carry slots and sums them in tile
    order with ``index_add_``; updates ``y`` in place. Given (nrows, R) Y
    and (2·ntiles, R) carries it is plain K9; in float64, plain K13."""
    if dev.ncarry == 0:
        return y
    dv = dev.device
    r = dev.carry_rows.long()
    ptr = dev.ptr.long()
    ta = ptr[r] // dev.tile
    tb = (ptr[r + 1] - 1) // dev.tile
    counts = tb - ta + 1
    owner = torch.repeat_interleave(torch.arange(dev.ncarry, device=dv), counts)
    first = torch.cumsum(counts, 0) - counts
    t = ta[owner] + torch.arange(owner.numel(), device=dv) - first[owner]
    slot = 2 * t + (t == ta[owner]).long()
    s = torch.zeros((dev.ncarry, *y.shape[1:]), dtype=y.dtype, device=dv)
    s.index_add_(0, owner, carry[slot])
    y[r] = s
    return y


# ---------------------------------------------------------------- K8 + K9


def segmented_spmv_multi_partials(dev: DevCsr, X: torch.Tensor):
    """K8, K1 at R columns: ``(Y, carry)`` for X of shape (ncols, R).
    Y (nrows, R) holds every row that lies wholly inside one tile;
    ``carry`` (2·ntiles, R) holds the split rows' head and tail partials,
    for ``carry_fixup_multi``."""
    _check_X(dev, X)
    if not _on_cuda(dev, X):
        return segmented_spmv_multi_partials_reference(dev, X)
    return _launch_seg_tiles("seg_spmm_tiles", torch.float32, dev, X)


def carry_fixup_multi(dev: DevCsr, Y: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """K9: adds each split row's partials, in tile order and column by
    column, into ``Y``. Updates ``Y`` in place and returns it. On the card
    K9 is K2's kernel at R columns and, like K2, a programmatic dependent
    launch that reads its rows and their offsets before it waits for the
    kernel ahead of it (K8)."""
    R = Y.shape[-1] if Y.dim() == 2 else 0
    if Y.shape != (dev.nrows, R) or carry.shape != (2 * dev.ntiles, R):
        raise ValueError("Y or carry does not match the plan")
    if not _on_cuda(dev, Y, carry):
        return carry_fixup_multi_reference(dev, Y, carry)
    if dev.tile != TILE_NNZ:
        raise ValueError(f"the CUDA kernel takes tile={TILE_NNZ}, plan has {dev.tile}")
    if dev.ncarry and R:  # no row crosses a tile boundary: nothing to launch
        _launch("carry_fixup_multi", dev, dev.ptr, dev.carry_rows, carry, Y,
                dev.ncarry, dev.tile, R)
    return Y


# Plain K8 and K9: plain K1 and K2, which take a trailing R axis.
segmented_spmv_multi_partials_reference = segmented_spmv_partials_reference
carry_fixup_multi_reference = carry_fixup_reference


@wrapper
def segmented_spmv_multi(dev: DevCsr, X: torch.Tensor) -> torch.Tensor:
    """Y = A·X for X of shape (ncols, R), 2 ≤ R ≤ MULTI_RHS_MAX: one pass
    over the plan (K8), then the carries (K9)."""
    Y, carry = segmented_spmv_multi_partials(dev, X)
    return carry_fixup_multi(dev, Y, carry)


# ---------------------------------------------------------------- K3


def row_lanes(dev: DevCsr) -> int:
    """The lanes per row of K3's sub-warp mode: the smallest of 4, 8, 16,
    32 that covers the mean row length (32 for anything longer)."""
    mean = dev.nnz / max(dev.nrows, 1)
    return next((v for v in (4, 8, 16) if mean <= v), 32)


# The most steps of its sub-warp the longest row may take for K3 to run a
# sub-warp per row: on an H100 it beat the tiles on every plan whose longest
# row took 1-3 steps (synthetic_cant at 512-62,464 rows, 1.5-2.0×) and lost
# on a power-law plan at 4 (1.1×) and on every one above (PERF.md).
ROWS_MAX_STEPS = 3


def fused_lanes(dev: DevCsr) -> int:
    """K3's mode for a plan: 0 for K1's tiles, else the lanes per row of its
    sub-warp mode (``row_lanes``), which runs only where no row takes more
    than ``ROWS_MAX_STEPS`` steps of them."""
    vec = row_lanes(dev)
    return vec if dev.max_row_nnz <= ROWS_MAX_STEPS * vec else 0


def segmented_spmv_fused(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """K3: y = A·x in one launch. On K1's tile schedule (``fused_lanes``
    0, any plan with a long row) the block of each split row's last tile
    waits for the partials the row's other tiles publish in
    ``dev.fused_words`` and adds them in K2's order, so y is K1 + K2's, bit
    for bit; the words are the plan's, so two K3 launches on one plan must
    not overlap (one stream, as every caller of the port launches). On a
    plan of short rows it runs a sub-warp per row, in an order of its own."""
    _check_x(dev, x)
    if not _on_cuda(dev, x):
        return segmented_spmv_fused_reference(dev, x)
    if dev.tile != TILE_NNZ:
        raise ValueError(f"the CUDA kernel takes tile={TILE_NNZ}, plan has {dev.tile}")
    for t in (dev.cols, dev.vals):  # 4 nonzeros per step, in 16-byte loads
        if t.data_ptr() % 16:
            raise ValueError("plan tensors must be 16-byte aligned")
    if dev.nnz == 0:  # nothing to launch: y is all zeros
        return torch.zeros(dev.nrows, dtype=torch.float32, device=dev.device)
    y = torch.empty(dev.nrows, dtype=torch.float32, device=dev.device)
    _launch("csr_spmv_fused", dev, dev.ptr, dev.cols, dev.vals, dev.tile_row0,
            plan_x(dev, x), y, dev.fused_words, dev.nnz, dev.ntiles, dev.nrows, dev.tile,
            fused_lanes(dev))
    return y


def segmented_spmv_fused_reference(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """Plain K3, its tile mode's structure: plain K1's tile partials, then
    plain K2's adds in tile order, so plain K1 + K2's y bit for bit. (The
    sub-warp mode sums in another order, within the kernel bound of it.)"""
    return carry_fixup_reference(dev, *segmented_spmv_partials_reference(dev, x))


# ---------------------------------------------------------------- dispatch


@wrapper
def segmented_spmv(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x: K3 for small plans (``dev.fused``), else K1 then K2."""
    if dev.fused:
        return segmented_spmv_fused(dev, x)
    y, carry = segmented_spmv_partials(dev, x)
    return carry_fixup(dev, y, carry)

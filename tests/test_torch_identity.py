"""K7's identity mode (``kernels.panel.inverse_permute`` with ``invperm``
None; ``csrc/panel_spmv.cu``), the one epilogue of the panels that keep
their row order (ELL, HYB, unsorted SELL-C-σ), on the host, and the
containers that run it against the JAX package.

On the card it takes over two steps of those paths: the fix-up of the
split slices (what ``panel_fixup``, ``panel_fixup_multi`` and
``panel_fixup_x2`` launched before) and the torch add of the spill part's
y′. It has two grids: with a spill, one thread per row of the panel; without,
one thread per row of a split slice (the rows of whole slices untouched).
The tests here hold both to those steps, bit for bit:

* ``split_rows_mirror``, a numpy mirror of the grid without a spill, and
  ``test_torch_epilogue.k7_mirror`` at p = i for the grid with one,
  against the parent's sequence of plain versions (``parents_fixup``, the
  plain fix-up as it summed before, with ``index_add_``, then the add), the
  plain K7 and the wrapper (the CPU route), in place, with y′'s rows of
  split slices NaN, on ``probes.common.PANEL_SHAPES`` at R = 1..8 and in
  float64, and on a HYB built with the split's dispatch price at 0;
* the containers' ``matvec``, ``spmm`` and x2 ``matvec`` on such a HYB, on
  ``ell_pure`` and on an unsorted SELL against the parent's sequence, and
  against JAX and the oracle;
* the chain of every unsorted panel path: the tile kernel, the spill
  part's engine, then K7, and no ``Tensor.add_`` outside K7's plain
  version; the kernel's source: no ``panel_fixup`` kernel left, one sum of
  a split slice, and ``bounds.epilogue_bytes`` of the identity.

``test_torch_gpu.py`` and ``chip_smoke.py`` run the kernel on the card.
"""

import functools

import numpy as np
import pytest
import torch

import spmv_tpu
from spmv_tpu.oracle import container_scale, engine_rel_tol
from spmv_tpu.x2 import X2Matrix as JaxX2
import spmv_tpu_torch
from spmv_tpu_torch import X2Matrix, device, synth
from spmv_tpu_torch.formats import split as S
from spmv_tpu_torch.formats.base import SLICE_ROWS, TILE_COLS
from spmv_tpu_torch.io.mmio import MMInfo
from spmv_tpu_torch.kernels import _build
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X
from spmv_tpu_torch.kernels import panel as P
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)
from spmv_tpu_torch.probes.common import PANEL_SHAPES
from test_torch_epilogue import CSRC, body_of, calls_of, k7_mirror, shape_panel
from test_torch_spmm import check_columns
from test_torch_x2 import check_port


def parents_fixup(dev, y, part):
    """The plain fix-up as the parent summed it (plain K5, K11, K15): each
    split slice's slots gathered and summed in tile order with
    ``index_add_`` into zeros; in place on ``y``."""
    if dev.nsplit == 0 or part is None:
        return y
    s = dev.split_slices.long()
    scol = dev.slice_ptr.long() // SLICE_ROWS
    ta, tb = scol[s] // dev.tile, (scol[s + 1] - 1) // dev.tile
    counts = tb - ta + 1
    owner = torch.repeat_interleave(torch.arange(dev.nsplit), counts)
    first = torch.cumsum(counts, 0) - counts
    t = ta[owner] + torch.arange(owner.numel()) - first[owner]
    slot = 2 * t + (t == ta[owner]).long()
    acc = torch.zeros((dev.nsplit, SLICE_ROWS, *y.shape[1:]), dtype=y.dtype)
    acc.index_add_(0, owner, part[slot])
    rows = (s[:, None] * SLICE_ROWS + torch.arange(SLICE_ROWS)).reshape(-1)
    real = rows < dev.nrows
    y[rows[real]] = acc.reshape(-1, *y.shape[1:])[real]
    return y


def parents_sequence(dev, y, part, spill):
    """What an unsorted panel path did before K7 took the steps over: the
    parent's plain fix-up into a copy of y′, then the spill added in
    place."""
    y = parents_fixup(dev, y.clone(), part)
    return y if spill is None else y.add_(spill)


def split_rows_mirror(split_slices, slice_ptr, tile, y, nrows, part):
    """Host mirror of K7's grid without a spill: one row of a split slice at
    a time, in place on a copy of y′, the other rows untouched."""
    y = y.copy()
    for s in split_slices:
        cs, ce = slice_ptr[s] // SLICE_ROWS, slice_ptr[s + 1] // SLICE_ROWS
        ta, tb = cs // tile, (ce - 1) // tile
        for lane in range(SLICE_ROWS):
            if s * SLICE_ROWS + lane >= nrows:  # past the cut last slice
                continue
            v = part[2 * ta + 1, lane].copy()
            for t in range(ta + 1, tb + 1):
                v = v + part[2 * t, lane]
            y[s * SLICE_ROWS + lane] = v
    return y


def split_rows_nan(dev, y):
    """y′ with the rows of the plan's split slices NaN: neither grid reads
    them."""
    out = y.clone()
    rows = (dev.split_slices.long()[:, None] * SLICE_ROWS
            + torch.arange(SLICE_ROWS)).reshape(-1)
    out[rows[rows < dev.nrows]] = float("nan")
    return out


def check_identity(dev, x, spill):
    """Both grids against the parent's sequence, the mirrors, the plain K7
    and the wrappers, bit for bit and in place; returns the split slices'
    count."""
    y, part = P.panel_spmv_partials_reference(dev, x)
    n, sp = dev.nrows, dev.slice_ptr.numpy().astype(np.int64)
    f64 = y.dtype == torch.float64
    epilogue, fixup = ((X.inverse_permute_x2, X.panel_fixup_x2) if f64 else
                       (P.inverse_permute, P.panel_fixup_multi if y.dim() == 2
                        else P.panel_fixup))
    # without a spill: the split slices' rows alone
    want = parents_sequence(dev, y, part, None)
    mirror = split_rows_mirror(dev.split_slices.numpy(), sp, dev.tile, y.numpy(), n,
                               part.numpy())
    assert mirror.tobytes() == want.numpy().tobytes()
    for run in (lambda t: P.inverse_permute_reference(None, t, n, dev=dev, part=part),
                lambda t: epilogue(None, t, n, dev=dev, part=part),
                lambda t: fixup(dev, t, part)):
        poisoned = split_rows_nan(dev, y)
        out = run(poisoned)
        assert out.data_ptr() == poisoned.data_ptr()  # in place
        assert out.numpy().tobytes() == want.numpy().tobytes()
    # with a spill: every row, the partials or y′'s row, plus the spill
    want = parents_sequence(dev, y, part, spill)
    got, used = k7_mirror(np.arange(n), sp, dev.tile, y.numpy(), n, part.numpy(),
                          spill.numpy())
    assert got.tobytes() == want.numpy().tobytes()
    assert np.array_equal(used, np.isin(np.arange(n) // SLICE_ROWS,
                                        dev.split_slices.numpy()))
    for run in (P.inverse_permute_reference, epilogue):
        poisoned = split_rows_nan(dev, y)
        out = run(None, poisoned, n, dev=dev, part=part, spill=spill)
        assert out.data_ptr() == poisoned.data_ptr()
        assert out.numpy().tobytes() == got.tobytes()
    # no partials (K6's y′): y′ plus the spill
    out = epilogue(None, y.clone(), n, dev=dev, spill=spill)
    assert out.numpy().tobytes() == (y + spill).numpy().tobytes()
    return dev.nsplit


@pytest.mark.parametrize("R", range(1, 9))
@pytest.mark.parametrize("tile", [TILE_COLS, 3])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_k7_identity_on_the_panel_shapes(name, tile, R):
    dev, _, _ = shape_panel(name, False, tile)
    rng = np.random.default_rng(R)
    tail = () if R == 1 else (R,)
    x = torch.from_numpy(rng.standard_normal((dev.ncols, *tail)).astype(np.float32))
    spill = torch.from_numpy(rng.standard_normal((dev.nrows, *tail)).astype(np.float32))
    nsplit = check_identity(dev, x, spill)
    assert nsplit or tile == TILE_COLS


@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_k7_identity_in_float64(name):
    dev, _, _ = shape_panel(name, False, 3, np.float64)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(dev.ncols))
    spill = torch.from_numpy(rng.standard_normal(dev.nrows))
    assert check_identity(dev, x, spill)


def test_plain_fixup_is_the_parents_at_every_tile():
    """The plain fix-up (one later tile at a time) against the parent's
    (``index_add_``), on a panel whose slices span up to 1,300 tiles of
    one column."""
    dev, _, _ = shape_panel("hub_slice", False, 1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (dev.ncols, 3)).astype(np.float32))
    y, part = P.panel_spmv_partials_reference(dev, x)
    got = P.panel_fixup_reference(dev, y.clone(), part)
    assert got.numpy().tobytes() == parents_fixup(dev, y.clone(), part).numpy().tobytes()


# ---------------------------------------------------------------- containers


def hyb_forced():
    return synth.power_law(n=1024, avg_nnz_per_row=40, seed=4)


def uniform_rows(n=1024, k=40, seed=0):
    """Rows of ``k`` elements each: a SELL the σ-sort leaves unsorted."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), k)
    info = MMInfo("matrix", "coordinate", "real", "general", n, n, r.size)
    return info, r, rng.integers(0, n, r.size), rng.standard_normal(r.size)


# unsorted panel builds: (matrix, format, split, dispatch price zeroed, fused
# plan bound: 0 never, 1 << 40 always), each with the parts it must have
# (a spill part, split slices, K6)
UNSORTED = {
    "hyb_spill": (hyb_forced, "hyb", True, True, 0),
    "ell_spill": (hyb_forced, "ell", True, True, 0),
    "hyb_fused": (hyb_forced, "hyb", True, True, 1 << 40),
    "ell_pure": (uniform_rows, "ell", False, False, 0),
    "sell_unsorted": (uniform_rows, "sell", True, False, 0),
}


def unsorted_build(name, monkeypatch, x2=False):
    gen, fmt, split, free, fused_max = UNSORTED[name]
    monkeypatch.setattr(S, "_DISPATCH_S", 0.0 if free else S._DISPATCH_S)
    monkeypatch.setattr(device, "FUSED_STREAM_BYTES_MAX", fused_max)
    info, r, c, v = gen()
    kw = {} if fmt == "hyb" else {"split": split}  # HYB is the split
    if x2:
        v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
        a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu",
                              **kw)
    else:
        a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu",
                                    **kw)
    assert not getattr(a, "sorted_rows", False)
    assert (a.dev_spill is not None) == free and a.dev.nsplit
    if not x2:
        assert a.dev.fused == name.endswith("_fused")
    return a, (info, r, c, v)


@pytest.mark.parametrize("name", sorted(UNSORTED))
def test_unsorted_paths_are_the_parents_sequence(name, monkeypatch):
    """``matvec`` (R = 1), ``spmm`` at R = 2..8 and the x2 ``matvec``: the
    tile kernel's y′ and partials (K6's y′ on a small plan), the parent's
    plain fix-up, the spill added, bit for bit."""
    a, (info, r, c, v) = unsorted_build(name, monkeypatch)
    rng = np.random.default_rng(9)
    for R in range(1, 9):
        shape = (info.ncols,) if R == 1 else (info.ncols, R)
        xs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if a.dev.fused and R == 1:
            y, part = P.panel_spmv_fused(a.dev, xs), None
        else:
            y, part = P.panel_spmv_partials_reference(a.dev, xs)
        spill = None
        if a.dev_spill is not None:
            spill = (E.segmented_spmv(a.dev_spill, xs) if R == 1
                     else E.segmented_spmv_multi(a.dev_spill, xs))
        want = parents_sequence(a.dev, y, part, spill)[:info.nrows]
        got = a.matvec(xs) if R == 1 else spmv_tpu_torch.spmm(a, xs.numpy())
        assert got.numpy().tobytes() == want.numpy().tobytes(), R
    if a.dev.fused:
        return
    b, _ = unsorted_build(name, monkeypatch, x2=True)
    x = torch.from_numpy(rng.standard_normal(info.ncols))
    y, part = P.panel_spmv_partials_reference(b.dev, x)
    spill = X.segmented_spmv_x2(b.dev_spill, x) if b.dev_spill is not None else None
    want = parents_sequence(b.dev, y, part, spill)[:info.nrows]
    assert b.matvec(x).numpy().tobytes() == want.numpy().tobytes()


@functools.cache
def jax_of(name, x2=False):
    gen, fmt, split = UNSORTED[name][:3]
    info, r, c, v = gen()
    if x2:
        v = np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(r.size))
        return JaxX2.from_coo(fmt, info.nrows, info.ncols, r, c, v)
    kw = {} if fmt == "hyb" else {"split": split}
    return spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v, **kw)


@pytest.mark.parametrize("name", ["hyb_spill", "ell_pure", "sell_unsorted"])
def test_unsorted_paths_match_jax(name, monkeypatch):
    """``matvec``, ``spmm`` at R = 4 and the x2 ``matvec`` on the K7
    identity paths against JAX's containers in interpret mode and the
    oracle, within the tolerances of ``test_torch_formats.py``,
    ``test_torch_spmm.py`` and ``test_torch_x2.py``."""
    ref = jax_of(name)
    a, (info, r, c, v) = unsorted_build(name, monkeypatch)
    x = np.random.default_rng(7).standard_normal(info.ncols).astype(np.float32)
    y, y_jax = a.matvec(x).numpy(), np.asarray(ref.matvec(x))
    k = int(np.bincount(r, minlength=info.nrows).max())
    row_abs = row_scale(info.nrows, r, c, v, x)
    assert kernel_check(golden_spmv(info.nrows, r, c, v, x), y, row_abs, k).ok
    bound = (2 * KERNEL_TOL_ABS + fp32_rel_tol(k) * row_abs
             + engine_rel_tol(k) * container_scale(ref, x, row_abs))
    assert (np.abs(y.astype(np.float64) - y_jax) <= bound).all()
    Xh = np.random.default_rng(8).standard_normal((info.ncols, 4)).astype(np.float32)
    check_columns(spmv_tpu_torch.spmm(a, Xh).numpy(), np.asarray(spmv_tpu.spmm(ref, Xh)),
                  ref, info, r, c, v, Xh)
    b, (_, _, _, v64) = unsorted_build(name, monkeypatch, x2=True)
    x64 = np.random.default_rng(9).standard_normal(info.ncols)
    check_port(b.matvec(x64), info, r, c, v64, x64, np.asarray(jax_of(name, True).matvec(x64)))


# ---------------------------------------------------------------- the chain


@pytest.mark.parametrize("name", sorted(UNSORTED))
def test_unsorted_paths_run_the_tile_kernel_the_spill_then_k7(name, monkeypatch):
    """matvec: K4 (K6 on a small plan), the spill's engine, then K7 given
    no row order (``inverse_permute`` with a spill, ``panel_fixup``, its
    grid without one); spmm: K10, the spill's, K7 (``panel_fixup_multi``
    without a spill); the x2 matvec: K14, the spill's, K7 in float64
    (``panel_fixup_x2`` without a spill). No ``Tensor.add_`` runs outside
    K7 (its plain version is the CPU route)."""
    a, (info, r, c, v) = unsorted_build(name, monkeypatch)
    calls = calls_of(monkeypatch, P, ("panel_spmv_partials", "panel_spmv_fused",
                                      "panel_spmv_multi_partials"))
    monkeypatch.setattr(X, "panel_spmv_x2_partials", lambda *args, _o=X.panel_spmv_x2_partials:
                        calls.append("panel_spmv_x2_partials") or _o(*args))
    inside = [0]  # K7's wrappers running

    def record(mod, fn, identity=False):
        orig = getattr(mod, fn)

        def wrapper(*args, **kw):
            calls.append(fn)
            assert not identity or args[0] is None  # no row order
            inside[0] += 1
            try:
                return orig(*args, **kw)
            finally:
                inside[0] -= 1
        monkeypatch.setattr(mod, fn, wrapper)

    for fn in ("inverse_permute", "panel_fixup", "panel_fixup_multi"):
        record(P, fn, identity=fn == "inverse_permute")
    record(X, "inverse_permute_x2", identity=True)
    record(X, "panel_fixup_x2")
    for mod, fn in ((P, "segmented_spmv"), (P, "segmented_spmv_multi"),
                    (X, "segmented_spmv_x2")):
        monkeypatch.setattr(mod, fn, lambda *args, _o=getattr(mod, fn):
                            calls.append("spill") or _o(*args))
    add_ = torch.Tensor.add_

    def counted_add_(self, *args, **kw):
        if not inside[0]:
            calls.append("add_")
        return add_(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "add_", counted_add_)
    spill = a.dev_spill is not None
    a.matvec(np.ones(info.ncols))
    tiles = "panel_spmv_fused" if a.dev.fused else "panel_spmv_partials"
    assert calls == ([tiles, "spill", "inverse_permute"] if spill else
                     [tiles] if a.dev.fused else [tiles, "panel_fixup"])
    calls.clear()
    spmv_tpu_torch.spmm(a, np.ones((info.ncols, 4)))
    assert calls == ["panel_spmv_multi_partials",
                     *(["spill", "inverse_permute"] if spill else ["panel_fixup_multi"])]
    if a.dev.fused:
        return
    b, _ = unsorted_build(name, monkeypatch, x2=True)
    calls.clear()
    b.matvec(np.ones(info.ncols))
    assert calls == ["panel_spmv_x2_partials",
                     *(["spill", "inverse_permute_x2"] if spill else ["panel_fixup_x2"])]


def test_identity_wrappers_refuse_mismatched_inputs():
    dev, _, _ = shape_panel("hub_slice", False, TILE_COLS)
    y, part = P.panel_spmv_partials_reference(dev, torch.ones(dev.ncols))
    with pytest.raises(ValueError, match="do not match"):
        P.inverse_permute(None, y, dev.nrows - 1, dev=dev, part=part)
    with pytest.raises(ValueError, match="plan they belong to"):
        P.inverse_permute(None, y, dev.nrows, part=part)
    with pytest.raises(ValueError, match="spill"):
        P.inverse_permute(None, y, dev.nrows, dev=dev, part=part, spill=y[:-1])
    with pytest.raises(ValueError, match="y or part does not match"):
        P.panel_fixup(dev, y[:-1], part)
    with pytest.raises(ValueError, match="Y or part does not match"):
        P.panel_fixup_multi(dev, y, part)
    with pytest.raises(ValueError, match="plan holds torch.float32"):
        X.panel_fixup_x2(dev, y.double(), part.double())
    with pytest.raises(ValueError, match="float64 K7 takes one column"):
        X.inverse_permute_x2(None, torch.zeros(dev.nrows, 2, dtype=torch.float64),
                             dev.nrows)


# ---------------------------------------------------------------- the source


def test_no_fixup_kernel_is_left_and_the_sum_rule_lives_once():
    """``panel_spmv.cu`` defines no ``panel_fixup`` kernel or entry point,
    ``_build`` declares none and ``engines.LAUNCHES`` counts none; the
    split slices' slot order (the tail slot of the first tile, then the
    head slots) is written once in the sources, in ``split_slot``, which
    ``sum_split_row`` (K7's sum, which the kernel's body calls once for all
    three grids) and K6's tile mode read."""
    src = (CSRC / "panel_spmv.cu").read_text()
    assert "panel_fixup" not in src
    assert not [k for k in _build.SIGNATURES if k.startswith("panel_fixup")]
    assert not [k for k in E.LAUNCHES if k.startswith("panel_fixup")]
    sources = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    assert sources.count("int split_slot(") == 1
    assert src.count("2 * ta + 1") == 1
    slot = body_of(src, "int split_slot(int t, int ta)")
    assert "t == ta ? 2 * ta + 1 : 2 * t" in slot
    assert sources.count("void sum_split_row(") == 1
    rule = body_of(src, "void sum_split_row(const T* part")
    assert "split_slot(ta, ta)" in rule and "split_slot(t, ta)" in rule
    body = body_of(src, "inverse_permute_kernel(const int*")
    assert body.count("sum_split_row<R>(") == 1


@pytest.mark.parametrize("tile", [TILE_COLS, 3])
@pytest.mark.parametrize("name", sorted(PANEL_SHAPES))
def test_epilogue_bytes_of_the_identity(name, tile):
    """``bounds.epilogue_bytes`` with no row order, against a count row by
    row: slice_ptr, the partial slots of a split slice's row or y′'s row,
    the spill's row and y's row written, no invperm; without a spill the
    split slices' grid, ``panel_fixup_bytes``."""
    from spmv_tpu_torch.probes import bounds as B

    for dtype in (np.float32, np.float64):
        dev, _, n = shape_panel(name, False, tile, dtype)
        es = np.dtype(dtype).itemsize
        sp = dev.slice_ptr.numpy().astype(np.int64)
        slots = 0
        for p in range(dev.nrows):
            cs, ce = sp[p // SLICE_ROWS] // SLICE_ROWS, sp[p // SLICE_ROWS + 1] // SLICE_ROWS
            split = ce > cs and cs // tile != (ce - 1) // tile
            slots += (ce - 1) // tile - cs // tile + 1 if split else 1
        for R in (1, 3):
            want = sp.size * 4 + (slots + 2 * dev.nrows) * es * R
            assert B.epilogue_bytes(dev, None, dev.nrows, R, spill=True) == want
            assert (B.epilogue_bytes(dev, None, dev.nrows, R)
                    == B.panel_fixup_bytes(dev, R))

"""Two checkouts' tile kernels, timed in turns on one card.

    python -m spmv_tpu_torch.probes.turns OTHER_ROOT [OTHER_ROOT ...]
        [--out DIR] [--only seg|panel|spmm|sorted|fused] [--probe NAME:MATRIX ...]
        [--rounds N]

Measures a change to the segmented tile kernel K1/K12/K8 and its fix-ups
(``kernels/csrc/seg_tile.cuh``) or the panel tile kernel K4/K14/K10
(``kernels/csrc/panel_tile.cuh``) against another checkout of the
repository (the commit it changes, unpacked with ``git archive``) in one
run on one card, in turns: OTHER, THIS, THIS, OTHER. With several other
checkouts (variants of one design) each runs twice too, in the order
OTHER, OTHER2, ..., THIS, THIS, ..., OTHER2, OTHER, and every time is
also given against the first. Each turn is a fresh
process that imports ``spmv_tpu_torch`` from one checkout, so it builds and
launches that checkout's kernels through that checkout's wrappers, and
(``--only`` keeps one of the four engines):

* runs K1 and K12 on cant, ``pl_big``, ``pl_wide`` and band-1024, and K4
  and K14 on the SELL panels of cant (as the split builds it), pl-32768
  and ``pl_big`` (whole), ``common.PANEL_SPLIT`` (the probes'
  ``common.MATRICES``, named to the worker by generator and arguments, so an
  older checkout builds the same ones; x from a seed), and saves their y and
  carries or partials as ``.npy`` under ``DIR/<turn>-<checkout>/``; with
  the panel engine also K4's and K14's y and partials on the whole ELL
  panels of ``common.PANEL_SHAPES`` (handed to the worker as triplets in
  ``DIR/shapes/``, which an older checkout has no generator for; untimed);
* with the ``spmm`` engine, the multi-RHS kernels at each R of
  ``SPMM_RHS`` on the same matrices and panels: K8 on the CSR plans, K10
  on the SELL and the shapes' ELL panels, their Y and carries or partials
  saved;
* times each tile kernel and its path with the fix-up (K1 + K2, K12 + K13,
  K8 + K9; K4, K14 and K10 with each checkout's ``panel_fixup``,
  ``panel_fixup_x2`` and ``panel_fixup_multi``: K7's identity mode here,
  K5, K15 and K11 in a checkout from before it; ``timing.graph_ms``: CUDA-graph
  replay, warm), and cuSPARSE on the same matrix's CSR plan in float32
  and float64 (``torch.sparse_csr_tensor @ x``, ``@ X`` for R columns, a
  yardstick the port never calls), beside each kernel's HBM-peak bound
  (``bounds``), and, where the checkout has them, the launch floor
  (``kernels.probes.launch_floor``, a kernel that does nothing) and K1 with
  K2 folded into its last block (``kernels.probes.segmented_spmv_fold``,
  its y checked against K1 + K2's bit for bit);
* with the ``panel`` and ``spmm`` engines, the public calls on the panels
  of ``UNSORTED_BUILDS``, which keep their row order (pl-32768's
  ``ell_pure``; its HYB and ELL split and cant's HYB under
  ``forced_split``: the tile kernel, the spill's K1 + K2, the epilogue): ``matvec`` and the
  fp64-grade ``X2Matrix.matvec`` with ``panel``, ``spmm`` at each R of
  ``SPMM_RHS`` with ``spmm``, each timed by graph replay and its output
  saved;
* with the ``sorted`` engine, the public calls on the σ-sorted SELL
  builds of ``SORTED_BUILDS`` (cant, pl-32768 and ``pl_big`` whole, and
  pl-32768 with a spill part, under ``forced_split``: K4, K1 + K2, K7):
  ``SellMatrix.matvec``, ``spmm`` at each R of
  ``SPMM_RHS`` and the fp64-grade ``X2Matrix.matvec``, each timed by graph
  replay and its output saved, so that a change to the sorted path's chain
  (K4, K10, K14, the spill's kernels and K7) is held to the other
  checkout's bits; the same calls, untimed, on ``common.PANEL_SHAPES`` as
  σ-sorted SELL panels (σ = 128) on K4's partials;
* with the ``fused`` engine, on the plans of ``FUSED_TURN_MATRICES`` (the
  sweep of the one-dispatch threshold in ``chip_smoke.py``), the
  one-dispatch K3 (``segmented_spmv_fused``) beside K1 alone, K1 + K2 and
  cuSPARSE, each by graph replay, and K3's HBM-peak bound
  (``bounds.fused_bytes``); K1 + K2's y is saved, and whether K3's y is
  K1 + K2's bit for bit (and by how much it differs) is kept per turn, since
  a K3 of another design may sum in another order; and on the whole SELL
  panels of ``PANEL_FUSED_TURN_MATRICES`` (K6's sweep) the one-dispatch K6
  (``panel_spmv_fused``) beside K4 + its fix-up, by graph replay, with K6's
  bound; K4 + fix-up's y is saved, and so is K6's where no slice is wider
  than ``specs["k6_cap"]`` (a warp per slice in both checkouts, so bit for
  bit), while elsewhere whether K6's y is K4 + fix-up's is kept per turn;
* then runs each ``--probe NAME:MATRIX`` (``python -m spmv_tpu_torch.probes``)
  in that checkout, its output saved beside the arrays.

A segmented carry is saved with the slots no split row uses set to 0:
the tile kernel does not write them (``engines.carry_slot_rows``). At the
end every saved output is compared bit for bit across all turns, and each
time is printed as the median of its checkout's two turns, with the
card's name and power limit; ``DIR/turns.json`` keeps all of it. Exits 1
without a card, and when two outputs differ.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

THIS_ROOT = Path(__file__).resolve().parents[2]

# the probes' matrices (``common.MATRICES``) each turn runs K1 and K12 on
TURN_MATRICES = ("cant", "pl_big", "pl_wide", "band")
# and those whose SELL panels it runs K4 and K14 on
PANEL_TURN_MATRICES = ("cant", "pl", "pl_big")
# the right-hand sides the spmm engine runs K8 and K10 at
SPMM_RHS = (2, 4, 8)
# the plans the fused engine times K3 on: chip_smoke.py's sweep of the
# one-dispatch threshold, the ones under it first
FUSED_TURN_MATRICES = ("entry", "band", "pl", "cant_8192", "pl_wide_32768",
                       "cant_16384")
# and the whole SELL panels it times K6 on: K6's sweep in chip_smoke.py,
# the regular panels first
PANEL_FUSED_TURN_MATRICES = ("entry", "band", "cant_4096", "cant_8192", "pl_2048",
                             "pl_4096", "pl_8192", "pl_16384", "pl_cap16_16384",
                             "pl_cap96_16384")
# the σ-sorted SELL containers the sorted engine times through the public
# calls: name → (matrix of ``common.MATRICES``, split, forced): cant as the
# split builds it (a pure sorted panel), pl-32768 and ``pl_big`` whole
# (bench.py's ``sell_pure``), and pl-32768 split and called under
# ``forced_split(**SPILL_PRICES)``, which makes it keep a sorted panel,
# spill the hub rows' tails and run K4, the spill's K1 + K2, then K7 (not
# the one-dispatch K6 and K3): the path with a spill part, which the priced
# split gives none of these matrices
SORTED_BUILDS = {"cant": ("cant", True, False), "pl": ("pl", False, False),
                 "pl_big": ("pl_big", False, False), "pl_hyb": ("pl", True, True)}
# the split's dispatch price and the one-dispatch bound set to 0
SPILL_PRICES = {"dispatch_s": 0.0, "fused_max": 0}
# the panels that keep their row order whose public calls the panel and
# spmm engines time: name → (matrix of ``common.MATRICES``, format, split,
# forced): bench.py's ``ell_pure`` on pl-32768 (the tile kernel, then its
# fix-up), and the HYB and split ELL of pl-32768 and the HYB of cant built
# and called under ``forced_split(**SPILL_PRICES)``, which keeps a panel and
# a spill part on their tile kernels (the tile kernel, the spill's K1 + K2,
# the epilogue; cant's panel has split slices, pl-32768's one column none)
UNSORTED_BUILDS = {"pl_ell_pure": ("pl", "ell", False, False),
                   "pl_hyb": ("pl", "hyb", True, True),
                   "pl_ell_spill": ("pl", "ell", True, True),
                   "cant_hyb": ("cant", "hyb", True, True)}


@contextlib.contextmanager
def forced_split(dispatch_s: float | None = None, fused_max: int | None = None):
    """Runs its body with the split's dispatch price
    (``formats.split._DISPATCH_S``) and the one-dispatch bound
    (``device.FUSED_STREAM_BYTES_MAX``) set as given (None keeps one), and
    restores both: a dispatch price of 0 makes the split keep a σ-sorted
    panel and spill the long rows' tails, and a bound of 0 keeps a plan on
    its tile kernel and fix-up. The bound is read at each call, so a call
    that should run as built runs inside it too. ``chip_smoke.py``, the
    ``gpu`` tests and the turns worker (in any checkout: both globals
    predate the port's sorted path) force a build so."""
    from spmv_tpu_torch import device as D
    from spmv_tpu_torch.formats import split as S

    saved = S._DISPATCH_S, D.FUSED_STREAM_BYTES_MAX
    if dispatch_s is not None:
        S._DISPATCH_S = dispatch_s
    if fused_max is not None:
        D.FUSED_STREAM_BYTES_MAX = fused_max
    try:
        yield
    finally:
        S._DISPATCH_S, D.FUSED_STREAM_BYTES_MAX = saved


def matrix_specs(names=TURN_MATRICES) -> dict:
    """name → [generator in ``spmv_tpu_torch.synth``, its keyword
    arguments] of ``common.MATRICES``: what a worker in another checkout,
    whose table may lack a name, builds the same matrices from."""
    from spmv_tpu_torch.probes.common import MATRICES

    return {n: [MATRICES[n].func.__name__, MATRICES[n].keywords] for n in names}


def _x2_vals(v: np.ndarray) -> np.ndarray:
    """fp64 values with content below float32's mantissa."""
    return v * (1 + 1e-9 * np.arange(v.size) / max(v.size, 1))


def shape_specs(out: Path) -> dict:
    """name → the ``.npz`` under ``out/shapes/`` holding the triplets of
    each ``common.PANEL_SHAPES`` case (seed 0): what a worker in another
    checkout, which may lack the generators, builds the shapes from."""
    from spmv_tpu_torch.probes.common import PANEL_SHAPES

    (out / "shapes").mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, build in PANEL_SHAPES.items():
        info, r, c, v = build()
        paths[name] = str(out / "shapes" / f"{name}.npz")
        np.savez(paths[name], shape=[info.nrows, info.ncols], r=r, c=c, v=v)
    return paths


def _unused_slots(dev) -> np.ndarray:
    """The carry slots of a CSR plan that no split row uses: what
    ``engines.carry_slot_rows`` marks -1, computed here on the host
    because the worker may run in a checkout that lacks it."""
    ptr = dev.ptr.cpu().numpy().astype(np.int64)
    r = dev.carry_rows.cpu().numpy().astype(np.int64)
    ta, tb = ptr[r] // dev.tile, (ptr[r + 1] - 1) // dev.tile
    used = np.zeros(2 * dev.ntiles, bool)
    used[2 * ta + 1] = True
    for a, b in zip(ta, tb):
        used[2 * np.arange(a + 1, b + 1)] = True
    return ~used


def _worker(out_dir: Path, specs: dict) -> dict:
    """One turn, in a process whose ``spmv_tpu_torch`` is the checkout in
    the working directory: at each R of ``specs["rhs"]`` (1: K1 and K12,
    K4 and K14; 2-8: K8, K10) the segmented kernels on the matrices of
    ``specs["seg"]``, the panel kernels on the SELL panels of
    ``specs["panel"]`` (each ``matrix_specs``, a panel's with its split)
    and on the ELL panels of ``specs["shapes"]`` (``shape_specs``), the
    outputs saved, the times returned."""
    import torch

    import spmv_tpu_torch
    from spmv_tpu_torch import synth
    from spmv_tpu_torch.device import DevCsr
    from spmv_tpu_torch.formats.base import build_csr_plan, csr_ptr
    from spmv_tpu_torch.kernels import engines as E
    from spmv_tpu_torch.kernels import engines_x2 as X2
    from spmv_tpu_torch.kernels import panel as P
    from spmv_tpu_torch.kernels import probes as KP
    from spmv_tpu_torch.probes import bounds as B
    from spmv_tpu_torch.probes.timing import card_line, graph_ms

    out_dir.mkdir(parents=True, exist_ok=True)
    dtypes = {"f32": np.float32, "f64": np.float64}
    kernels = {"f32": (E.segmented_spmv_partials, E.carry_fixup),
               "f64": (X2.segmented_spmv_x2_partials, X2.carry_fixup_x2),
               "multi": (E.segmented_spmv_multi_partials, E.carry_fixup_multi)}
    panels = {"f32": (P.panel_spmv_partials, P.panel_fixup),
              "f64": (X2.panel_spmv_x2_partials, X2.panel_fixup_x2),
              "multi": (P.panel_spmv_multi_partials, P.panel_fixup_multi)}
    rhs = specs.pop("rhs")
    multi = [R for R in rhs if R > 1]
    keys = [k for k in dtypes if 1 in rhs or (k == "f32" and multi)]
    res = {"card": card_line(), "package": spmv_tpu_torch.__file__, "ms": {}}
    ms = res["ms"]

    def save(label, key, y, part, unused=None):
        stem = f"{label.replace(' ', '_')}_{key}"
        part = part.cpu().numpy()
        if unused is not None:
            part[unused] = 0
        np.save(out_dir / f"{stem}_y.npy", y.cpu().numpy())
        np.save(out_dir / f"{stem}_part.npy", part)

    fold = getattr(KP, "segmented_spmv_fold", None)

    def time_tiles(label, key, dev, x, tiles, fixup, tiles_bytes, nnz, A, R=1):
        dtype = dev.vals.dtype
        save(label, key, *tiles(dev, x),
             unused=_unused_slots(dev) if isinstance(dev, DevCsr) else None)
        ms[f"{label} {key} tiles"] = graph_ms(lambda: tiles(dev, x))
        ms[f"{label} {key} path"] = graph_ms(lambda: fixup(dev, *tiles(dev, x)))
        if fold is not None and key == "f32" and isinstance(dev, DevCsr):
            # K1 + K2 in one launch, where the checkout has the probe: its y
            # must be the path's, bit for bit
            if not torch.equal(fold(dev, x), fixup(dev, *tiles(dev, x))):
                raise AssertionError(f"{label}: the folded K1 + K2 is not K1 + K2's bits")
            ms[f"{label} {key} fold"] = graph_ms(lambda: fold(dev, x))
        ms[f"{label} {key} cusparse"] = graph_ms(lambda: A @ x)
        ms[f"{label} {key} tiles bound"] = B.bound_ms(tiles_bytes, 2 * nnz * R, dtype)[0]
        ms[f"{label} {key} path bound"] = B.bound_ms(B.csr_spmv_bytes(dev, R),
                                                     2 * nnz * R, dtype)[0]

    def vector(n, np_dtype, R=None):
        shape = (n,) if R is None else (n, R)
        xh = np.random.default_rng(3).standard_normal(shape).astype(np_dtype)
        return torch.from_numpy(xh).cuda()

    def sorted_sell(name, nrows, ncols, r, c, v, split, spill, **kw):
        """The float32 and fp64-grade SELL of the triplets, σ-sorted, with
        a spill part or without, as ``spill`` says."""
        args = ("sell", nrows, ncols, r, c)
        a = spmv_tpu_torch.from_coo(*args, v, split=split, device="cuda", **kw)
        a2 = spmv_tpu_torch.X2Matrix.from_coo(
            *args, _x2_vals(np.asarray(v, np.float64)), split=split, device="cuda", **kw)
        if not (a.sorted_rows and a2.sorted_rows) or (a.dev_spill is not None) != spill:
            raise AssertionError(f"{name}: not the sorted SELL asked for")
        return a, a2

    def sorted_calls(label, a, a2, ncols, timed):
        """The public calls on a sorted SELL, float32 and fp64-grade:
        matvec, spmm at each R of SPMM_RHS, the x2 matvec; their outputs
        saved and, with ``timed``, their times by graph replay."""
        calls = {"f32": (a.matvec, vector(ncols, np.float32)),
                 "f64": (a2.matvec, vector(ncols, np.float64))}
        calls.update({f"R{R}": (lambda X: spmv_tpu_torch.spmm(a, X),
                                vector(ncols, np.float32, R)) for R in SPMM_RHS})
        for key, (fn, x) in calls.items():
            np.save(out_dir / f"{label.replace(' ', '_')}_{key}_y.npy", fn(x).cpu().numpy())
            if timed:
                ms[f"{label} {key} call"] = graph_ms(lambda fn=fn, x=x: fn(x))
        torch.cuda.synchronize()

    for name, (gen, kwargs, fmt, split, forced) in specs.pop("unsorted", {}).items():
        # the public calls on a panel that keeps its row order
        info, r, c, v = getattr(synth, gen)(**kwargs)
        kw = {} if fmt == "hyb" else {"split": split}
        with forced_split(**(SPILL_PRICES if forced else {})):
            a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v,
                                        device="cuda", **kw)
            a2 = spmv_tpu_torch.X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c,
                                                  _x2_vals(np.asarray(v, np.float64)),
                                                  device="cuda", **kw)
            if (a.dev_spill is not None) != forced or a.dev.fused:
                raise AssertionError(f"{name}: not the panel asked for")
            calls = {}
            if 1 in rhs:
                calls = {"f32": (a.matvec, vector(info.ncols, np.float32)),
                         "f64": (a2.matvec, vector(info.ncols, np.float64))}
            calls.update({f"R{R}": (lambda X: spmv_tpu_torch.spmm(a, X),
                                    vector(info.ncols, np.float32, R)) for R in multi})
            for key, (fn, x) in calls.items():
                np.save(out_dir / f"{name}_unsorted_{key}_y.npy", fn(x).cpu().numpy())
                ms[f"{name} unsorted {key} call"] = graph_ms(lambda fn=fn, x=x: fn(x))
            torch.cuda.synchronize()
        del a, a2
    for name, (gen, kwargs, split, forced) in specs.pop("sorted", {}).items():
        info, r, c, v = getattr(synth, gen)(**kwargs)
        with forced_split(**(SPILL_PRICES if forced else {})):
            a, a2 = sorted_sell(name, info.nrows, info.ncols, r, c, v, split, forced)
            sorted_calls(f"{name} sorted", a, a2, info.ncols, timed=True)
        del a, a2
    for name, path in specs.pop("sorted_shapes", {}).items():
        # the panel shapes as whole SELL panels (σ = 128), on K4's partials
        # (the one-dispatch K6 bound set to 0), untimed
        z = np.load(path)
        nrows, ncols = (int(n) for n in z["shape"])
        with forced_split(fused_max=0):
            a, a2 = sorted_sell(name, nrows, ncols, z["r"], z["c"], z["v"], False, False,
                                sigma=128)
            sorted_calls(f"{name} sorted shape", a, a2, ncols, timed=False)
    for name, path in specs.pop("shapes", {}).items():
        z = np.load(path)
        nrows, ncols = (int(n) for n in z["shape"])
        for key in keys:
            np_dtype = dtypes[key]
            vals = z["v"] if key == "f32" else _x2_vals(z["v"])
            make = (spmv_tpu_torch.from_coo if key == "f32" else
                    spmv_tpu_torch.X2Matrix.from_coo)
            a = make("ell", nrows, ncols, z["r"], z["c"], vals, split=False,
                     device="cuda")
            if 1 in rhs:
                save(f"{name} shape", key, *panels[key][0](a.dev, vector(ncols, np_dtype)))
            for R in multi if key == "f32" else ():
                save(f"{name} shape", f"R{R}",
                     *panels["multi"][0](a.dev, vector(ncols, np_dtype, R)))
    floor = getattr(KP, "launch_floor", None)
    if floor is not None:
        ms["launch floor"] = graph_ms(lambda: floor("cuda"))
    res["fused_bits"] = {}
    for name, (gen, kwargs) in specs.pop("fused", {}).items():
        # K3 beside K1, K1 + K2 and cuSPARSE on one plan of the sweep
        info, r, c, v = getattr(synth, gen)(**kwargs)
        order = np.lexsort((c, r))
        dev = DevCsr.from_plan(build_csr_plan(
            info.nrows, info.ncols, csr_ptr(r[order], info.nrows), c[order],
            np.asarray(v, np.float64)[order], dtype=np.float32), "cuda")
        A = torch.sparse_csr_tensor(dev.ptr, dev.source_cols(), dev.vals,
                                    (dev.nrows, dev.ncols))
        x = vector(info.ncols, np.float32)
        tiles, fixup = kernels["f32"]
        y12 = fixup(dev, *tiles(dev, x))
        y3 = E.segmented_spmv_fused(dev, x)
        np.save(out_dir / f"{name}_fused_path_y.npy", y12.cpu().numpy())
        res["fused_bits"][name] = {
            "equal": bool(torch.equal(y3, y12)),
            "max_abs": float((y3.double() - y12.double()).abs().max()),
            "plan_bytes": dev.stream_bytes, "fused": dev.fused}
        ms[f"{name} fused K3"] = graph_ms(lambda: E.segmented_spmv_fused(dev, x))
        ms[f"{name} fused K1"] = graph_ms(lambda: tiles(dev, x))
        ms[f"{name} fused K1+K2"] = graph_ms(lambda: fixup(dev, *tiles(dev, x)))
        ms[f"{name} fused cusparse"] = graph_ms(lambda: A @ x)
        ms[f"{name} fused K3 bound"] = B.bound_ms(B.fused_bytes(dev), 2 * dev.nnz)[0]
        del dev, A
        torch.cuda.synchronize()
    res["panel_fused_bits"] = {}
    k6_cap = specs.pop("k6_cap", 0)
    for name, (gen, kwargs) in specs.pop("panel_fused", {}).items():
        # K6 beside K4 + its fix-up on one whole SELL panel of K6's sweep
        info, r, c, v = getattr(synth, gen)(**kwargs)
        a = spmv_tpu_torch.from_coo("sell", info.nrows, info.ncols, r, c, v, split=False,
                                    device="cuda")
        dev, x = a.dev, vector(info.ncols, np.float32)
        tiles, fixup = panels["f32"]
        y47 = fixup(dev, *tiles(dev, x))
        y6 = P.panel_spmv_fused(dev, x)
        np.save(out_dir / f"{name}_panel_fused_path_y.npy", y47.cpu().numpy())
        if dev.max_width <= k6_cap:
            np.save(out_dir / f"{name}_panel_fused_K6_y.npy", y6.cpu().numpy())
        res["panel_fused_bits"][name] = {
            "equal": bool(torch.equal(y6, y47)),
            "max_abs": float((y6.double() - y47.double()).abs().max()),
            "plan_bytes": dev.stream_bytes, "max_width": dev.max_width}
        ms[f"{name} panel K6"] = graph_ms(lambda: P.panel_spmv_fused(dev, x))
        ms[f"{name} panel K4+fixup"] = graph_ms(lambda: fixup(dev, *tiles(dev, x)))
        ms[f"{name} panel K6 bound"] = B.bound_ms(B.panel_fused_bytes(dev),
                                                  2 * a.panel_nnz)[0]
        del a, dev
        torch.cuda.synchronize()
    for engine, named in specs.items():
        for name, (gen, kwargs, *split) in named.items():
            info, r, c, v = getattr(synth, gen)(**kwargs)
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], np.asarray(v, np.float64)[order]
            ptr = csr_ptr(r, info.nrows)
            for key in keys:
                np_dtype = dtypes[key]
                vals = v if key == "f32" else _x2_vals(v)
                dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, ptr, c, vals,
                                                      dtype=np_dtype), "cuda")
                A = torch.sparse_csr_tensor(dev.ptr, dev.source_cols(), dev.vals,
                                            (dev.nrows, dev.ncols))
                if engine == "seg":
                    label, d, fns, nnz, tb = name, dev, kernels, dev.nnz, B.seg_tiles_bytes
                else:
                    args = ("sell", info.nrows, info.ncols, r, c, vals)
                    a = (spmv_tpu_torch.from_coo(*args, split=split[0], device="cuda")
                         if key == "f32" else
                         spmv_tpu_torch.X2Matrix.from_coo(*args, split=split[0],
                                                          device="cuda"))
                    label, d, fns, nnz, tb = (f"{name} panel", a.dev, panels,
                                              a.panel_nnz, B.panel_tiles_bytes)
                if 1 in rhs:
                    time_tiles(label, key, d, vector(info.ncols, np_dtype), *fns[key],
                               tb(d, 1), nnz, A)
                for R in multi if key == "f32" else ():
                    time_tiles(label, f"R{R}", d, vector(info.ncols, np_dtype, R),
                               *fns["multi"], tb(d, R), nnz, A, R)
                del dev, A, d
            torch.cuda.synchronize()
    return res


def run_specs(only: str | None, out: Path) -> dict:
    """What each turn's worker runs for ``--only`` (None: everything):
    ``rhs``, the R of each kernel (1 for the seg and panel engines,
    ``SPMM_RHS`` for spmm); ``seg``, the matrices of the segmented
    kernels; ``panel``, those of the panel kernels with their split;
    ``shapes``, the panel shapes' triplets, written under ``out``;
    ``unsorted``, the panels of ``UNSORTED_BUILDS`` whose public calls the
    panel and spmm engines time; ``sorted``, the sorted SELL builds
    (``SORTED_BUILDS``) whose public calls the sorted engine times, and
    ``sorted_shapes``, the panel shapes' triplets, which it runs as sorted
    SELL panels, untimed; ``fused``, the plans the fused engine times K3
    on (``FUSED_TURN_MATRICES``)."""
    from spmv_tpu_torch.probes.common import PANEL_SPLIT

    engines = {"seg", "panel", "spmm", "sorted", "fused"} if only is None else {only}
    rhs = [1] * bool(engines & {"seg", "panel"}) + list(SPMM_RHS) * ("spmm" in engines)
    specs = {"rhs": rhs}
    if "fused" in engines:
        from spmv_tpu_torch.kernels.panel import FUSED_SLICE_COLS_MAX

        specs["fused"] = matrix_specs(FUSED_TURN_MATRICES)
        specs["panel_fused"] = matrix_specs(PANEL_FUSED_TURN_MATRICES)
        specs["k6_cap"] = FUSED_SLICE_COLS_MAX
    if engines & {"seg", "spmm"}:
        specs["seg"] = matrix_specs()
    if engines & {"panel", "spmm"}:
        specs["panel"] = {n: [*spec, PANEL_SPLIT.get(n, False)]
                          for n, spec in matrix_specs(PANEL_TURN_MATRICES).items()}
        specs["shapes"] = shape_specs(out)
        named = matrix_specs({m for m, *_ in UNSORTED_BUILDS.values()})
        specs["unsorted"] = {n: [*named[m], fmt, split, forced]
                             for n, (m, fmt, split, forced) in UNSORTED_BUILDS.items()}
    if "sorted" in engines:
        named = matrix_specs({m for m, _, _ in SORTED_BUILDS.values()})
        specs["sorted"] = {n: [*named[m], split, forced]
                           for n, (m, split, forced) in SORTED_BUILDS.items()}
        specs["sorted_shapes"] = shape_specs(out)
    return specs


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def compare(dirs: list[Path]) -> list[str]:
    """The saved outputs that differ, bit for bit, from the first turn's."""
    bad = []
    for f in sorted(dirs[0].glob("*.npy")):
        first = _bits(np.load(f))
        for d in dirs[1:]:
            other = d / f.name
            if not other.exists() or not np.array_equal(first, _bits(np.load(other))):
                bad.append(f"{d.name}/{f.name}")
    return bad


def turn_order(names: list[str]) -> list[str]:
    """The checkouts' turns: the others in order, this twice, the others
    in reverse, so each runs twice and both runs of this sit in the
    middle."""
    return [*names, "this", "this", *reversed(names)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spmv_tpu_torch.probes.turns",
                                description=__doc__.splitlines()[0])
    p.add_argument("other", nargs="+", help="root of the other checkout (the "
                   "first is the one every time is given against)")
    p.add_argument("--out", default="turns_out",
                   help="directory for the outputs and turns.json")
    p.add_argument("--only", choices=("seg", "panel", "spmm", "sorted", "fused"),
                   help="time one engine's tile kernels only (spmm: K8 and "
                        "K10 at R = 2, 4, 8; sorted: the public calls on "
                        "sorted SELL builds; fused: K3 and K6 on the plans of "
                        "the one-dispatch sweeps)")
    p.add_argument("--probe", action="append", default=[],
                   help="NAME:MATRIX, run in each turn, e.g. ablate:pl_big")
    p.add_argument("--rounds", type=int, default=5, help="rounds of each probe")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("turns: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    others = ["other"] + [f"other{i}" for i in range(2, len(args.other) + 1)]
    roots = {**{n: Path(o).resolve() for n, o in zip(others, args.other)},
             "this": THIS_ROOT}
    out = Path(args.out).resolve()
    turns, dirs = [], {tree: [] for tree in roots}
    specs = run_specs(args.only, out)
    for i, tree in enumerate(turn_order(others)):
        d = out / f"{i}-{tree}"
        proc = subprocess.run([sys.executable, __file__, "--worker", str(d),
                               json.dumps(specs)],
                              cwd=roots[tree], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = tree
        for spec in args.probe:
            name, matrix = spec.split(":")
            probe = subprocess.run(
                [sys.executable, "-m", "spmv_tpu_torch.probes", name, "--matrix",
                 matrix, "--rounds", str(args.rounds)],
                cwd=roots[tree], capture_output=True, text=True)
            (d / f"probe_{name}_{matrix}.txt").write_text(probe.stdout + probe.stderr)
            print(f"turn {i} ({tree}, {roots[tree]}): probes {name} --matrix {matrix}")
            print(probe.stdout)
            if probe.returncode:
                print(probe.stderr, file=sys.stderr)
                return 1
        turns.append(res)
        dirs[tree].append(d)
        print(f"turn {i} ({tree}) done  [{res['card']}]", flush=True)

    bad = compare([d for tree in roots for d in dirs[tree]])
    card = turns[0]["card"]
    print(f"tile kernels and paths, device ms, median of each checkout's two "
          f"turns (CUDA-graph replay, warm); 'bound' is the HBM-peak bound; each "
          f"ratio against 'other' ({roots['other']})  [{card}]")
    medians = {}
    keys = list(dict.fromkeys(k for t in turns for k in t["ms"]))
    for key in keys:
        m = {}  # a checkout that lacks a member (the launch floor) has no time
        for tree in roots:
            got = [t["ms"][key] for t in turns if t["tree"] == tree and key in t["ms"]]
            if got:
                m[tree] = statistics.median(got)
        medians[key] = m
        cells = "  ".join(f"{tree} {m[tree] * 1e3:9.2f} µs" if tree in m
                          else f"{tree} {'—':>9s}   " for tree in roots)
        ratios = "  ".join(f"{tree}/other {m[tree] / m['other']:.3f}"
                           for tree in roots if tree != "other" and tree in m
                           and m.get("other"))
        print(f"  {key:34s} {cells}  {ratios}")
    for t in turns:  # K3 against K1 + K2 in each turn (a design may sum otherwise)
        if t.get("fused_bits"):
            print(f"K3 against K1 + K2, {t['tree']}: " + ", ".join(
                f"{n} {'bit for bit' if b['equal'] else 'max |diff| %.3e' % b['max_abs']}"
                for n, b in t["fused_bits"].items()))
        if t.get("panel_fused_bits"):
            print(f"K6 against K4 + fix-up, {t['tree']}: " + ", ".join(
                f"{n} {'bit for bit' if b['equal'] else 'max |diff| %.3e' % b['max_abs']}"
                for n, b in t["panel_fused_bits"].items()))
    n = len(list(dirs["other"][0].glob("*.npy")))
    print(f"bit for bit: {n} outputs of each of {len(turns)} turns; "
          + ("all equal" if not bad else f"{len(bad)} differ: {bad}"))
    (out / "turns.json").write_text(json.dumps(
        {"roots": {k: str(v) for k, v in roots.items()}, "turns": turns,
         "medians_ms": medians, "differ": bad}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        # run as a file: import spmv_tpu_torch from the working directory,
        # the checkout of this turn, not from the directory of this file
        sys.path[0] = os.getcwd()
        print(json.dumps(_worker(Path(sys.argv[2]), json.loads(sys.argv[3]))))
        sys.exit(0)
    sys.exit(main())

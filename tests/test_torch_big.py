"""The port's ``TiledSpmv`` (``spmv_tpu_torch.big``) against the JAX
package's (``spmv_tpu/big.py``, Pallas interpret mode on the CPU, as
``tests/test_big.py`` runs it) and against the fp64 oracle, at
``test_big.py``'s size; the default slabs under a lowered plan bound
(``formats.base.plan_entry_limit``); ``load``'s routing; the traffic
model; ``spmm``; the sort-free ``synthetic_cant`` that the past-int32
probe uses, and the probe's rehearsal. Port and JAX agree within the sum
of both packages' tolerances, and each is held to ``golden_spmv``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import spmv_tpu
import spmv_tpu_torch
from spmv_tpu.big import TiledSpmv as RefTiled
from spmv_tpu.oracle import check_result as ref_check_result
from spmv_tpu.oracle import engine_rel_tol
from spmv_tpu_torch import TiledSpmv, synth
from spmv_tpu_torch.bench.runner import traffic_model
from spmv_tpu_torch.formats import base
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   kernel_check, row_scale)

FORMATS = ["csr", "coo", "cmrs", "ell", "sell", "hyb"]
GRID = dict(slab_rows=1024, panel_cols=1024)


def data(n=3000, seed=2):
    """``tests/test_big.py``'s matrix and x."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=9, bandwidth=50, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal(info.ncols).astype(np.float32)
    return info, r, c, v, x


def longest(nrows, r):
    return int(np.bincount(r, minlength=max(nrows, 1)).max()) if r.size else 1


def oracle_ok(info, r, c, v, x, y):
    rep = kernel_check(golden_spmv(info.nrows, r, c, v, x), np.asarray(y),
                       row_scale(info.nrows, r, c, v, x), longest(info.nrows, r))
    assert rep.ok, str(rep)


def lower_bound(monkeypatch, limit):
    monkeypatch.setattr(base, "plan_entry_limit", lambda tile, slice_rows=1: limit)


def tile_sizes(a):
    """(CSR-plan nonzeros, panel slots) of every plan of every tile."""
    out = []
    for slab in a.tiles:
        for _, c in slab:
            parts = getattr(c, "parts", None)
            if parts is None:
                out.append((c.dev.nnz, 0))
            else:
                spill = parts.dev_spill.nnz if parts.dev_spill is not None else 0
                out.append((spill, parts.dev.nslots))
    return out


@pytest.fixture(scope="module", params=FORMATS)
def jax_tiled(request):
    """One JAX build (and its y) per format, shared by the module's tests."""
    info, r, c, v, x = data()
    ref = RefTiled(request.param, info.nrows, info.ncols, r, c, v, **GRID)
    return request.param, ref, np.asarray(ref.matvec(x))


def test_tiled_matches_jax_and_the_oracle(jax_tiled):
    fmt, ref, y_ref = jax_tiled
    info, r, c, v, x = data()
    a = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **GRID)
    assert (a.DR, a.DC, a.n_tiles, a.rps, a.cps) == (ref.DR, ref.DC, ref.n_tiles,
                                                    ref.rps, ref.cps)
    assert np.array_equal(a.nvalid, ref.nvalid)
    assert [[j for j, _ in s] for s in a.tiles] == [[j for j, _ in s] for s in ref.tiles]
    y = a.matvec(x)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    y = y.numpy()
    oracle_ok(info, r, c, v, x, y)
    expected = golden_spmv(info.nrows, r, c, v, x)
    scale = golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x))
    rep = ref_check_result(expected, y_ref, tol_abs=1e-4, tol_rel=1e-4, scale=scale)
    assert rep.ok, f"JAX {fmt}: {rep}"
    k = longest(info.nrows, r)
    bound = 2 * KERNEL_TOL_ABS + (fp32_rel_tol(k) + engine_rel_tol(k) + 1e-4) * scale
    assert (np.abs(y.astype(np.float64) - y_ref) <= bound).all()


def test_from_reference_of_a_jax_tiled_container(jax_tiled):
    fmt, ref, y_ref = jax_tiled
    info, r, c, v, x = data()
    a = spmv_tpu_torch.from_reference(ref, device="cpu")
    assert isinstance(a, TiledSpmv) and a.format == fmt
    assert (a.DR, a.DC, a.n_tiles, a.nnz) == (ref.DR, ref.DC, ref.n_tiles, ref.nnz)
    assert np.array_equal(a.nvalid, ref.nvalid)
    oracle_ok(info, r, c, v, x, a.matvec(x).numpy())


@pytest.mark.parametrize("fmt", FORMATS)
def test_default_is_one_tile_with_from_coos_bits(fmt):
    info, r, c, v, x = data(n=1500, seed=7)
    a = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    assert (a.DR, a.DC, a.n_tiles, a.rps, a.cps) == (1, 1, 1, info.nrows, info.ncols)
    assert spmv_tpu_torch.fits_single_plan(fmt, info.nrows, info.ncols, r, c)
    single = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    assert type(a.tiles[0][0][1]) is type(single)
    assert torch.equal(a.matvec(x), single.matvec(x))
    assert traffic_model(a) == traffic_model(single) and a.aux_traffic_bytes == 0


@pytest.mark.parametrize("case", ["csr", "ell_hub"])
def test_default_slabs_keep_every_plan_within_the_bound(monkeypatch, case):
    """The default rule under a lowered bound: every CSR plan's nonzeros,
    and every panel's slots (an ELL with a hub row: 32 slots per entry of
    its slice), within it; whole 32-row slices per slab; y right."""
    info, r, c, v, x = data()
    fmt = "csr" if case == "csr" else "ell"
    if case == "ell_hub":  # row 1000 holds 300 entries: its slice is wide
        hub = np.arange(0, 3000, 10)
        r = np.concatenate([r, np.full(hub.size, 1000, r.dtype)])
        c = np.concatenate([c, hub.astype(c.dtype)])
        v = np.concatenate([v, np.ones(hub.size)])
    kw = {"split": False} if case == "ell_hub" else {}  # the whole hub in the panel
    limit = 12_000
    lower_bound(monkeypatch, limit)
    assert not spmv_tpu_torch.fits_single_plan(fmt, info.nrows, info.ncols, r, c)
    a = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **kw)
    assert a.DC == 1 and a.DR > 1
    assert (a.row_bounds[:-1] % base.SLICE_ROWS == 0).all()
    assert all(nnz <= limit and slots <= limit for nnz, slots in tile_sizes(a))
    if case == "ell_hub":  # the hub's slice alone is 32 · 300 slots
        assert max(slots for _, slots in tile_sizes(a)) >= 32 * 300
    oracle_ok(info, r, c, v, x, a.matvec(x).numpy())


def test_one_slice_past_the_bound_is_refused(monkeypatch):
    info, r, c, v, x = data()
    lower_bound(monkeypatch, 100)  # a 32-row slice holds about 290 nonzeros
    with pytest.raises(ValueError, match="one 32-row slice"):
        TiledSpmv("csr", info.nrows, info.ncols, r, c, v, device="cpu")


@pytest.mark.parametrize("grid", ["default", "jax"])
@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb"])
def test_row_ordered_and_shuffled_triplets_give_the_same_tiles_and_y(monkeypatch, fmt,
                                                                     grid):
    info, r, c, v, x = data()
    lower_bound(monkeypatch, 12_000)
    kw = GRID if grid == "jax" else {}
    perm = np.random.default_rng(0).permutation(r.size)
    a = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **kw)
    b = TiledSpmv(fmt, info.nrows, info.ncols, r[perm], c[perm], v[perm], device="cpu",
                  **kw)
    assert base.is_row_major(r, c) and not base.is_row_major(r[perm])
    assert (a.DR, a.DC, a.n_tiles) == (b.DR, b.DC, b.n_tiles) and a.DR > 1
    assert np.array_equal(a.row_bounds, b.row_bounds)
    assert tile_sizes(a) == tile_sizes(b)
    ya, yb = a.matvec(x), b.matvec(x)
    if fmt == "csr":  # each tile sorts its triplets: the same plans, the same bits
        assert torch.equal(ya, yb)
    oracle_ok(info, r, c, v, x, ya.numpy())
    oracle_ok(info, r, c, v, x, yb.numpy())


def test_band_matrix_skips_the_far_corners():
    info, r, c, v, x = data(n=3072, seed=5)
    a = TiledSpmv("csr", info.nrows, info.ncols, r, c, v, device="cpu", **GRID)
    assert a.DR == 3 and a.DC == 3
    assert a.n_tiles <= 7 < a.DR * a.DC and int(a.nvalid.sum()) == a.n_tiles
    assert all(j in (d - 1, d, d + 1) for d, s in enumerate(a.tiles) for j, _ in s)
    oracle_ok(info, r, c, v, x, a.matvec(x).numpy())


@pytest.mark.parametrize("kw", [GRID, {}], ids=["jax", "default"])
def test_an_all_empty_matrix_keeps_one_tile(kw):
    e = np.zeros(0, np.int64)
    a = TiledSpmv("csr", 2500, 2100, e, e, np.zeros(0), device="cpu", **kw)
    assert a.n_tiles == 1 and a.tiles[0][0][0] == 0
    y = a.matvec(np.ones(2100, np.float32))
    assert y.shape == (2500,) and not y.any()


def test_indices_out_of_range_are_refused():
    info, r, c, v, x = data(n=600)
    with pytest.raises(ValueError, match="row index out of bounds"):
        TiledSpmv("csr", 500, info.ncols, r, c, v, device="cpu")
    with pytest.raises(ValueError, match="column index out of bounds"):
        TiledSpmv("csr", info.nrows, 500, r, c, v, device="cpu")


def test_load_routes_past_the_bound_and_not_under_it(monkeypatch, tmp_path):
    path = str(tmp_path / "missing.mtx")
    synth_kw = dict(n=3000, avg_nnz_per_row=5, bandwidth=30, seed=3)
    under = spmv_tpu_torch.load(path, "csr", device="cpu", synth=synth_kw)
    assert type(under).__name__ == "CSRMatrix"
    lower_bound(monkeypatch, 4096)
    a = spmv_tpu_torch.load(path, "csr", device="cpu", synth=synth_kw)
    assert isinstance(a, TiledSpmv) and a.DC == 1 and a.DR > 1
    assert all(nnz <= 4096 for nnz, _ in tile_sizes(a))
    info, r, c, v = synth.synthetic_cant(**synth_kw)
    x = np.random.default_rng(0).standard_normal(a.ncols).astype(np.float32)
    assert a.matvec(x).shape == (a.nrows,)
    oracle_ok(info, r, c, v, x, a.matvec(x).numpy())
    # from_coo never routes: past the bound the builder refuses, in its words
    with pytest.raises(ValueError, match="nonzeros exceed int32 indexing"):
        spmv_tpu_torch.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cpu")
    with pytest.raises(ValueError, match="panel slots exceed int32 indexing"):
        spmv_tpu_torch.from_coo("ell", info.nrows, info.ncols, r, c, v, device="cpu",
                                split=False)


def test_sym_and_bsr_past_the_bound_raise_jaxs_error(monkeypatch, tmp_path):
    lower_bound(monkeypatch, 4096)
    path = str(tmp_path / "missing.mtx")
    synth_kw = dict(n=3000, avg_nnz_per_row=5, bandwidth=30, seed=3)
    with pytest.raises(NotImplementedError) as mine:
        spmv_tpu_torch.load(path, "sym", device="cpu", synth=synth_kw)
    assert str(mine.value) == ("symmetric triangle storage is a single-kernel container; "
                               "use TiledSpmv/dist on the expanded form for this size")
    with pytest.raises(NotImplementedError) as mine:
        spmv_tpu_torch.load(path, "bsr", device="cpu", synth=synth_kw)
    info, r, c, v, x = data(n=600)
    with pytest.raises(NotImplementedError) as theirs:
        RefTiled("bsr", info.nrows, info.ncols, r, c, v)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_traffic_model_is_the_sum_over_tiles(monkeypatch, fmt):
    info, r, c, v, x = data()
    a = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v, device="cpu", **GRID)
    slots, total = traffic_model(a)
    parts = [traffic_model(t) for s in a.tiles for _, t in s]
    assert slots == sum(p[0] for p in parts) == a.element_slots >= a.nnz
    assert total == sum(p[1] for p in parts) + a.aux_traffic_bytes
    # the panel sums (3 × 4 B per row per extra tile) and the join (8 B per row)
    extra = sum(3 * 4 * (b - t) * (n - 1) for t, b, n in
                zip(a.row_bounds[:-1], a.row_bounds[1:], a.nvalid) if n > 1)
    assert a.aux_traffic_bytes == extra + 8 * info.nrows
    lower_bound(monkeypatch, 12_000)  # the default rule: one panel, no sums
    d = TiledSpmv(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    assert d.DC == 1 and d.DR > 1 and all(n == 1 for n in d.nvalid)
    assert d.aux_traffic_bytes == 8 * info.nrows  # the join alone
    assert traffic_model(d)[1] == d.stream_bytes + 8 * info.nrows


@pytest.mark.parametrize("R", [1, 3, 9])
@pytest.mark.parametrize("kw", [GRID, {}], ids=["jax", "default"])
def test_spmm_is_the_stack_of_matvecs(monkeypatch, R, kw):
    info, r, c, v, x = data()
    lower_bound(monkeypatch, 12_000)
    a = TiledSpmv("hyb", info.nrows, info.ncols, r, c, v, device="cpu", **kw)
    X = np.random.default_rng(R).standard_normal((info.ncols, R)).astype(np.float32)
    Y = spmv_tpu_torch.spmm(a, X)
    assert Y.shape == (info.nrows, R) and Y.dtype == torch.float32
    k = longest(info.nrows, r)
    for j in range(R):
        y = a.matvec(X[:, j]).numpy()
        scale = row_scale(info.nrows, r, c, v, X[:, j])
        assert (np.abs(Y[:, j].numpy() - y) <= 2 * (KERNEL_TOL_ABS + fp32_rel_tol(k)
                                                    * scale)).all()
        oracle_ok(info, r, c, v, X[:, j], Y[:, j].numpy())


def test_plan_builders_share_one_bound(monkeypatch):
    """Both builders refuse past ``plan_entry_limit`` with their words;
    ``check_plan_range`` is the check."""
    from spmv_tpu_torch.formats.base import (build_csr_plan, build_panel_plan,
                                             check_plan_range)

    lower_bound(monkeypatch, 10)
    ptr = np.array([0, 6, 11])
    cols, vals = np.arange(11) % 6, np.ones(11)
    with pytest.raises(ValueError, match="2 rows / 11 nonzeros exceed int32 indexing"):
        build_csr_plan(2, 6, ptr, cols, vals)
    build_csr_plan(1, 6, ptr[:2], cols[:6], vals[:6])
    with pytest.raises(ValueError, match="2 rows / 192 panel slots exceed int32"):
        build_panel_plan(2, 6, np.repeat([0, 1], [6, 5]), cols, vals)
    with pytest.raises(ValueError, match="3 rows / 11 things exceed"):
        check_plan_range(3, 11, 1, "things")


def test_csr_takes_row_ordered_triplets_as_they_are():
    info, r, c, v, x = data(n=900)
    perm = np.random.default_rng(1).permutation(r.size)
    a = spmv_tpu_torch.from_coo("csr", info.nrows, info.ncols, r, c, v, device="cpu")
    b = spmv_tpu_torch.from_coo("csr", info.nrows, info.ncols, r[perm], c[perm],
                                v[perm], device="cpu")
    for f in ("ptr", "cols", "vals", "tile_row0", "carry_rows"):
        assert np.array_equal(getattr(a.plan, f), getattr(b.plan, f))
    assert np.shares_memory(a.cols, c)  # no copy of row-ordered columns


@pytest.mark.parametrize("args,kw", [((3000, 9, 50, 2), {}), ((3001, 9, 50, 2), {}),
                                     ((3002, 9, 50, 2), {}), ((700, 64, 350, 1), {}),
                                     ((20000, 64, 350, 0), {}), ((4000, 8, 300, 0), {}),
                                     ((5, 64, 350, 0), {}),
                                     ((2999, 9, 50, 3), dict(sorted_by_row_length=True)),
                                     ((1000, 16, 60, 4), dict(index_dtype=np.int64,
                                                              dtype=np.float32))])
def test_synthetic_cant_is_the_jax_generator_bit_for_bit(monkeypatch, args, kw):
    """The port's sort-free ``synthetic_cant`` (several passes of 777
    source vertices) gives the JAX generator's arrays, dtypes and info."""
    from spmv_tpu import synth as ref_synth

    monkeypatch.setattr(synth, "_CHUNK_VERTICES", 777)
    a = ref_synth.synthetic_cant(*args, **kw)
    b = synth.synthetic_cant(*args, **kw)
    assert dataclasses.astuple(a[0]) == dataclasses.astuple(b[0])
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and x.flags.c_contiguous and y.flags.c_contiguous
        assert np.array_equal(x, y)


@pytest.mark.parametrize("command", ["run", "bench", "bench_rhs"])
def test_cli_benches_a_routed_matrix(monkeypatch, tmp_path, capsys, command):
    """``run --bench`` and ``bench`` (SpMV, and SpMM at R = 3) on a matrix
    past a lowered plan bound: the CLI tiles it and times the TiledSpmv."""
    from spmv_tpu_torch import cli
    from spmv_tpu_torch.io import mmio

    lower_bound(monkeypatch, 12_000)
    info, r, c, v, x = data()
    path, out = tmp_path / "m.mtx", tmp_path / "run.json"
    mmio.write_coo(str(path), info.nrows, info.ncols, r, c, v)
    argv = {"run": ["run", "--format", "sell", "--bench"],
            "bench": ["bench", "--formats", "csr,hyb"],
            "bench_rhs": ["bench", "--formats", "cmrs", "--rhs", "3"]}[command]
    assert cli.main(argv + ["--matrix", str(path), "--device", "cpu",
                            "--json", str(out)]) == 0
    text = capsys.readouterr().out
    d = json.loads(out.read_text())
    if command == "run":
        assert "tiled:" in text and "result is ok" in text
        d = {"sell": d}
    for res in d.values():
        assert res["timing"] == "host" and res["nnz"] == r.size and res["card"] is None
        assert res.get("ms_per_spmv", res.get("ms_per_spmm")) > 0


def test_probe_tiled_rehearses_on_the_cpu(tmp_path, capsys):
    from spmv_tpu_torch.probes.__main__ import main

    out = tmp_path / "tiled.json"
    assert main(["tiled", "--n", "9000", "--bound", "150000", "--device", "cpu",
                 "--json", str(out)]) == 0
    d = json.loads(out.read_text())
    assert d["DR"] > 1 and d["DC"] == 1 and "result is ok" in d["check"]
    assert all(n <= 150000 for n in d["slab_nnz"]) and sum(d["slab_nnz"]) == d["nnz"]
    assert d["ms"] is None and d["library_ms"] is None
    assert "not measured" in capsys.readouterr().out

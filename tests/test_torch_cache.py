"""The port's caches (``spmv_tpu_torch.cache``): plans keyed by the
inputs of a plan build, tile and dtype, triplets keyed by the file; a hit gives
the plan a miss built, array for array."""

import dataclasses
import os

import numpy as np
import pytest

import spmv_tpu_torch
from spmv_tpu_torch import cache, synth
from spmv_tpu_torch.formats import base
from spmv_tpu_torch.io import mmio


def triplets(n=300, seed=2):
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=10, bandwidth=40,
                                         seed=seed)
    order = np.lexsort((c, r))
    return info, r[order], c[order], v[order]


def csr_plan(tile=base.TILE_NNZ, dtype=np.float32, n=300, seed=2):
    info, r, c, v = triplets(n, seed)
    return base.build_csr_plan(info.nrows, info.ncols, base.csr_ptr(r, info.nrows),
                               c, v, tile=tile, dtype=dtype)


def panel_plan(tile=base.TILE_COLS, dtype=np.float32, n=300, seed=2):
    info, r, c, v = triplets(n, seed)
    return base.build_panel_plan(info.nrows, info.ncols, r, c, v, tile=tile,
                                 dtype=dtype)


BUILDERS = {"csr": csr_plan, "panel": panel_plan}


def npz(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npz")) if os.path.isdir(d) else []


def same_plan(a, b) -> bool:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if not (x.dtype == y.dtype and np.array_equal(x, y)):
                return False
        elif x != y:
            return False
    return type(a) is type(b)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_a_miss_then_a_hit_gives_the_same_plan(tmp_path, monkeypatch, kind):
    d = str(tmp_path / "c")
    with cache.plan_cache(d):
        built = BUILDERS[kind]()
        assert len(npz(d)) == 1 and npz(d)[0].startswith(f"plan-{kind}-")
        stamp = os.path.getmtime(os.path.join(d, npz(d)[0]))
        monkeypatch.setattr(base, "cdiv", None)  # a hit builds nothing
        hit = BUILDERS[kind]()
    assert same_plan(hit, built)
    assert os.path.getmtime(os.path.join(d, npz(d)[0])) == stamp
    monkeypatch.undo()
    assert same_plan(BUILDERS[kind](), built)  # caching off: built again


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_dtype_tile_and_content_change_the_key(tmp_path, kind):
    d = str(tmp_path / "c")
    build = BUILDERS[kind]
    tile = base.TILE_NNZ if kind == "csr" else base.TILE_COLS
    with cache.plan_cache(d):
        f32 = build()
        f64 = build(dtype=np.float64)
        small = build(tile=tile // 4)
        other = build(seed=3)
        assert len(npz(d)) == 4
        assert f64.vals.dtype == np.float64 and f32.vals.dtype == np.float32
        assert small.tile == tile // 4 and f32.tile == tile
        assert same_plan(build(dtype=np.float64), f64)
        assert same_plan(build(tile=tile // 4), small)
        assert same_plan(build(seed=3), other)
        assert len(npz(d)) == 4


def test_plan_keys_carry_the_ports_namespace():
    a = np.arange(5)
    k1 = cache._plan_key("csr", (a,), 5, 5, {"tile": 1024, "dtype": "float32"})
    assert k1 == cache._plan_key("csr", (a.copy(),), 5, 5,
                                 {"dtype": "float32", "tile": 1024})
    assert k1 != cache._plan_key("csr", (a,), 5, 5, {"tile": 1024, "dtype": "float64"})
    assert k1 != cache._plan_key("csr", (a.astype(np.int32),), 5, 5,
                                 {"tile": 1024, "dtype": "float32"})
    old = cache.NAMESPACE
    try:
        cache.NAMESPACE = "torch-v0"
        assert k1 != cache._plan_key("csr", (a,), 5, 5, {"tile": 1024, "dtype": "float32"})
    finally:
        cache.NAMESPACE = old


def test_plan_cache_restores_the_setting_before_it(tmp_path):
    assert cache._PLAN_CACHE_DIR is None
    with cache.plan_cache(str(tmp_path / "a")):
        with cache.plan_cache(None):
            assert cache._PLAN_CACHE_DIR is None
        assert cache._PLAN_CACHE_DIR == str(tmp_path / "a")
    assert cache._PLAN_CACHE_DIR is None


def write_mtx(path, info, r, c, v):
    path.write_text(f"%%MatrixMarket matrix coordinate real general\n"
                    f"{info.nrows} {info.ncols} {r.size}\n"
                    + "".join(f"{i + 1} {j + 1} {float(x)!r}\n" for i, j, x in zip(r, c, v)))


def cached_load(path, fmt, cache_dir):
    """The CLI's route: triplets through ``load_triplets``, the container
    built while ``plan_cache`` holds the same directory."""
    info, r, c, v = cache.load_triplets(path, cache_dir, expand_symmetry=fmt != "sym")
    with cache.plan_cache(cache_dir):
        return spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v,
                                       device="cpu")


@pytest.mark.parametrize("fmt", ["csr", "coo", "cmrs", "ell", "sell", "hyb", "sym"])
def test_cached_load_round_trip(tmp_path, monkeypatch, fmt):
    path = tmp_path / "m.mtx"
    write_mtx(path, *triplets(n=200))
    d = str(tmp_path / "c")
    a = cached_load(str(path), fmt, d)
    files = npz(d)
    assert any("coo-triplets" in f for f in files) and any(f.startswith("plan-") for f in files)

    def no_parse(*args, **kwargs):
        raise AssertionError("parsed again")

    monkeypatch.setattr(mmio, "read_path_or_synthesize", no_parse)
    b = cached_load(str(path), fmt, d)
    assert npz(d) == files
    x = np.random.default_rng(0).standard_normal(a.ncols).astype(np.float32)
    assert np.array_equal(a.matvec(x).numpy(), b.matvec(x).numpy())
    assert cache._PLAN_CACHE_DIR is None


def test_triplet_keys_carry_the_synthesis_and_the_expansion(tmp_path):
    """A git-LFS pointer exists, so its synthesized triplets are cached: the
    synthesis arguments and the symmetric expansion are part of the key."""
    ptr = tmp_path / "cant.mtx"
    ptr.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 1\n")
    d = str(tmp_path / "c")
    small = cache.load_triplets(str(ptr), d, n=300)
    big = cache.load_triplets(str(ptr), d, n=400)
    tri = cache.load_triplets(str(ptr), d, expand_symmetry=False, n=300)
    assert (small[0].nrows, big[0].nrows, tri[0].nrows) == (300, 400, 300)
    assert len(npz(d)) == 3
    again = cache.load_triplets(str(ptr), d, n=300)
    assert dataclasses.astuple(again[0]) == dataclasses.astuple(small[0])
    for x, y in zip(again[1:], small[1:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert cache.load_triplets(str(tmp_path / "missing.mtx"), d, n=300)[0].nrows == 300
    assert len(npz(d)) == 3  # a missing file is not cached


def test_load_and_the_uncached_route_agree(tmp_path):
    path = tmp_path / "m.mtx"
    write_mtx(path, *triplets(n=150, seed=4))
    a = spmv_tpu_torch.load(str(path), "sell", device="cpu")
    b = cached_load(str(path), "sell", None)
    assert not (tmp_path / "c").exists()
    for x, y in zip(a.to_coo(), b.to_coo()):
        assert np.array_equal(x, y)

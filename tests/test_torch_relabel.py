"""The hub-first column relabel of skewed CSR plans on the CPU: where
``device.DevCsr.from_plan``'s rule fires and where it does not, what
``DevCsr.col_order`` holds, and that every container over a relabelled
plan gives the unrelabelled plan's bits (the plain versions; the card's
kernels on relabelled plans are in ``test_torch_gpu.py``)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch import X2Matrix, device, solve, synth, trace
from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.formats.base import build_csr_plan, csr_ptr
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.kernels import engines_x2 as X2
from spmv_tpu_torch.kernels import probes as KP

from _torch_graphs import kronecker, shifted, stencil27
from _torch_loops import cpu_graph  # noqa: F401  (the fixture, with CpuLoop)


@functools.cache
def graph17():
    """509,499 nonzeros over 131,072 columns: a plan over the K3 threshold
    whose columns the rule relabels (top 1% of the used columns 28.5% of
    the nonzeros, 44.3% within 32,768 columns of their row)."""
    return kronecker(17, 2)


def band(n: int, half: int):
    """Every column within ``half`` of its row."""
    i = np.arange(n)
    r = np.repeat(i, 2 * half + 1)
    c = r + np.tile(np.arange(-half, half + 1), n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return n, r, c, np.ones(r.size, np.float32)


def from_synth(gen):
    info, r, c, v = gen()
    return info.nrows, r, c, np.asarray(v, np.float32)


def csr(n, r, c, v):
    return spmv_tpu_torch.from_coo("csr", n, n, r, c, v, device="cpu")


def plain(dev: DevCsr) -> DevCsr:
    """The same plan without the relabel."""
    return dataclasses.replace(dev, cols=dev.source_cols(), col_order=None)


def x_of(n: int, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32))


# ---------------------------------------------------------------- the rule


def test_the_rule_relabels_a_kronecker_graph():
    n, r, c, v = graph17()
    dev = csr(n, r, c, v).dev
    top, near = dev.column_shares()
    assert not dev.fused
    assert top >= device.RELABEL_TOP_SHARE_MIN and near < device.RELABEL_NEAR_SHARE_MAX
    assert dev.col_order is not None and dev.col_order.dtype == torch.int32
    assert dev.stream_bytes == plain(dev).stream_bytes  # col_order is not streamed
    x = x_of(n)
    assert torch.equal(E.segmented_spmv(dev, x), E.segmented_spmv(plain(dev), x))


LEFT_ALONE = {
    # (matrix, why the rule does not fire: "flat" columns, a "band", or "fused")
    "stencil27": (lambda: stencil27(36), {"flat", "band"}),
    "power_law_banded": (lambda: from_synth(functools.partial(
        synth.power_law, n=131072, avg_nnz_per_row=16, bandwidth=512, seed=0)), {"flat", "band"}),
    "band": (lambda: band(262144, 2), {"flat", "band"}),
    "power_law_uniform_cols": (lambda: from_synth(functools.partial(
        synth.power_law, n=131072, avg_nnz_per_row=8, seed=0)), {"flat"}),
    "kronecker_16": (lambda: kronecker(16, 4), {"band"}),
    "kronecker_under_k3": (graph17, {"fused"}),
}


@pytest.mark.parametrize("name", sorted(LEFT_ALONE))
def test_the_rule_leaves_flat_banded_and_fused_plans_alone(monkeypatch, name):
    make, why = LEFT_ALONE[name]
    if "fused" in why:  # the same graph, its plan under the one-dispatch threshold
        monkeypatch.setattr(device, "FUSED_STREAM_BYTES_MAX", 64 << 20)
    n, r, c, v = make()
    dev = csr(n, r, c, v).dev
    assert dev.col_order is None
    assert dev.fused == ("fused" in why)
    top, near = dev.column_shares()
    assert (top < device.RELABEL_TOP_SHARE_MIN) == ("flat" in why), top
    assert (near >= device.RELABEL_NEAR_SHARE_MAX) == ("band" in why), near


# ---------------------------------------------------------------- col_order


def small_plan() -> DevCsr:
    """4 rows over 8 columns; column counts 1, 1, 0, 3, 0, 3, 0, 2."""
    rows = np.array([0, 0, 0, 1, 1, 2, 2, 2, 3, 3])
    cols = np.array([1, 3, 5, 3, 5, 0, 5, 7, 3, 7])
    vals = np.arange(1, 11, dtype=np.float32)
    return DevCsr.from_plan(build_csr_plan(4, 8, csr_ptr(rows, 4), cols, vals, tile=4), "cpu")


def test_col_order_is_hottest_first_stable_and_skips_empty_columns():
    dev = small_plan()
    assert dev.col_order is None  # a fused plan: the rule is not read
    rel = dev.relabeled()
    assert rel.col_order.tolist() == [3, 5, 7, 0, 1]
    # the labels, each row's nonzeros in their order: nothing re-sorted
    assert rel.cols.tolist() == [4, 0, 1, 0, 1, 3, 1, 2, 0, 2]
    assert torch.equal(rel.source_cols(), dev.cols)
    for f in ("ptr", "vals", "tile_row0", "carry_rows"):
        assert getattr(rel, f) is getattr(dev, f)
    assert rel.stream_bytes == dev.stream_bytes
    with pytest.raises(ValueError, match="relabelled already"):
        rel.relabeled()


def test_col_order_is_a_permutation_of_the_used_columns_by_count():
    n, r, c, v = graph17()
    dev = csr(n, r, c, v).dev
    order = dev.col_order.long()
    assert torch.equal(torch.sort(order).values, torch.from_numpy(np.unique(c)))
    counts = torch.bincount(torch.from_numpy(c), minlength=n)[order]
    assert bool((counts[1:] <= counts[:-1]).all())
    tie = counts[1:] == counts[:-1]
    assert bool((order[1:][tie] > order[:-1][tie]).all())  # ties in source order
    assert torch.equal(dev.source_cols(), torch.from_numpy(c.astype(np.int32)))


# ---------------------------------------------------------------- every container


def forced(monkeypatch, on: bool) -> None:
    """Every plan runs K1 + K2 (here their plain versions), and the rule
    fires on every one (``on``) or on none."""
    monkeypatch.setattr(device, "FUSED_STREAM_BYTES_MAX", 0)
    monkeypatch.setattr(device, "RELABEL_TOP_SHARE_MIN", 0.0 if on else 2.0)
    monkeypatch.setattr(device, "RELABEL_NEAR_SHARE_MAX", 2.0)


@functools.cache
def graph10():
    return kronecker(10, 4, seed=3)


def container(kind: str):
    n, r, c, v = graph10()
    if kind == "sym":  # the stored lower triangle
        keep = r >= c
        return spmv_tpu_torch.SymmetricMatrix.from_coo(n, n, r[keep], c[keep], v[keep],
                                                      device="cpu")
    if kind.startswith("x2_"):
        return X2Matrix.from_coo(kind[3:], n, n, r, c, v, device="cpu")
    return spmv_tpu_torch.from_coo(kind, n, n, r, c, v, device="cpu")


def dev_csrs(a) -> list:
    return [d for d in (getattr(a, "dev", None), getattr(a, "dev_spill", None))
            if isinstance(d, DevCsr)]


CONTAINERS = ["csr", "coo", "cmrs", "hyb", "sell", "sym", "x2_csr", "x2_hyb"]


def both(monkeypatch, kind: str):
    forced(monkeypatch, False)
    a0 = container(kind)
    forced(monkeypatch, True)
    a1 = container(kind)
    assert all(d.col_order is None for d in dev_csrs(a0))
    assert dev_csrs(a1) and all(d.col_order is not None for d in dev_csrs(a1))
    return a0, a1


@pytest.mark.parametrize("kind", CONTAINERS)
def test_matvec_on_relabelled_plans_is_the_plain_plans_bits(monkeypatch, kind):
    a0, a1 = both(monkeypatch, kind)
    dtype = torch.float64 if kind.startswith("x2_") else torch.float32
    x = x_of(a0.ncols).to(dtype)
    y0, y1 = a0.matvec(x), a1.matvec(x)
    assert y1.dtype == dtype and torch.equal(y0, y1)


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("kind", ["csr", "coo", "cmrs", "hyb", "sym"])
def test_matmat_on_relabelled_plans_is_the_plain_plans_bits(monkeypatch, kind, R):
    a0, a1 = both(monkeypatch, kind)
    X = torch.from_numpy(np.random.default_rng(R).standard_normal(
        (a0.ncols, R)).astype(np.float32))
    assert torch.equal(spmv_tpu_torch.spmm(a0, X), spmv_tpu_torch.spmm(a1, X))


def test_each_engine_function_gathers_x_itself(monkeypatch):
    """K1, K3, K8 and K12's plain versions and the probes' take x in the
    matrix's labels on a relabelled plan; the carries match slot for slot."""
    forced(monkeypatch, True)
    n, r, c, v = graph10()
    dev = csr(n, r, c, v).dev
    base = plain(dev)
    x = x_of(n)
    for fn in (E.segmented_spmv_partials, E.segmented_spmv_partials_reference):
        for got, want in zip(fn(dev, x), fn(base, x)):
            assert torch.equal(got, want)
    assert torch.equal(E.segmented_spmv_fused(dev, x), E.segmented_spmv_fused(base, x))
    X = torch.stack([x, -x, 2 * x], dim=1)
    assert torch.equal(E.segmented_spmv_multi(dev, X), E.segmented_spmv_multi(base, X))
    d64 = dataclasses.replace(dev, vals=dev.vals.double())
    assert torch.equal(X2.segmented_spmv_x2(d64, x.double()),
                       X2.segmented_spmv_x2(plain(d64), x.double()))
    assert torch.equal(KP.segmented_spmv_fold(dev, x), KP.segmented_spmv_fold(base, x))
    for got, want in zip(KP.ablate_x32(d64, x), KP.ablate_x32(plain(d64), x)):
        assert torch.equal(got, want)
    c16 = KP.cols16(dev)
    for got, want in zip(KP.segmented_spmv_partials_u16(dev, c16, x),
                         E.segmented_spmv_partials(dev, x)):
        assert torch.equal(got, want)
    at = KP.retile(dev, 512)  # from the matrix's own labels, the rule read anew
    assert at.col_order is not None and torch.equal(at.source_cols(), base.cols)
    for got, want in zip(KP.segmented_spmv_partials_at(at, x),
                         KP.segmented_spmv_partials_at(plain(at), x)):
        assert torch.equal(got, want)


def test_plan_x_counts_its_gathers(monkeypatch):
    forced(monkeypatch, True)
    n, r, c, v = graph10()
    dev = csr(n, r, c, v).dev
    x = x_of(n)
    E.reset_launches()
    assert E.plan_x(plain(dev), x) is x and E.GATHERS["x_gathers"] == 0
    xp = E.plan_x(dev, x)
    assert E.GATHERS["x_gathers"] == 1 and xp.shape == dev.col_order.shape
    assert torch.equal(xp, x[dev.col_order.long()])
    E.reset_launches()
    assert E.GATHERS["x_gathers"] == 0


# ---------------------------------------------------------------- solvers


@pytest.mark.parametrize("graph", [False, True])
def test_solvers_on_relabelled_plans_are_the_plain_plans_bits(monkeypatch, request, graph):
    """cg and power iteration, eager or through the chunked masked loop
    (``CpuLoop``), give the same bits on a relabelled plan as on the plain
    one."""
    if graph:
        request.getfixturevalue("cpu_graph")
    n, r, c, v = shifted(*graph10())
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    out = []
    for on in (False, True):
        forced(monkeypatch, on)
        a = csr(n, r, c, v)
        assert (a.dev.col_order is not None) == on
        runs = [solve.cg(a, b, tol=1e-6) for _ in range(2)]  # eager, then the loop
        lams = [solve.power_iteration(a, iters=30, seed=2) for _ in range(2)]
        out.append((runs, lams))
    (runs0, lams0), (runs1, lams1) = out
    for r0, r1 in zip(runs0 + runs1[:1], runs1):  # eager = loop = relabelled
        assert torch.equal(r0[0], r1[0]) and r0[1:] == r1[1:]
    for l0, l1 in zip(lams0 + lams1[:1], lams1):
        assert l0[0] == l1[0] and torch.equal(l0[1], l1[1])


# ---------------------------------------------------------------- spans


@pytest.fixture
def armed():
    trace.clear()
    trace.enable()
    yield
    trace.disable()
    trace.clear()


def named(name):
    return [s for s in trace.spans() if s.name == name]


@pytest.mark.parametrize("case", ["relabelled", "not_relabelled", "fused"])
def test_plan_upload_and_wrapper_spans_count_the_relabel(armed, case):
    n, r, c, v = {"relabelled": graph17, "not_relabelled": lambda: kronecker(16, 4),
                  "fused": graph10}[case]()
    a = csr(n, r, c, v)
    a.matvec(x_of(n))
    (up,) = named("plan.upload")
    on = case == "relabelled"
    assert up.counts["relabeled"] == int(on)
    if case == "fused":
        assert up.counts == {"relabeled": 0}
    else:
        assert (up.counts["top_share"], up.counts["near_share"]) == a.dev.column_shares()
    (w,) = named("spmv.wrapper")
    assert w.counts == {"launches": 0, "x_gathers": int(on)}


@pytest.mark.parametrize("kind", ["sym", "hyb"])
def test_a_wrapper_span_counts_the_gathers_of_its_plans(monkeypatch, armed, kind):
    """sym's two passes are two wrapper spans, a gather each; HYB's one
    span holds its spill's gather."""
    forced(monkeypatch, True)
    a = container(kind)
    a.matvec(x_of(a.ncols))
    csr_uploads = [s for s in named("plan.upload") if "relabeled" in s.counts]
    assert [s.counts["relabeled"] for s in csr_uploads] == [1] * len(dev_csrs(a))
    assert [s.counts["x_gathers"] for s in named("spmv.wrapper")] == (
        [1, 1] if kind == "sym" else [1])


# ---------------------------------------------------------------- K1's hot head


@pytest.mark.parametrize("case", ["kronecker", "stencil"])
def test_plan_upload_on_the_cpu_counts_no_hot_head(armed, case):
    """No hot-head kernel runs on the CPU, so ``plan.upload`` counts no hot
    head there: not on the Kronecker graph, which the rule relabels, nor
    on HPCG's stencil, which it leaves alone (the card's counts are in
    ``test_torch_gpu.py``)."""
    n, r, c, v = stencil27(28) if case == "stencil" else graph17()
    a = csr(n, r, c, v)
    (up,) = named("plan.upload")
    assert up.counts["relabeled"] == (case == "kronecker")
    assert (a.dev.col_order is not None) == (case == "kronecker")
    assert not {"hot_cols", "hot_share"} & set(up.counts)


@pytest.mark.parametrize("cols", [1, 4096, "used", "more"])
def test_hot_head_counts_are_numpys(cols):
    """``hot_head_counts`` over the relabel's counts of the Kronecker graph,
    sorted hottest first: the first ``cols`` labels, or every used column
    where fewer, and the share of the nonzeros they hold, as numpy counts
    them from the triplets."""
    n, r, c, v = graph17()
    counts = np.sort(np.bincount(c, minlength=n))[::-1]
    used = int(np.count_nonzero(counts))
    cols = {"used": used, "more": used + 7}.get(cols, cols)
    hottest = torch.sort(torch.bincount(torch.from_numpy(c), minlength=n),
                         descending=True, stable=True).values
    got = device.hot_head_counts(hottest, used, r.size, cols)
    hot = min(cols, used)
    assert got == {"hot_cols": hot, "hot_share": int(counts[:hot].sum()) / r.size}
    assert (got["hot_share"] == 1.0) == (cols >= used)


def test_the_launch_runs_the_hot_head_on_relabelled_float32_vectors(monkeypatch):
    """K1's launch runs the hot-head kernel exactly on a relabelled float32
    plan with a vector x, x gathered into label order and its entries
    passed after the tile; K1 on a plan not relabelled, K8 (an (ncols, R)
    X) and K12 (float64) keep their kernels."""
    launched = []
    monkeypatch.setattr(E, "_launch", lambda name, dev, *args: launched.append((name, args)))
    f0, f1 = (a.dev for a in both(monkeypatch, "csr"))
    g0, g1 = (a.dev for a in both(monkeypatch, "x2_csr"))
    x = x_of(f0.ncols)
    X = torch.stack([x, -x], dim=1)
    cases = [("seg_spmv_tiles", torch.float32, f1, x, "seg_spmv_tiles_hot"),
             ("seg_spmv_tiles", torch.float32, f0, x, "seg_spmv_tiles"),
             ("seg_spmm_tiles", torch.float32, f1, X, "seg_spmm_tiles"),
             ("seg_spmm_tiles", torch.float32, f0, X, "seg_spmm_tiles"),
             ("seg_spmv_tiles_x2", torch.float64, g1, x.double(), "seg_spmv_tiles_x2"),
             ("seg_spmv_tiles_x2", torch.float64, g0, x.double(), "seg_spmv_tiles_x2")]
    for kernel, dtype, dev, xx, want in cases:
        launched.clear()
        E._launch_seg_tiles(kernel, dtype, dev, xx)
        ((name, args),) = launched
        assert name == want and E.hot_head(dev, xx) == (want == "seg_spmv_tiles_hot")
        assert torch.equal(args[4], E.plan_x(dev, xx))
        if want == "seg_spmv_tiles_hot":
            assert args[-1] == dev.col_order.numel() == args[4].numel()
        else:
            assert len(args) == 10 + (xx.dim() - 1)

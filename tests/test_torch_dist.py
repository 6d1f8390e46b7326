"""The port's distribution layer on the host, with no process group: the
slab bounds, the chunked gather's column layout, the ring's schedule, the
refusals (each against the JAX package's same call), ``make_mesh``'s
count check, ``init_distributed``'s backend choice and the analytic
weak-scaling model. A ``Mesh`` of the sizes and ranks below needs no group
to build a shard: construction runs no collective. The collectives run in
``test_torch_dist_mp.py``."""

import types

import numpy as np
import pytest
import torch

import spmv_tpu_torch
from spmv_tpu_torch import synth
from spmv_tpu_torch.dist import mesh as M
from spmv_tpu_torch.dist.overlap import ChunkedRowSpmv, chunk_columns
from spmv_tpu_torch.dist.ring import RingShardedSpmv, ring_schedule
from spmv_tpu_torch.dist.sharded import ColShardedSpmv, RowShardedSpmv, slab
from spmv_tpu_torch.oracle import golden_spmv

CPU = torch.device("cpu")


def mesh_of(size: int, rank: int = 0) -> M.Mesh:
    return M.Mesh(group=None, size=size, rank=rank, device=CPU)


def triplets(n=700, seed=4):
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=10, bandwidth=50,
                                         seed=seed)
    return info, r, c, v


@pytest.mark.parametrize("n", [1, 127, 128, 129, 700, 1021, 62464, 100003])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_slab_is_jax_formula(n, D):
    from spmv_tpu.formats.base import LANES, cdiv, round_up

    assert slab(n, D) == round_up(max(cdiv(n, D), LANES), LANES)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("fmt", ["csr", "sell", "hyb"])
def test_row_and_col_shards_hold_jax_slabs(D, fmt):
    """Rank d's row shard computes y's rows [d·rps, (d+1)·rps) (zeros past
    nrows); its column shard the partial y of columns [d·cps, (d+1)·cps)."""
    info, r, c, v = triplets(1021)
    x = np.random.default_rng(1).standard_normal(info.ncols).astype(np.float32)
    rps = cps = slab(info.nrows, D)
    y = golden_spmv(info.nrows, r, c, v, x)
    y_pad = np.zeros(D * rps)
    y_pad[:info.nrows] = y
    x_pad = np.zeros(D * cps, np.float32)
    x_pad[:info.ncols] = x
    col_sum = np.zeros(info.nrows)
    for d in range(D):
        row = RowShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh_of(D, d))
        assert (row.rps, row.shard.nrows, row.shard.ncols) == (rps, rps, info.ncols)
        np.testing.assert_allclose(row.shard.matvec(x).numpy(),
                                   y_pad[d * rps:(d + 1) * rps], atol=1e-4)
        col = ColShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh_of(D, d))
        assert (col.shard.nrows, col.shard.ncols) == (info.nrows, cps)
        part = col.shard.matvec(x_pad[d * cps:(d + 1) * cps]).numpy()
        sel = (c >= d * cps) & (c < (d + 1) * cps)
        np.testing.assert_allclose(part, golden_spmv(info.nrows, r[sel], c[sel],
                                                     v[sel], x), atol=1e-4)
        col_sum += part
    np.testing.assert_allclose(col_sum, y, atol=1e-4)


def jax_chunk_columns(cols, ncols, D, C):
    """JAX's inline layout (``spmv_tpu/dist/overlap.py:88-133``)."""
    from spmv_tpu.device import x_table_rows
    from spmv_tpu.formats.base import LANES, round_up

    S = round_up(x_table_rows(ncols), D * C)
    s_loc, spd = S // (D * C), S // D
    stripe = cols >> 7
    owner, lrow = stripe // spd, stripe % spd
    new_stripe = owner * s_loc + (lrow % s_loc)
    return S, lrow // s_loc, (new_stripe << 7) | (cols & (LANES - 1))


@pytest.mark.parametrize("ncols", [1, 700, 1021, 4096, 9000])
@pytest.mark.parametrize("D,C", [(1, 1), (1, 4), (2, 2), (2, 4), (4, 2), (3, 3)])
def test_chunk_columns_are_jax_and_index_the_gathered_chunk(ncols, D, C):
    cols = np.arange(ncols, dtype=np.int64)
    S, chunk_of, new_cols = chunk_columns(cols, ncols, D, C)
    jS, jchunk, jnew = jax_chunk_columns(cols, ncols, D, C)
    assert S == jS and np.array_equal(chunk_of, jchunk) and np.array_equal(new_cols, jnew)
    # what chunk c's all-gather holds: every rank's local table rows
    # [c·s, (c+1)·s), rank-major; each column must find its x there
    x = np.zeros(S * 128)
    x[:ncols] = np.random.default_rng(2).standard_normal(ncols)
    local = x.reshape(D, -1)
    w = S // (D * C) * 128
    for c in range(C):
        gathered = np.concatenate([local[o, c * w:(c + 1) * w] for o in range(D)])
        sel = chunk_of == c
        assert (new_cols[sel] < D * w).all()
        assert np.array_equal(gathered[new_cols[sel]], x[cols[sel]])
    assert np.bincount(chunk_of, minlength=C).sum() == ncols


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5])
def test_ring_schedule_follows_the_shifts(D):
    """Block j = (r − k) mod D at step k, each block once; after k shifts
    to the next rank, rank r holds the block rank r − k started with."""
    held = list(range(D))  # rank r starts with block r
    for k in range(D):
        for r in range(D):
            assert ring_schedule(r, D)[k] == held[r]
        held = [held[(r - 1) % D] for r in range(D)]
    for r in range(D):
        assert sorted(ring_schedule(r, D)) == list(range(D))


def test_ring_blocks_and_chunks_cover_the_slab():
    """Rank r's ring blocks, and its chunked containers, hold exactly its
    row slab's nonzeros."""
    info, r, c, v = triplets(1021)
    D = 3
    rps = slab(info.nrows, D)
    for rank in range(D):
        want = int(((r >= rank * rps) & (r < (rank + 1) * rps)).sum())
        ring = RingShardedSpmv("csr", info.nrows, info.ncols, r, c, v, mesh_of(D, rank))
        assert sum(b.nnz for b in ring.blocks) == want
        chunked = ChunkedRowSpmv("csr", info.nrows, info.ncols, r, c, v,
                                 mesh_of(D, rank), chunks=2)
        assert len(chunked.chunks) == 2 and sum(a.nnz for a in chunked.chunks) == want


def jax_raises(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


REFUSALS = {
    "col bsr": lambda cls, a: cls["col"]("bsr", *a),
    "ring bsr": lambda cls, a: cls["ring"]("bsr", *a),
    "chunked bsr": lambda cls, a: cls["chunked"]("bsr", *a, chunks=2),
    "row x2 bsr": lambda cls, a: cls["row"]("bsr", *a, dtype="f32x2"),
    "row x2 hyb": lambda cls, a: cls["row"]("hyb", *a, dtype="f32x2"),
    "col x2 hyb": lambda cls, a: cls["col"]("hyb", *a, dtype="f32x2"),
    "row x2 height": lambda cls, a: cls["row"]("cmrs", *a, dtype="f32x2", height=4),
    "col x2 split": lambda cls, a: cls["col"]("ell", *a, dtype="f32x2", split=False),
    "row bad dtype": lambda cls, a: cls["row"]("csr", *a, dtype="f64"),
    "col bad dtype": lambda cls, a: cls["col"]("csr", *a, dtype="bf16"),
}


def classes(jax: bool) -> dict:
    if jax:
        from spmv_tpu.dist.overlap import ChunkedRowSpmv as JChunked
        from spmv_tpu.dist.ring import RingShardedSpmv as JRing
        from spmv_tpu.dist.sharded import ColShardedSpmv as JCol, RowShardedSpmv as JRow

        return {"row": JRow, "col": JCol, "ring": JRing, "chunked": JChunked}
    return {"row": RowShardedSpmv, "col": ColShardedSpmv, "ring": RingShardedSpmv,
            "chunked": ChunkedRowSpmv}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_refusals_are_jax(what):
    """JAX refuses these before it touches its mesh, so its side runs with
    no mesh at all."""
    info, r, c, v = triplets(300)
    args = (info.nrows, info.ncols, r, c, v)
    want = jax_raises(lambda: REFUSALS[what](classes(True), args + (None,)))
    got = jax_raises(lambda: REFUSALS[what](classes(False), args + (mesh_of(2),)))
    assert got == want


@pytest.mark.parametrize("key", ["pack", "panel_pack", "chunk", "bank"])
@pytest.mark.parametrize("kind", ["row", "col", "ring", "chunked"])
def test_tpu_layout_keys_raise_as_the_containers_do(kind, key):
    """JAX's TPU layout keys have no counterpart: the shard's container
    refuses them, with the port container's own error."""
    info, r, c, v = triplets(300)
    fmt = "hyb" if key == "panel_pack" else "csr"
    want = jax_raises(lambda: spmv_tpu_torch.from_coo(
        fmt, info.nrows, info.ncols, r, c, v, device="cpu", **{key: 2}))
    assert want[0] is TypeError
    got = jax_raises(lambda: classes(False)[kind](
        fmt, info.nrows, info.ncols, r, c, v, mesh_of(2), **{key: 2}))
    assert got == want


def test_row_x2_passes_sigma_and_refuses_pack_as_x2matrix():
    info, r, c, v = triplets(300)
    a = RowShardedSpmv("sell", info.nrows, info.ncols, r, c, v, mesh_of(2),
                       dtype="f32x2", sigma=256)
    assert a.x2 and a.shard.format == "sell"
    want = jax_raises(lambda: spmv_tpu_torch.X2Matrix.from_coo(
        "csr", info.nrows, info.ncols, r, c, v, device="cpu", pack=2))
    got = jax_raises(lambda: RowShardedSpmv("csr", info.nrows, info.ncols, r, c, v,
                                            mesh_of(2), dtype="f32x2", pack=2))
    assert got == want and got[0] is TypeError


def test_a_rank_outside_the_mesh_builds_nothing():
    info, r, c, v = triplets(300)
    outside = M.Mesh(group=None, size=2, rank=-1, device=CPU)
    assert not outside.member and mesh_of(2, 1).member
    for cls in classes(False).values():
        with pytest.raises(ValueError, match="outside the mesh"):
            cls("csr", info.nrows, info.ncols, r, c, v, outside)


def test_make_mesh_needs_enough_ranks():
    """JAX's ``ValueError`` and message form; a process with no group is
    one rank."""
    import jax

    from spmv_tpu.dist.mesh import make_mesh as jax_make_mesh

    n = len(jax.devices()) + 1
    with pytest.raises(ValueError) as e:
        jax_make_mesh(n)
    assert str(e.value) == f"need {n} devices, have {n - 1}"
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError) as e:
        M.make_mesh(2)
    assert str(e.value) == "need 2 devices, have 1"
    with pytest.raises(RuntimeError, match="init_distributed"):
        M.make_mesh(1)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl"),
                                            ("cuda:0", "nccl")])
def test_init_distributed_takes_the_backend_from_the_device(monkeypatch, device,
                                                            backend):
    """Chosen from the device named, never by probing for a card; a
    coordinator ``host:port`` becomes a TCP URL."""
    seen = {}
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, **kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: seen.update(card=i))
    M.init_distributed("127.0.0.1:29511", 4, 3, device=device)
    assert seen["backend"] == backend
    assert (seen["init_method"], seen["world_size"], seen["rank"]) == (
        "tcp://127.0.0.1:29511", 4, 3)
    assert ("card" in seen) == (backend == "nccl")
    seen.clear()
    M.init_distributed(device=device, backend="gloo")
    assert seen["backend"] == "gloo" and seen["init_method"] == "env://"


@pytest.mark.parametrize("t1", [60e-6, 1e-3])
@pytest.mark.parametrize("rows", [1024, 16384, 131072])
def test_analytic_model_is_jax_at_the_same_bandwidth(t1, rows):
    from spmv_tpu.bench.scaling import analytic_weak_scaling as jax_model
    from spmv_tpu_torch.bench.scaling import H100_NVLINK_BPS, analytic_weak_scaling

    got = analytic_weak_scaling(t1, rows_per_device=rows)
    assert got == jax_model(t1, rows_per_device=rows, ici_bw=H100_NVLINK_BPS)
    assert analytic_weak_scaling(t1, rows_per_device=rows, link_bw=90e9) == jax_model(
        t1, rows_per_device=rows, ici_bw=90e9)
    assert [m["devices"] for m in got] == [2, 4, 8, 16]


def test_no_tpu_figure_in_the_port():
    """The link model takes the H100's NVLink figure, never JAX's v5e ICI."""
    from pathlib import Path

    import spmv_tpu_torch.bench.scaling as S

    assert S.H100_NVLINK_BPS == 450e9 and not hasattr(S, "V5E_ICI_GBPS")
    src = Path(S.__file__).read_text()
    assert "V5E" not in src and "ici_bw" not in src


@pytest.mark.parametrize("kind", ["ring", "chunked"])
def test_solvers_refuse_ring_and_chunked_as_jax(kind):
    """JAX's solvers cannot compose these either: the same ``TypeError``
    and message (JAX's ``_operator`` named by the class's name)."""
    import spmv_tpu.solve as jax_solve
    from spmv_tpu_torch import solve

    info, r, c, v = triplets(256)
    a = classes(False)[kind]("csr", info.nrows, info.ncols, r, c, v, mesh_of(1))
    b = np.ones(info.nrows, np.float32)
    want = jax_raises(lambda: jax_solve.cg(a, b))
    for fn in (solve.cg, solve.bicgstab):
        assert jax_raises(lambda: fn(a, b)) == want
    assert jax_raises(lambda: solve.power_iteration(a)) == want


@pytest.mark.parametrize("what", ["x2", "bsr"])
def test_solvers_refuse_sharded_x2_and_bsr_as_jax(what):
    from spmv_tpu.dist.sharded import RowShardedSpmv as JRow
    from spmv_tpu_torch import solve

    info, r, c, v = triplets(256)
    kw = {"dtype": "f32x2"} if what == "x2" else {}
    fmt = "bsr" if what == "bsr" else "csr"
    for cls in (RowShardedSpmv, ColShardedSpmv) if what == "x2" else (RowShardedSpmv,):
        a = cls(fmt, info.nrows, info.ncols, r, c, v, mesh_of(1), **kw)
        want = jax_raises(lambda: JRow._matvec_traced(
            types.SimpleNamespace(x2=what == "x2", _bsr=what == "bsr"), None, None))
        assert jax_raises(lambda: solve.cg(a, np.ones(info.nrows))) == want
        assert want[0] is NotImplementedError


def test_sharded_containers_never_capture():
    """The graph loop is decided by type: a sharded container runs the
    eager loop on a card too; an engine container on a card captures."""
    import dataclasses

    from spmv_tpu_torch import solve

    info, r, c, v = triplets(256)
    a = RowShardedSpmv("csr", info.nrows, info.ncols, r, c, v, mesh_of(1))
    a.mesh = dataclasses.replace(a.mesh, device=torch.device("cuda"))
    assert solve._operator(a)[1:] == (torch.device("cuda"), False)
    single = spmv_tpu_torch.from_coo("csr", info.nrows, info.ncols, r, c, v,
                                     device="cpu")
    assert solve._operator(single)[2] is False
    on_card = types.SimpleNamespace(matvec=single.matvec, x2=False,
                                    dev=types.SimpleNamespace(device=torch.device("cuda")))
    assert solve._operator(on_card)[2] is True


@pytest.mark.parametrize("backend,device", [("gloo", "cuda"), ("nccl", "cpu")])
def test_bench_scaling_refuses_a_device_its_group_does_not_run(monkeypatch, capsys,
                                                               backend, device):
    """In a group that is up, ``--device`` must be its ranks' kind: gloo
    ranks run on the CPU, NCCL ranks on cards."""
    from spmv_tpu_torch import cli
    from spmv_tpu_torch.errors import ReturnCode

    monkeypatch.setattr(cli, "_device_error", lambda d: None)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: backend)
    assert cli.main(["bench", "--scaling", "--device", device]) == ReturnCode.DEVICE_ERROR
    err = capsys.readouterr().err
    assert f"--device {device}" in err and f"{backend} ranks run on" in err

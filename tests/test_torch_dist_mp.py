"""The port's sharded containers across real processes: D = 2 and D = 4
gloo ranks on the CPU (``_torch_dist_worker.py``), each running every case
of ``CASES`` at n = 700 and at the ragged n = 1021.

Each D is spawned once, in the module's fixture, as
``tests/test_multiprocess.py`` spawns JAX's workers; while they run, the
fixture builds the JAX package's same classes on ``make_mesh(2)`` (the
conftest's 8-device CPU mesh, Pallas in interpret mode) from the same
specs and triplets, at n = 1021 (interpret mode is slow). Each case is
then its own test:

* every rank returned the same whole y bit for bit;
* y against the fp64 oracle: float32 within ``KERNEL_TOL_ABS +
  fp32_rel_tol(k)·Σ|v||x|``, f32x2 within an absolute 1e-6;
* at D = 2 and n = 1021, against JAX's y within the sum of both
  packages' tolerances (JAX's as ``tests/test_dist.py`` holds it);
* the sharded cg against the port's single-process cg on the same matrix.

The CUDA side (NCCL at world size 1) runs in ``chip_smoke.py`` phase 9: no
machine here has two cards.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import _torch_dist_worker as W
from spmv_tpu_torch.oracle import (KERNEL_TOL_ABS, fp32_rel_tol, golden_spmv,
                                   row_scale)

WORLDS = (2, 4)
JAX_D, JAX_N = 2, 1021
TIMEOUT = 240
KEYS = [(n, c) for n in W.SIZES for c in W.CASES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, out: str) -> list:
    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return [subprocess.Popen(
        [sys.executable, worker, port, str(world), str(rank), out]
        + (["--scaling"] if world == JAX_D else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]


def _collect(procs: list) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs += [p.communicate()[0] for p in procs[len(outs):]]
        return [f"timed out after {TIMEOUT} s:\n{o}" for o in outs]
    return [o if p.returncode == 0 else f"exit {p.returncode}:\n{o}"
            for p, o in zip(procs, outs)]


def _jax_outputs() -> dict:
    """JAX's outputs of every non-cg case at n = JAX_N on its 2-device mesh."""
    from spmv_tpu import synth
    from spmv_tpu.api import spmm
    from spmv_tpu.dist.mesh import make_mesh
    from spmv_tpu.dist.overlap import ChunkedRowSpmv
    from spmv_tpu.dist.ring import RingShardedSpmv
    from spmv_tpu.dist.sharded import ColShardedSpmv, RowShardedSpmv

    classes = {"row": RowShardedSpmv, "col": ColShardedSpmv,
               "ring": RingShardedSpmv, "chunked": ChunkedRowSpmv}
    mesh = make_mesh(JAX_D)
    d = W.data(JAX_N, synth)
    return {c.name: np.asarray(W.run(W.build(classes, c, d, mesh), c, d, spmm))
            for c in W.CASES if not c.kind.startswith("cg")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: (outputs per rank, arrays per rank or None, the out dir)}, and
    JAX's outputs."""
    dirs = {D: str(tmp_path_factory.mktemp(f"dist{D}")) for D in WORLDS}
    procs = {D: _spawn(D, dirs[D]) for D in WORLDS}
    try:
        jax_out = _jax_outputs()
    finally:
        outs = {D: _collect(procs[D]) for D in WORLDS}
    got = {}
    for D in WORLDS:
        ok = all(f"rank {r}: done" in o for r, o in enumerate(outs[D]))
        arrays = ([dict(np.load(os.path.join(dirs[D], f"rank{r}.npz")))
                   for r in range(D)] if ok else None)
        got[D] = (outs[D], arrays, dirs[D])
    return got, jax_out


def _ranks(runs, D: int) -> list:
    got, _ = runs
    outs, arrays, _ = got[D]
    if arrays is None:
        pytest.fail(f"the D = {D} workers failed:\n" + "\n".join(
            f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
    return arrays


def _same_on_every_rank(arrays: list, key: str) -> np.ndarray:
    y = arrays[0][key]
    for r, a in enumerate(arrays[1:], 1):
        assert np.array_equal(a[key], y), f"{key}: rank {r} differs from rank 0"
    return y


def _check_columns(case, d, Y, jax_Y=None) -> None:
    """Each column of Y (y as one column) against the oracle, and against
    JAX's within both tolerances."""
    info = d["info"]
    v = d["v64"] if case.x2 else d["v"]
    X = (d["X"] if case.rhs > 1 else (d["x64"] if case.x2 else d["x"])[:, None])
    Y = Y.reshape(info.nrows, -1)
    k = int(np.bincount(d["r"], minlength=info.nrows).max())
    for j in range(X.shape[1]):
        want = golden_spmv(info.nrows, d["r"], d["c"], v, X[:, j])
        scale = row_scale(info.nrows, d["r"], d["c"], v, X[:, j])
        port_tol = 1e-6 if case.x2 else KERNEL_TOL_ABS + fp32_rel_tol(k) * scale
        err = np.abs(Y[:, j].astype(np.float64) - want)
        assert (err <= port_tol).all(), (
            f"{case.name} column {j}: max error {err.max():.3e} against the oracle")
        if jax_Y is None:
            continue
        # JAX held as tests/test_dist.py holds it: f32x2 within 1e-8 absolute,
        # float32 within 1e-4 + 1e-4·Σ|v||x|
        jax_tol = 1e-8 if case.x2 else 1e-4 + 1e-4 * scale
        jy = np.asarray(jax_Y, np.float64).reshape(info.nrows, -1)[:, j]
        assert (np.abs(jy - want) <= jax_tol).all(), f"{case.name}: JAX off the oracle"
        gap = np.abs(Y[:, j].astype(np.float64) - jy)
        assert (gap <= port_tol + jax_tol).all(), (
            f"{case.name} column {j}: port and JAX {gap.max():.3e} apart")


_DATA = {}


def _data(n: int) -> dict:
    from spmv_tpu_torch import synth

    if n not in _DATA:
        _DATA[n] = W.data(n, synth)
    return _DATA[n]


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("n,case", [k for k in KEYS if not k[1].kind.startswith("cg")],
                         ids=[f"{n}-{c.name}" for n, c in KEYS
                              if not c.kind.startswith("cg")])
def test_sharded_case(runs, D, n, case):
    arrays = _ranks(runs, D)
    y = _same_on_every_rank(arrays, f"{n}/{case.name}")
    d = _data(n)
    shape = (d["info"].nrows, case.rhs) if case.rhs > 1 else (d["info"].nrows,)
    assert y.shape == shape and y.dtype == (np.float64 if case.x2 else np.float32)
    jax_y = runs[1][case.name] if (D, n) == (JAX_D, JAX_N) else None
    _check_columns(case, d, y, jax_y)


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("n,case", [k for k in KEYS if k[1].kind.startswith("cg")],
                         ids=[f"{n}-{c.name}" for n, c in KEYS
                              if c.kind.startswith("cg")])
def test_sharded_cg(runs, D, n, case):
    """cg on the sharded container: the same k, x and residual on every
    rank; the single-process cg's iteration count, and an x within
    float32 rounding of its x, converged in fp64."""
    import spmv_tpu_torch
    from spmv_tpu_torch import solve

    arrays = _ranks(runs, D)
    key = f"{n}/{case.name}"
    x, k, res = (_same_on_every_rank(arrays, f"{key}/{f}") for f in ("x", "k", "res"))
    d = _data(n)
    rows, cols, vals = d["spd"]
    a = spmv_tpu_torch.from_coo("csr", n, n, rows, cols, vals, device="cpu")
    x1, k1, _ = solve.cg(a, d["b"], tol=1e-5, maxiter=400)
    assert int(k) == k1
    np.testing.assert_allclose(x, x1.numpy(), rtol=1e-5, atol=1e-7)
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    rel = np.linalg.norm(dense @ x.astype(np.float64) - d["b"]) / np.linalg.norm(d["b"])
    assert rel <= 1e-4 and float(res) >= 0


@pytest.mark.parametrize("D", WORLDS)
def test_workers_import_neither_jax_nor_the_jax_package(runs, D):
    _ranks(runs, D)
    for r, out in enumerate(runs[0][D][0]):
        assert f"rank {r}: done" in out and "no jax, no spmv_tpu" in out


def test_bench_scaling_on_two_ranks(runs):
    """``bench --scaling --device cpu --rows-per-device 1024`` under two
    ranks: two simulated points; rank 0 prints and writes, rank 1 neither."""
    _ranks(runs, JAX_D)
    outs, _, out_dir = runs[0][JAX_D]
    with open(os.path.join(out_dir, "scaling0.json")) as f:
        rep = json.load(f)
    assert not os.path.exists(os.path.join(out_dir, "scaling1.json"))
    pts = rep["points"]
    assert rep["simulated"] is True and rep["backend"] == "gloo" and rep["card"] is None
    assert [p["devices"] for p in pts] == [1, 2]
    assert pts[0]["efficiency"] == 1.0 and pts[1]["nrows"] == 2 * pts[0]["nrows"]
    assert pts[0]["nrows"] == W.SCALING_ROWS
    assert all(p["ms_per_spmv"] > 0 for p in pts)
    assert "modeled_efficiency" not in rep
    assert "D=  2:" in outs[0] and "SIMULATED" in outs[0] and "D=  1:" not in outs[1]

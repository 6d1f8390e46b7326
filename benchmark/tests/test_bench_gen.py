"""The benchmark's generators, its seeds, and cells added as files."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import matrices, spec
from benchmark.jobs import Jobs
from benchmark.session import JobSeeds

from .conftest import ROOT


def _configs(root):
    return {c["name"]: json.loads((root / c["file"]).read_text())
            for c in json.loads((root / "BENCHMARK.json").read_text())["configs"]}


def _dense(m: matrices.Matrix) -> np.ndarray:
    dense = np.zeros((m.nrows, m.ncols))
    np.add.at(dense, (m.rows, m.cols), m.vals.astype(np.float64))
    return dense


@pytest.mark.parametrize("grid", [(5, 4, 3), (3, 3, 3), (7, 2, 1)])
def test_hpcg_stencil_is_hpcgs(grid):
    """Row (iz·ny + iy)·nx + ix holds its 3×3×3 cube's points inside the
    grid, 26 on the diagonal and -1 elsewhere, in (row, col) order."""
    nx, ny, nz = grid
    cfg = {"name": "g", "generator": "hpcg_stencil", "nx": nx, "ny": ny, "nz": nz,
           "format": "csr", "dtype": "float32"}
    m = matrices.build(cfg, 0, "cpu")
    n = nx * ny * nz
    want = np.zeros((n, n))
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                row = (iz * ny + iy) * nx + ix
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            jx, jy, jz = ix + sx, iy + sy, iz + sz
                            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                                want[row, (jz * ny + jy) * nx + jx] = -1.0
                want[row, row] = 26.0
    assert np.array_equal(_dense(m), want)
    assert m.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert np.all(np.diff(m.rows.astype(np.int64) * n + m.cols) > 0)
    assert m.vals.dtype == np.float32 and m.rows.dtype == np.int32


def test_hpcg_configuration_counts():
    cfg = _configs(ROOT)["hpcg-104"]
    assert cfg["nrows"] == cfg["nx"] * cfg["ny"] * cfg["nz"]
    assert cfg["nnz"] == (3 * cfg["nx"] - 2) * (3 * cfg["ny"] - 2) * (3 * cfg["nz"] - 2)


def _kron(**kw):
    cfg = {"name": "k", "generator": "kronecker", "scale": 9, "edgefactor": 16,
           "initiator": [0.57, 0.19, 0.19], "graph_seed": 0, "format": "csr",
           "dtype": "float32"}
    cfg.update(kw)
    return cfg


def test_kronecker_is_a_weighted_undirected_graph():
    m = matrices.build(_kron(), 3, "cpu")
    assert m.nrows == m.ncols == 512
    dense = _dense(m)
    assert np.array_equal(dense, dense.T) and (m.vals > 0).all()
    assert np.all(np.diff(m.rows.astype(np.int64) * m.nrows + m.cols) > 0)
    # each edge's weight lies in [0, 1) on the grid of 2^-24; an entry sums
    # the weights of its repeated edges, so the total is below the M edges
    # counted once per direction, self-loops once
    assert np.array_equal(m.vals * 2.0 ** 24, np.round(m.vals * 2.0 ** 24))
    assert dense.sum() < 2 * 16 * 512


def test_kronecker_follows_the_initiator():
    """At scale 1 the edges fall in the initiator's quadrants with its
    probabilities, before the labels are permuted: the two labels' counts
    of each kind of edge agree whatever the permutation."""
    gen = spec.generator(ROOT, "kronecker")
    n, _, rows, cols, vals = gen.make(_kron(scale=1, edgefactor=200_000), 1, "cpu")
    dense = torch.zeros(2, 2, dtype=torch.float64)
    dense[rows, cols] = vals.double()
    # the expected weight per edge is (1 - 2^-24) / 2; off-diagonal edges
    # are stored both ways, so B + C of the edges lie on each off-diagonal
    per_edge = 400_000 * (1 - 2.0 ** -24) / 2
    diag = sorted(float(dense[i, i]) / per_edge for i in range(2))
    assert diag == pytest.approx([0.05, 0.57], abs=0.01)
    assert float(dense[0, 1]) / per_edge == pytest.approx(0.38, abs=0.01)


def test_seed_moves_weights_not_edges():
    a, b, a2 = (matrices.build(_kron(), s, "cpu") for s in (1, 2 ** 31 + 5, 1))
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols)
    assert not np.array_equal(a.vals, b.vals) and np.array_equal(a.vals, a2.vals)
    c = matrices.build(_kron(graph_seed=1), 1, "cpu")
    assert c.nnz != a.nnz or not np.array_equal(c.cols, a.cols)


def test_seed_does_not_move_hpcg(tiny_root):
    cfg = _configs(tiny_root)["hpcg-104"]
    a, b = (matrices.build(cfg, s, "cpu", tiny_root) for s in (1, 2 ** 31 + 5))
    assert np.array_equal(a.vals, b.vals) and np.array_equal(a.cols, b.cols)


def test_stated_counts_are_checked():
    cfg = {"name": "g", "generator": "hpcg_stencil", "nx": 3, "ny": 3, "nz": 3,
           "format": "csr", "dtype": "float32", "nnz": 1}
    with pytest.raises(ValueError, match="nnz is 343"):
        matrices.build(cfg, 0, "cpu")


def test_seed_moves_jobs(tiny_root):
    cell = spec.load_cell("hpcg104.cg", tiny_root)
    seeds = JobSeeds(matrices.seed_streams(7)["jobs"])
    first = [next(seeds) for _ in range(5)]
    again = JobSeeds(matrices.seed_streams(7)["jobs"])
    assert [next(again) for _ in range(5)] == first
    other = JobSeeds(matrices.seed_streams(8)["jobs"])
    assert [next(other) for _ in range(5)] != first
    jobs = Jobs(spec.kind(tiny_root, "cg"), cell.traffic, None, 100, "cpu")
    b1, b2 = jobs.inputs(first[0])["b"], jobs.inputs(first[1])["b"]
    assert not torch.equal(b1, b2) and torch.equal(b1, jobs.inputs(first[0])["b"])


# a job kind of its own, as a later cell adds one: y = A·x on the port's
# container, judged by the worst relative gap to the reference's y
SPMV_KIND = '''
import torch

NUMBERS = ("spmv_gap",)


def prepare(config):
    pass


def inputs(seed, n, gen):
    gen.manual_seed(seed)
    return {"x": torch.randn(n, generator=gen, device=gen.device)}


def call(a, inp, traffic):
    return {"y": a.matvec(inp["x"])}


def ok(out, traffic):
    return bool(torch.isfinite(out["y"]).all())


def spmvs(out, traffic):
    return 1


def iterations(out, traffic):
    return 1


def numbers(op, kept, traffic):
    gap = 0.0
    for job in kept:
        ref = op.matvec(job["inputs"]["x"])
        diff = torch.linalg.vector_norm(job["out"]["y"].double() - ref)
        gap = max(gap, float(diff / torch.linalg.vector_norm(ref)))
    return {"spmv_gap": gap}
'''


@pytest.mark.parametrize("new_kind", [False, True])
def test_a_new_cell_is_found_by_name(tmp_path, tiny_root, new_kind):
    """A configuration, a traffic mix, limits and (``new_kind``) a job kind
    added as new files, with entries in BENCHMARK.json, run without an
    edit to any file already there."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((root / "benchmark/configs/kron-s22.json").read_text())
    cfg.update(name="kron-ef8", edgefactor=8)
    (root / "benchmark/configs/kron-ef8.json").write_text(json.dumps(cfg))
    if new_kind:
        (root / "benchmark/kinds/spmv.py").write_text(SPMV_KIND)
        traffic, limits = {"job": "spmv", "sample": 3}, {"spmv_gap": 1e-5}
    else:
        traffic = {"job": "power_iteration", "iters": 10, "sample": 2}
        limits = json.loads((root / "benchmark/limits/kron22.power.json").read_text())
    (root / "benchmark/traffic/mix.json").write_text(json.dumps(traffic))
    (root / "benchmark/limits/kron8.mix.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "kron-ef8", "source": "x", "reduced": [],
                             "file": "benchmark/configs/kron-ef8.json", "why": "x"})
    bench["workloads"].append({"name": "kron8.mix", "config": "kron-ef8",
                               "traffic": "mix", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kron22.power" in m.get("workloads", []):
            m["workloads"].append("kron8.mix")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from benchmark import run

    result = run.run_cell("kron8.mix", 9, 0.2, False, root=root, device="cpu",
                          note=lambda *a: None)
    assert result["correct"] and set(result["metrics"]) == {"gnnz_per_s", "setup_s"}
    assert set(result["checks"]) == {"failed"} | set(limits)
    assert all(p.read_bytes() == data for p, data in before.items())

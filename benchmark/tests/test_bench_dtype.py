"""A configuration's ``dtype``: the port's container, the inputs and the
traced ``matvec``'s x, the roofline's width and the control's precision
that it picks."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import readings, run, spec
from benchmark.jobs import Window
from benchmark.matrices import Matrix
from benchmark.reference import plain
from benchmark.roofline import VALUE_BYTES, least_csr_bytes, roofline_pct
from benchmark.session import open_session

from .conftest import ROOT
from .test_bench_gen import SPMV_KIND

GRID = {"nx": 9, "ny": 8, "nz": 7}


def _root(tmp_path, tiny_root, dtype: str, traffic: str = "spmv"):
    """``tiny_root`` with the configuration ``hpcg-dt``, HPCG's stencil on
    a small grid at ``dtype``, and its cell ``hpcg.dt`` under ``traffic``:
    ``spmv`` (y = A·x, a job kind added as a file) or ``cg``. The cell
    reports the metrics of ``hpcg104.power`` or of ``hpcg104.cg``."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    cfg = json.loads((root / "benchmark/configs/hpcg-104.json").read_text())
    cfg.update(GRID, name="hpcg-dt", dtype=dtype)
    (root / "benchmark/configs/hpcg-dt.json").write_text(json.dumps(cfg))
    if traffic == "spmv":
        (root / "benchmark/kinds/spmv.py").write_text(SPMV_KIND)
        (root / "benchmark/traffic/spmv.json").write_text(json.dumps({"job": "spmv",
                                                                      "sample": 3}))
        limits, like = {"spmv_gap": 1e-5}, "hpcg104.power"
    else:
        limits = json.loads((root / "benchmark/limits/hpcg104.cg.json").read_text())
        like = "hpcg104.cg"
    (root / "benchmark/limits/hpcg.dt.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hpcg-dt", "source": "x", "reduced": [],
                             "file": "benchmark/configs/hpcg-dt.json", "why": "x"})
    bench["workloads"].append({"name": "hpcg.dt", "config": "hpcg-dt",
                               "traffic": traffic, "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append("hpcg.dt")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_dtype_picks_the_container(tmp_path, tiny_root, dtype):
    import spmv_tpu_torch

    cell = spec.load_cell("hpcg.dt", _root(tmp_path, tiny_root, dtype))
    session = open_session(cell, 2 ** 31 + 3, "cpu")
    m = session.matrix
    assert set(session.spans) == {"port_import", "matrix", "from_coo", "warmup"}
    if dtype == "float32":  # the parent's call and container
        want = spmv_tpu_torch.from_coo(m.format, m.nrows, m.ncols, m.rows, m.cols, m.vals,
                                       device="cpu")
        assert type(session.a) is type(want) is spmv_tpu_torch.CSRMatrix
        torch.manual_seed(5)
        x = run.matvec_x(session, "cpu")
        torch.manual_seed(5)
        assert torch.equal(x, torch.randn(m.ncols, device="cpu"))
        return
    assert isinstance(session.a, spmv_tpu_torch.X2Matrix)
    x = run.matvec_x(session, "cpu")
    assert x.dtype == torch.float64
    y = session.a.matvec(x)
    ref = plain.Operator(m.nrows, m.rows, m.cols, m.vals, dtype=torch.float64,
                         device="cpu").matvec(x)
    assert y.dtype == torch.float64
    # fp64 against fp64 over at most 27 terms a row: the tolerance is for
    # the order of the sums alone
    gap = torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)
    assert float(gap) <= 1e-12


def test_a_float64_cell_runs(tmp_path, tiny_root):
    root = _root(tmp_path, tiny_root, "float64")
    result = run.run_cell("hpcg.dt", 2 ** 31 + 9, 0.2, False, root=root, device="cpu",
                          note=lambda *a: None)
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"gnnz_per_s", "setup_s"}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_draws_b_in_the_configuration_dtype(dtype):
    kind = spec.kind(ROOT, "cg")
    assert kind.DTYPE is torch.float32  # each load starts from float32
    kind.prepare({"dtype": dtype})
    seed, n = 2 ** 31 + 17, 1000
    b = kind.inputs(seed, n, torch.Generator("cpu"))["b"]
    # for float32, the parent's call
    want = torch.randn(n, generator=torch.Generator("cpu").manual_seed(seed),
                       device="cpu", dtype=getattr(torch, dtype))
    assert b.dtype == want.dtype and torch.equal(b, want)


def test_an_unknown_dtype_is_refused(tmp_path, tiny_root):
    root = _root(tmp_path, tiny_root, "float16")
    with pytest.raises(ValueError, match="'float32' or 'float64'"):
        spec.load_cell("hpcg.dt", root)


@pytest.mark.parametrize("config,width,want", [("hpcg-104", 4, 251_826_372),
                                               ("kron-s22", 4, 1_076_802_612),
                                               ("hpcg-104", 8, 379_989_284)])
def test_least_bytes(config, width, want):
    cfg = json.loads((ROOT / "benchmark/configs" / f"{config}.json").read_text())
    n, nnz = cfg["nrows"], cfg["nnz"]
    assert least_csr_bytes(n, n, nnz, width) == want
    if width == 4:  # the parent's count
        assert least_csr_bytes(n, n, nnz) == nnz * 8 + (n + 1) * 4 + n * 4 + n * 4


@pytest.mark.parametrize("name", ["spmv_roofline.cg", "spmv_roofline.power"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rooflines_count_the_dtype_width(name, dtype):
    m = Matrix("m", 1000, 1000, None, torch.zeros(5000).numpy(), None, "csr", dtype)
    ctx = run.Context(matrix=m, window=Window(), matvec_s=250e-6)
    nbytes = least_csr_bytes(1000, 1000, 5000, VALUE_BYTES[dtype])
    assert nbytes == 5000 * (VALUE_BYTES[dtype] + 4) + 1001 * 4 + 2000 * VALUE_BYTES[dtype]
    assert spec.metric_reader(ROOT, name)(ctx) == roofline_pct(nbytes, 250e-6)


@pytest.mark.parametrize("dtype,control", [("float32", torch.bfloat16),
                                           ("float64", torch.float32)])
def test_the_control_is_the_precision_below(tmp_path, tiny_root, monkeypatch, dtype,
                                            control):
    """The control's operator, and the jobs' b in the configuration's
    dtype, as a run of the same seed draws it."""
    made, kept = [], []

    class Operator(plain.Operator):
        def __init__(self, *a, dtype, **kw):
            made.append(dtype)
            super().__init__(*a, dtype=dtype, **kw)

    def control_jobs(*a):
        kept.extend(real_jobs(*a))
        return kept

    real_jobs = readings.control_jobs
    monkeypatch.setattr(readings.plain, "Operator", Operator)
    monkeypatch.setattr(readings, "control_jobs", control_jobs)
    cell = spec.load_cell("hpcg.dt", _root(tmp_path, tiny_root, dtype, "cg"))
    readings.control_readings(cell, 3, "cpu")
    assert made == [control] and readings.CONTROL[dtype] is control
    assert kept and all(job["inputs"]["b"].dtype == getattr(torch, dtype) for job in kept)

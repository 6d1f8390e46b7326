"""The profiled stretch's reading, and the per-layer metrics' readers."""

from __future__ import annotations

import pytest
import torch

from benchmark import spec, trace
from benchmark.jobs import Window
from benchmark.matrices import Matrix
from benchmark.roofline import least_csr_bytes, roofline_pct
from benchmark.run import Context

from .conftest import ROOT

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, kind, device, start_us, dur_us):
        self._v = (name, kind, device, int(start_us * 1000), int(dur_us * 1000))

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def _events():
    return [
        Ev("bench.stretch", "user_annotation", CPU, 0, 1000),
        Ev("bench.stretch", "gpu_user_annotation", CUDA, 0, 1000),
        Ev("cudaGraphLaunch", "cuda_runtime", CPU, 10, 30),
        Ev("void seg_spmv_tiles_kernel<float>", "kernel", CUDA, 50, 300),
        Ev("void carry_fixup_kernel<float>", "kernel", CUDA, 340, 10),
        Ev("aten::item", "cpu_op", CPU, 400, 200),
        Ev("cudaStreamSynchronize", "cuda_runtime", CPU, 420, 150),
        Ev("Memcpy DtoH", "gpu_memcpy", CUDA, 580, 5),
        Ev("void seg_spmv_tiles_kernel<float>", "kernel", CUDA, 600, 300),
    ]


def test_busy_idle_and_breakdown():
    s = trace.read(_events(), ["seg_spmv_tiles", "carry_fixup"], trace.Stretch())
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(605e-6)  # 50-350, 580-585, 600-900 µs
    assert s.idle_pct == pytest.approx(39.5)
    assert s.device_ops[0] == ["void seg_spmv_tiles_kernel<float>", pytest.approx(600e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(230e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(50e-6)
    assert gaps["aten::item"] == pytest.approx(15e-6)
    assert gaps["(no host operation)"] == pytest.approx(100e-6)
    assert s.kernels_recorded == 3
    s.kernels_expected = 3
    assert s.complete
    s.kernels_expected = 4
    assert not s.complete


def test_nothing_recorded():
    s = trace.read([e for e in _events() if e.device_type() == CPU], ["seg_spmv_tiles"],
                   trace.Stretch())
    assert s.busy_s == 0 and not s.complete
    ctx = Context(stretch=s)
    for name in ("device_idle_pct.cg", "device_idle_pct.power"):
        assert spec.metric_reader(ROOT, name)(ctx) is None


def _ctx():
    w = Window()
    w.seconds, w.times, w.iters, w.spmvs = 2.0, [0.01] * 100 + [0.02] * 10, [16] * 110, 1870
    m = Matrix("m", 1000, 1000, None, torch.zeros(5000).numpy(), None, "csr", "float32")
    return Context(setup_s=3.5, spans={"from_coo": 1.25}, window=w, matrix=m,
                   matvec_s=250e-6)


def test_readers():
    ctx = _ctx()
    read = {n: spec.metric_reader(ROOT, n)(ctx) for n in
            ("setup_s", "solves_per_s", "solve_p95_ms", "gnnz_per_s", "plan_build_s",
             "spmv_roofline.cg", "spmv_roofline.power", "cg_iters", "solver_us_per_iter")}
    assert read["setup_s"] == 3.5 and read["plan_build_s"] == 1.25
    assert read["solves_per_s"] == pytest.approx(55.0)
    assert read["solve_p95_ms"] == pytest.approx(20.0)
    assert read["gnnz_per_s"] == pytest.approx(5000 * 1870 / 2.0 / 1e9)
    assert read["cg_iters"] == 16
    assert read["solver_us_per_iter"] == pytest.approx(2e6 / 1760 - 250)
    nbytes = least_csr_bytes(1000, 1000, 5000)
    assert nbytes == 5000 * 8 + 1001 * 4 + 2 * 1000 * 4
    assert read["spmv_roofline.cg"] == pytest.approx(roofline_pct(nbytes, 250e-6))
    assert read["spmv_roofline.cg"] == pytest.approx(100 * nbytes / 3.35e12 / 250e-6)


def test_readers_with_nothing_to_read():
    ctx = _ctx()
    ctx.matvec_s = None
    ctx.window.iters, ctx.window.times, ctx.window.spmvs = [], [], 0
    for n in ("spmv_roofline.cg", "cg_iters", "solver_us_per_iter", "solves_per_s",
              "solve_p95_ms", "gnnz_per_s"):
        assert spec.metric_reader(ROOT, n)(ctx) is None


@pytest.mark.gpu
def test_a_traced_run_on_the_card(tiny_root, cuda):
    from benchmark import run

    r = run.run_cell("kron22.power", 3, 0.5, True, root=tiny_root, device="cuda",
                     note=lambda *a: None)
    assert r["correct"] and r["device"]["busy_s"] > 0
    assert "spmv_roofline.power" in r["metrics"] and "breakdown" in r


class OldEv(Ev):
    """An event of a PyTorch whose kineto events do not name their activity."""

    activity_type = property()  # hasattr() is False

    def is_user_annotation(self):
        return self._v[1].endswith("user_annotation")


def test_events_without_activity_names():
    old = [OldEv(*e._v[:2], e._v[2], e._v[3] / 1000, e._v[4] / 1000) for e in _events()]
    s = trace.read(old, ["seg_spmv_tiles", "carry_fixup"], trace.Stretch())
    assert s.busy_s == pytest.approx(605e-6) and s.kernels_recorded == 3

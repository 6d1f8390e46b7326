"""The comparison that decides ``correct`` refuses the control and the
faults a cell can have, and passes the program.

The control is the plain reference in the program's place, computed in
bfloat16. The faults are planted in the program underneath a run that
skips the look for a card: a step that returns its state unchanged, and an
answer altered where it is produced. The cells run on one card, with no
batch, so no fault leaves out half a batch or an exchange between chips.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import check, run, spec
from benchmark.readings import control_readings, program_readings

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(tiny_root, workload, seed=21):
    return run.run_cell(workload, seed, 0.3, False, root=tiny_root, device="cpu",
                        note=lambda *a: None)


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_passes(tiny_root, workload):
    cell = spec.load_cell(workload, tiny_root)
    numbers = program_readings(cell, 5, 0.3, "cpu")
    assert numbers["failed"] == 0
    assert all(numbers[k] <= v for k, v in cell.limits.items())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(tiny_root, workload, seed):
    cell = spec.load_cell(workload, tiny_root)
    numbers = control_readings(cell, seed, "cpu")
    correct, _ = check.judge({k: numbers[k] for k in cell.limits}, 0, cell.limits)
    assert not correct


def _unchanged(monkeypatch):
    """Every solver step returns its state as it got it."""
    from spmv_tpu_torch import solve

    real_cg, real_power = solve.cg, solve.power_iteration

    def cg(a, b, **kw):
        x, k, res = real_cg(a, b, **kw)
        return torch.zeros_like(x), k, res

    def power_iteration(a, *, iters, seed, **kw):
        lam, v = real_power(a, iters=iters, seed=seed, **kw)
        gen = torch.Generator(v.device).manual_seed(seed)
        v0 = torch.randn(v.numel(), generator=gen, device=v.device, dtype=torch.float32)
        return float(v0 @ v0), v0

    monkeypatch.setattr(solve, "cg", cg)
    monkeypatch.setattr(solve, "power_iteration", power_iteration)


def _altered(monkeypatch):
    """One entry of each answer altered where the solver returns it: x's
    middle entry by 1 (a block X's, in its storage's order), v's by 0.01
    (v has norm 1)."""
    from spmv_tpu_torch import solve

    real_cg, real_power = solve.cg, solve.power_iteration

    def cg(a, b, **kw):
        x, k, res = real_cg(a, b, **kw)
        x.view(-1)[x.numel() // 2] += 1.0
        return x, k, res

    def power_iteration(a, **kw):
        lam, v = real_power(a, **kw)
        v[v.numel() // 2] += 0.01
        return lam, v

    monkeypatch.setattr(solve, "cg", cg)
    monkeypatch.setattr(solve, "power_iteration", power_iteration)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_a_fault_fails(tiny_root, workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(tiny_root, workload)
    assert result["correct"] is False
    assert list(result)[-1] == "checks"

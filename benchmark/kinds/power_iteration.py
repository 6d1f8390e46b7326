"""power_iteration: ``solve.power_iteration(a, iters=iters, seed=<the job's
seed>)``, a fixed count of iterations.

The reference runs the same iterations in float64 from the same v0, drawn
by ``torch.Generator(device).manual_seed(seed)`` as the program's
documented rule draws it. ``power_vec_gap`` is the worst ‖v − v_ref‖ (both
of norm 1) over the checked jobs; ``power_lambda_gap`` the worst
|λ − λ_ref| / |λ_ref|.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import plain

__all__ = ["NUMBERS", "prepare", "inputs", "call", "ok", "spmvs", "iterations",
           "numbers", "control"]

NUMBERS = ("power_vec_gap", "power_lambda_gap")


def prepare(config: dict) -> None:
    if config["dtype"] != "float32":
        raise ValueError(f"the port's power_iteration runs float32, not {config['dtype']}")


def inputs(seed: int, n: int, gen: torch.Generator) -> dict:
    return {"seed": seed}


def call(a, inp: dict, traffic: dict) -> dict:
    from spmv_tpu_torch import solve

    lam, v = solve.power_iteration(a, iters=int(traffic["iters"]), seed=inp["seed"])
    return {"lam": lam, "v": v}


def ok(out: dict, traffic: dict) -> bool:
    return math.isfinite(out["lam"])


def spmvs(out: dict, traffic: dict) -> int:
    """The iterations and the Rayleigh quotient's ``matvec``."""
    return int(traffic["iters"]) + 1


def iterations(out: dict, traffic: dict) -> int:
    return int(traffic["iters"])


def _v0(op: plain.Operator, seed: int) -> torch.Tensor:
    gen = torch.Generator(op.device).manual_seed(seed)
    return torch.randn(op.n, generator=gen, device=op.device, dtype=torch.float32)


def numbers(op: plain.Operator, kept: list, traffic: dict) -> dict:
    vec = lam = 0.0
    for job in kept:
        lam_ref, v_ref = plain.power_iteration(op, _v0(op, job["inputs"]["seed"]),
                                               iters=int(traffic["iters"]))
        v = job["out"]["v"].to(op.device, torch.float64)
        gap_v = float(torch.linalg.vector_norm(v - v_ref))
        gap_l = abs(job["out"]["lam"] - lam_ref) / max(abs(lam_ref), 1e-300)
        vec = max(vec, gap_v if math.isfinite(gap_v) else math.inf)
        lam = max(lam, gap_l if math.isfinite(gap_l) else math.inf)
    return {"power_vec_gap": vec, "power_lambda_gap": lam}


def control(op: plain.Operator, inp: dict, traffic: dict) -> dict:
    """The job answered by the plain reference at ``op``'s precision."""
    lam, v = plain.power_iteration(op, _v0(op, inp["seed"]), iters=int(traffic["iters"]))
    return {"lam": lam, "v": v.float()}

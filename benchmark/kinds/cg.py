"""cg: a solve to tolerance, ``solve.cg(a, b, tol=tol, maxiter=maxiter)``
from x0 = 0, ``b`` standard normal from the job's seed in the
configuration's dtype (``prepare``), made on the device by a
``torch.Generator`` before the call. Whether the port's cg takes the
float64 configuration's container is the port's to say.

A solve that stops at ``maxiter`` has failed. ``cg_resid`` is the worst
relative residual ‖b − A·x‖ / ‖b‖ of the program's x over the checked
solves, taken by the plain reference in float64.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import plain

__all__ = ["NUMBERS", "DTYPE", "prepare", "inputs", "call", "ok", "spmvs", "iterations",
           "weight", "numbers", "control"]

NUMBERS = ("cg_resid",)

# b's type: ``prepare`` sets it from the configuration; each load of this
# module (``benchmark.spec.kind``) starts from float32.
DTYPE = torch.float32


def prepare(config: dict) -> None:
    global DTYPE
    DTYPE = getattr(torch, config["dtype"])


def inputs(seed: int, n: int, gen: torch.Generator) -> dict:
    gen.manual_seed(seed)
    return {"seed": seed, "b": torch.randn(n, generator=gen, device=gen.device,
                                           dtype=DTYPE)}


def call(a, inp: dict, traffic: dict) -> dict:
    from spmv_tpu_torch import solve

    x, k, res = solve.cg(a, inp["b"], tol=float(traffic["tol"]), maxiter=int(traffic["maxiter"]))
    return {"x": x, "k": k, "res": res}


def ok(out: dict, traffic: dict) -> bool:
    """Converged (stopped before ``maxiter``) with a finite residual."""
    return out["k"] < int(traffic["maxiter"]) and math.isfinite(out["res"])


def spmvs(out: dict, traffic: dict) -> int:
    """k iterations and r0 = b − A·x0."""
    return out["k"] + 1


def iterations(out: dict, traffic: dict) -> int:
    return out["k"]


def weight(out: dict) -> int:
    """The solve of most weight joins the checked sample."""
    return out["k"]


def numbers(op: plain.Operator, kept: list, traffic: dict) -> dict:
    worst = 0.0
    for job in kept:
        b = job["inputs"]["b"].to(op.device, torch.float64)
        x = job["out"]["x"].to(op.device, torch.float64)
        resid = float(torch.linalg.vector_norm(b - op.matvec(x)) / torch.linalg.vector_norm(b))
        worst = max(worst, resid if math.isfinite(resid) else math.inf)
    return {"cg_resid": worst}


def control(op: plain.Operator, inp: dict, traffic: dict) -> dict:
    """The job answered by the plain reference at ``op``'s precision."""
    x, k = plain.cg(op, inp["b"], tol=float(traffic["tol"]), maxiter=int(traffic["maxiter"]))
    return {"x": x.float(), "k": k}

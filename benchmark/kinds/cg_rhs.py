"""cg_rhs: a solve of a block of right-hand sides to tolerance,
``solve.cg(a, B, tol=tol, maxiter=maxiter)`` from X0 = 0, B of shape (n, R)
standard normal from the job's seed, made on the device by a
``torch.Generator`` before the call. Each column runs its own recurrence
and stop; the columns share one SpMM an iteration.

R is the configuration's ``rhs`` (``prepare``). A solve in which any column
stops at ``maxiter`` has failed. The job's iterations are the loop's, its
slowest column's; its SpMVs are the SpMMs it asked for, those iterations
and R0 = B − A·X0. ``cg_resid`` is the worst relative residual
‖b_j − A·x_j‖ / ‖b_j‖ over the checked solves and every column of each,
taken by the plain reference in float64; the control solves the columns
one by one.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import plain

__all__ = ["NUMBERS", "RHS", "prepare", "inputs", "call", "ok", "spmvs", "iterations",
           "weight", "numbers", "control"]

NUMBERS = ("cg_resid",)

# The block's width: ``prepare`` sets it from the configuration; each load
# of this module (``benchmark.spec.kind``) starts from the one the
# benchmark's configuration states.
RHS = 4


def prepare(config: dict) -> None:
    global RHS
    if config["dtype"] != "float32":
        raise ValueError(f"the port's cg runs float32, not {config['dtype']}")
    RHS = int(config["rhs"])


def inputs(seed: int, n: int, gen: torch.Generator) -> dict:
    gen.manual_seed(seed)
    return {"seed": seed, "b": torch.randn((n, RHS), generator=gen, device=gen.device,
                                           dtype=torch.float32)}


def call(a, inp: dict, traffic: dict) -> dict:
    from spmv_tpu_torch import solve

    x, k, res = solve.cg(a, inp["b"], tol=float(traffic["tol"]), maxiter=int(traffic["maxiter"]))
    return {"x": x, "k": k, "res": res}


def ok(out: dict, traffic: dict) -> bool:
    """Every column converged (stopped before ``maxiter``) with a finite
    residual."""
    return (max(out["k"]) < int(traffic["maxiter"])
            and all(math.isfinite(r) for r in out["res"]))


def spmvs(out: dict, traffic: dict) -> int:
    """The loop's iterations and R0 = B − A·X0: one SpMM each."""
    return max(out["k"]) + 1


def iterations(out: dict, traffic: dict) -> int:
    """The loop's iterations: its slowest column's."""
    return max(out["k"])


def weight(out: dict) -> int:
    """The solve of most weight joins the checked sample."""
    return max(out["k"])


def numbers(op: plain.Operator, kept: list, traffic: dict) -> dict:
    worst = 0.0
    for job in kept:
        B = job["inputs"]["b"].to(op.device, torch.float64)
        X = job["out"]["x"].to(op.device, torch.float64)
        for j in range(B.shape[1]):
            b = B[:, j].contiguous()
            resid = float(torch.linalg.vector_norm(b - op.matvec(X[:, j].contiguous()))
                          / torch.linalg.vector_norm(b))
            worst = max(worst, resid if math.isfinite(resid) else math.inf)
    return {"cg_resid": worst}


def control(op: plain.Operator, inp: dict, traffic: dict) -> dict:
    """The job answered by the plain reference at ``op``'s precision, one
    column at a time."""
    xs, ks = [], []
    for j in range(inp["b"].shape[1]):
        x, k = plain.cg(op, inp["b"][:, j], tol=float(traffic["tol"]),
                        maxiter=int(traffic["maxiter"]))
        xs.append(x.float())
        ks.append(k)
    return {"x": torch.stack(xs, 1), "k": ks}

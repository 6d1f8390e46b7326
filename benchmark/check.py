"""How a cell decides ``correct``: the answers the window produced, judged
by the plain reference in float64.

The job kind (``benchmark/kinds/<job>.py``) names the numbers it compares
and computes them. Each number is the worst over the answers checked, and
``benchmark/limits/<workload>.json`` holds its limit. ``failed`` counts
the jobs of the window that raised or that say they failed (a solve not
converged, a non-finite result). It has the limit 0.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.plain import Operator

__all__ = ["judge", "numbers"]


def numbers(matrix, kept: list, kind, traffic: dict, device) -> dict:
    """The kind's compared numbers over the ``kept`` jobs, against the plain
    reference built from ``matrix``'s triplets in float64."""
    op = Operator(matrix.nrows, matrix.rows, matrix.cols, matrix.vals,
                  dtype=torch.float64, device=device)
    return kind.numbers(op, kept, traffic)


def judge(values: dict, failed: int, limits: dict) -> tuple[bool, dict]:
    """``correct`` and every compared number beside its limit."""
    checks = {"failed": {"value": failed, "limit": 0}}
    for name, value in values.items():
        checks[name] = {"value": value, "limit": limits[name]}
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks

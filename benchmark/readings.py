"""The readings that a cell's limits are set from, in one process.

    python -m benchmark.readings --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 --seconds 2 [--device cuda] [--json PATH]

For each of ``--seeds`` it opens a session as a run does (the matrix, the
port's container, the warm-up), runs the cell's jobs for ``--seconds`` at
the cell's load, and reads the compared numbers of the kept answers: the
program's readings, whose largest is the lower reading. For each of
``--control-seeds`` it puts the plain reference in the program's place,
computed in the precision below the configuration's dtype (``CONTROL``:
bfloat16 below float32, values and vectors stored in bfloat16, products
and sums in float32; float32 below float64), on as many jobs as a run
keeps, and reads the same numbers: the control, whose smallest is the
upper reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, spec
from benchmark.jobs import run_window
from benchmark.matrices import build, seed_streams
from benchmark.reference import plain
from benchmark.session import WARMUP, JobSeeds, open_session

__all__ = ["CONTROL", "program_readings", "control_readings", "control_jobs"]

# a configuration's dtype -> the control's, the nearest precision below it
CONTROL = {"float32": torch.bfloat16, "float64": torch.float32}


def program_readings(cell, seed: int, seconds: float, device) -> dict:
    session = open_session(cell, seed, device)
    w = run_window(session.jobs, session.seeds, seconds, int(cell.traffic["sample"]),
                   session.streams["sample"])
    kind = session.jobs.kind
    session.close()
    out = check.numbers(session.matrix, w.kept, kind, cell.traffic, device)
    out.update(failed=w.failed, jobs=w.attempted)
    return out


def control_jobs(cell, kind, matrix, seed: int, device) -> list:
    """The first ``sample`` jobs that a run of ``seed`` would send after its
    warm-up, answered by the plain reference in the precision below the
    matrix's (``CONTROL``)."""
    seeds = JobSeeds(seed_streams(seed)["jobs"])
    for _ in range(WARMUP):
        next(seeds)
    op = plain.Operator(matrix.nrows, matrix.rows, matrix.cols, matrix.vals,
                        dtype=CONTROL[matrix.dtype], device=device)
    gen = torch.Generator(torch.device(device))
    kept = []
    for _ in range(int(cell.traffic["sample"])):
        inp = kind.inputs(next(seeds), matrix.nrows, gen)
        kept.append({"inputs": inp, "out": kind.control(op, inp, cell.traffic)})
    return kept


def control_readings(cell, seed: int, device) -> dict:
    kind = spec.kind(cell.root, cell.traffic["job"])
    kind.prepare(cell.config)
    matrix = build(cell.config, seed, device, cell.root)
    kept = control_jobs(cell, kind, matrix, seed, device)
    out = check.numbers(matrix, kept, kind, cell.traffic, device)
    if hasattr(kind, "weight"):
        out["weights"] = [kind.weight(job["out"]) for job in kept]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    res = {"workload": args.workload, "limits": cell.limits, "program": {}, "control": {}}
    for s in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        res["program"][s] = r = program_readings(cell, int(s), args.seconds, args.device)
        print(f"program seed {s}: {r} ({time.perf_counter() - t:.1f} s)", flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        t = time.perf_counter()
        res["control"][s] = r = control_readings(cell, int(s), args.device)
        print(f"control seed {s}: {r} ({time.perf_counter() - t:.1f} s)", flush=True)
    for name in cell.limits:
        lo = [r[name] for r in res["program"].values()]
        hi = [r[name] for r in res["control"].values()]
        print(f"{name}: lower {max(lo) if lo else None!r} (program, {len(lo)} seeds), "
              f"upper {min(hi) if hi else None!r} (control, {len(hi)} seeds), "
              f"limit {cell.limits[name]!r}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

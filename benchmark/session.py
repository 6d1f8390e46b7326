"""One cell on one device: its matrix, the port's container, the jobs and
their warm-up. ``benchmark.run`` measures a session; ``benchmark.readings``
reads the compared numbers of many seeds, one session each.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from benchmark import spec
from benchmark.jobs import Jobs, job_seeds
from benchmark.matrices import Matrix, build, seed_streams

__all__ = ["Session", "open_session", "JobSeeds", "WARMUP"]

# warm-up jobs: the first of a kind runs the solver's eager loop, the
# second captures its graph loop, the third replays it
WARMUP = 3


class JobSeeds:
    """An endless iterator over the job seeds a run's seed gives."""

    def __init__(self, rng):
        self.rng, self.buf = rng, []

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if not self.buf:
            self.buf = job_seeds(self.rng, 1024)[::-1]
        return self.buf.pop()


@dataclass
class Session:
    matrix: Matrix
    a: object  # the port's container: X2Matrix for a float64 configuration
    jobs: Jobs
    seeds: JobSeeds
    streams: dict
    spans: dict = field(default_factory=dict)  # set-up part -> seconds

    def close(self) -> None:
        """Free the port's container, its graphs and the caching allocator's
        blocks; the matrix's host triplets stay for the reference."""
        self.a = None
        self.jobs.a = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def open_session(cell, seed: int, device) -> Session:
    """Build the cell's matrix for ``seed``, convert it to the port's
    container that the configuration's ``dtype`` picks (``from_coo``'s for
    float32, ``X2Matrix.from_coo``'s fp64 plans for float64, from the same
    host triplets; either build is the span ``from_coo``) and warm its jobs
    up (``WARMUP`` jobs). The device's memory peak is counted from the
    conversion on: the benchmark's own making of the matrix is not the
    program's."""
    t = time.perf_counter()
    import spmv_tpu_torch

    spans = {"port_import": time.perf_counter() - t}
    kind = spec.kind(cell.root, cell.traffic["job"])
    kind.prepare(cell.config)
    t = time.perf_counter()
    matrix = build(cell.config, seed, device, cell.root)
    spans["matrix"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    convert = (spmv_tpu_torch.X2Matrix.from_coo if matrix.dtype == "float64"
               else spmv_tpu_torch.from_coo)
    a = convert(matrix.format, matrix.nrows, matrix.ncols, matrix.rows, matrix.cols,
                matrix.vals, device=device)
    _sync(device)
    spans["from_coo"] = time.perf_counter() - t
    streams = seed_streams(seed)
    seeds = JobSeeds(streams["jobs"])
    jobs = Jobs(kind, cell.traffic, a, matrix.nrows, device)
    t = time.perf_counter()
    for _ in range(WARMUP):
        jobs.call(jobs.inputs(next(seeds)))
    _sync(device)
    spans["warmup"] = time.perf_counter() - t
    return Session(matrix=matrix, a=a, jobs=jobs, seeds=seeds, streams=streams,
                   spans=spans)

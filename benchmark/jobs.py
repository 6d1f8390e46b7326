"""The job loop that every traffic file feeds.

A traffic file (``benchmark/traffic/<mix>.json``) names a job kind
(``"job"``), the module ``benchmark/kinds/<job>.py``, with the kind's
parameters and ``sample``, the answers a run keeps for the check. The kind
makes a job's inputs from its seed, calls the port's public entry, says
whether the answer calls itself sound, counts the SpMVs and iterations the
job asked for, and compares kept answers with the plain reference.

The loop is closed with one client: the next job starts when the previous
one has returned. The job seeds come from the run's seed. Warm-up jobs use
seeds of their own, and the window's jobs never repeat them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Jobs", "Window", "run_window", "job_seeds"]


class Jobs:
    """The jobs of one traffic file, of the job kind module ``kind``, on the
    container ``a`` (``a`` is the port's; ``n`` its size)."""

    def __init__(self, kind, traffic: dict, a, n: int, device):
        self.kind, self.name = kind, traffic["job"]
        self.traffic, self.a, self.n = traffic, a, n
        self.gen = torch.Generator(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self.gen.device

    def inputs(self, seed: int) -> dict:
        return self.kind.inputs(seed, self.n, self.gen)

    def call(self, inputs: dict) -> dict:
        return self.kind.call(self.a, inputs, self.traffic)

    def ok(self, out: dict) -> bool:
        return self.kind.ok(out, self.traffic)

    def spmvs(self, out: dict) -> int:
        return self.kind.spmvs(out, self.traffic)

    def iterations(self, out: dict) -> int:
        return self.kind.iterations(out, self.traffic)

    def weight(self, out: dict):
        """The job's weight where the kind adds its heaviest job to the
        checked sample, else None."""
        return self.kind.weight(out) if hasattr(self.kind, "weight") else None


class Window:
    """What a window of jobs did: per job its seconds, iterations and SpMVs,
    the jobs kept for the check, and the window's length."""

    def __init__(self):
        self.seconds = 0.0
        self.attempted = self.failed = 0
        self.times: list[float] = []  # seconds per completed job
        self.iters: list[int] = []
        self.spmvs = 0
        self.kept: list[dict] = []
        self.errors: list[str] = []


def job_seeds(rng: np.random.Generator, count: int) -> list[int]:
    return [int(s) for s in rng.integers(0, 2 ** 62, size=count)]


def run_window(jobs: Jobs, seeds, seconds: float, sample: int,
               sample_rng: np.random.Generator, on_job=None) -> Window:
    """Jobs back to back from ``seeds`` (an iterator) until ``seconds`` have
    passed; the window ends when the job running at that moment returns.
    A job's time runs from its call to its answer on the host, read by
    CUDA events on the device's clock (the host clock on the CPU). The
    answers kept for the check are a uniform sample of ``sample`` jobs
    (reservoir sampling from ``sample_rng``), plus the job of most weight
    where the kind weighs its jobs (cg: the solve of most iterations)."""
    w = Window()
    cuda = jobs.device.type == "cuda"
    events = []
    hardest = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline:
        inputs = jobs.inputs(next(seeds))
        w.attempted += 1
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        h0 = time.perf_counter()
        try:
            out = jobs.call(inputs)
        except Exception as e:  # a job that raises is a failed answer
            w.failed += 1
            w.errors.append(f"{type(e).__name__}: {e}")
            continue
        h1 = time.perf_counter()
        if cuda:
            e1.record()
            events.append((e0, e1))
        else:
            w.times.append(h1 - h0)
        if on_job is not None:
            on_job(out)
        if not jobs.ok(out):
            w.failed += 1
        w.iters.append(jobs.iterations(out))
        w.spmvs += jobs.spmvs(out)
        job = {"inputs": inputs, "out": out}
        if len(w.kept) < sample:
            w.kept.append(job)
        else:
            j = int(sample_rng.integers(0, i + 1))
            if j < sample:
                w.kept[j] = job
        weight = jobs.weight(out)
        if weight is not None and (hardest is None or weight > hardest[0]):
            hardest = (weight, job)
        i += 1
    if cuda:
        torch.cuda.synchronize()
        w.times = [a.elapsed_time(b) / 1e3 for a, b in events]
    w.seconds = time.perf_counter() - t0
    if hardest is not None and all(k is not hardest[1] for k in w.kept):
        w.kept.append(hardest[1])
    return w

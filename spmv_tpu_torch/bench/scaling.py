"""Weak-scaling benchmark of the distributed SpMV layer.

Counterpart of ``spmv_tpu/bench/scaling.py``, with its names and report.
Weak scaling keeps the work per device constant: each device owns
``rows_per_device`` rows at a fixed nnz per row, so a D-device run works
a D× larger matrix; ideal scaling keeps the time flat, and efficiency is
``t(1)/t(D)``.

The sweep runs ``dist.RowShardedSpmv`` on the first D ranks of the
default process group for each D up to its size:

* ranks on CUDA cards (NCCL): measured numbers; on a machine with one
  card only D = 1, whose collectives are real NCCL calls on one rank;
* ranks on the CPU (gloo): the whole sweep runs on the plain PyTorch
  versions and the report says ``simulated: true``: it checks the
  sharded program, not the numbers.

A point's time is the slope between ``iters_a`` and ``iters_b`` chained
local multiplies (x ← y slab scaled to unit length, each rank by its own
slab's norm, so the x all-gather is the one collective per step), the
minimum over ``repeats``, the slowest rank's. On a card the chain runs as
a CUDA graph of ``gcd(iters_a, iters_b)`` steps, the NCCL all-gathers
captured with the kernels, replayed and timed with CUDA events: the
counterpart of JAX's one jitted ``fori_loop``, so the point reads the
device's step and not the host's launches (an eager step costs several
times its kernels in host work). On the CPU the eager loop runs under the
host clock: a gloo collective cannot be captured, and its numbers are
simulated anyway. The choice follows the mesh's device, never a capture
that fails. For D ≥ 2 on a machine with one card, the report models the
efficiency from the D = 1 time and the all-gather's bytes over NVLink's
data-sheet bandwidth (``analytic_weak_scaling``).
"""

from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ScalePoint", "analytic_weak_scaling", "graph_chain", "weak_scaling",
           "weak_scaling_report", "H100_NVLINK_BPS"]

# NVLink 4 bandwidth of one H100 SXM card per direction, from NVIDIA's
# data sheet (900 GB/s both ways): a published figure, not a measurement
H100_NVLINK_BPS = 450e9


@dataclass
class ScalePoint:
    devices: int
    nrows: int
    nnz: int
    ms_per_spmv: float
    gnnz_per_s: float
    efficiency: float  # t(1)/t(D); 1.0 = ideal weak scaling

    def to_dict(self):
        return asdict(self)


def _chained(sh, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` chained local multiplies from the held x (JAX's
    ``_chained``): y slab → scaled to unit length → the next x (the whole
    y, gathered, without ``gather_x``)."""
    n = x.numel()
    for _ in range(iters):
        y = sh._local(x)
        if not sh.gather_x:
            y = sh._rows(y)
        y = y * torch.rsqrt(torch.dot(y, y) + 1e-9)
        x = y[:n] if y.numel() >= n else torch.nn.functional.pad(y, (0, n - y.numel()))
    return x


def _seconds(fn, mesh) -> float:
    """Seconds of ``fn`` on this rank, its mesh's ranks started together:
    CUDA events on a card, the host clock on the CPU."""
    dist.barrier(group=mesh.group)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e-3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def graph_chain(sh, xs: torch.Tensor, steps: int):
    """``steps`` chained local multiplies of ``sh`` captured in one CUDA
    graph (its collectives too, so an NCCL mesh only), from and back into
    a static copy of the held x: each replay continues the chain where the
    last one left it. Returns ``(graph, x)``. The caller has warmed ``sh``
    eagerly (the containers' first calls, NCCL's communicator)."""
    x = xs.clone()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.copy_(_chained(sh, x, steps))
    return g, x


def _time_sharded(sh, x: np.ndarray, *, iters_a=20, iters_b=60, repeats=3) -> float:
    xs = sh._held(x)
    _chained(sh, xs, iters_a)  # warm: the containers' first calls, NCCL's set-up
    _chained(sh, xs, iters_b)
    if sh.device.type == "cuda":
        steps = math.gcd(iters_a, iters_b)
        g, _ = graph_chain(sh, xs, steps)

        def run(iters):
            for _ in range(iters // steps):
                g.replay()
    else:
        def run(iters):
            _chained(sh, xs, iters)
    ta = tb = float("inf")
    for _ in range(repeats):
        ta = min(ta, _seconds(lambda: run(iters_a), sh.mesh))
        tb = min(tb, _seconds(lambda: run(iters_b), sh.mesh))
    return max((tb - ta) / (iters_b - iters_a), 1e-9)


def _slowest(t: float, device) -> float:
    """The largest ``t`` over every rank of the default group (a rank
    outside the mesh gives 0), so that every rank holds the same point."""
    v = torch.tensor([t], dtype=torch.float64, device=device)
    dist.all_reduce(v, op=dist.ReduceOp.MAX)
    return float(v.item())


def weak_scaling(
    format: str = "cmrs",
    *,
    rows_per_device: int = 16384,
    avg_nnz_per_row: int = 32,
    bandwidth: int = 256,
    device_counts=None,
    gather_x: bool = True,
    seed: int = 0,
    iters_a: int = 20,
    iters_b: int = 60,
    repeats: int = 3,
) -> list[ScalePoint]:
    """Run the weak-scaling sweep on the default process group; returns
    one point per device count, the same on every rank. Every rank of the
    group must call it (each D makes its ``make_mesh``)."""
    from spmv_tpu_torch.dist.mesh import make_mesh
    from spmv_tpu_torch.dist.sharded import RowShardedSpmv
    from spmv_tpu_torch.synth import synthetic_cant

    ndev = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev]

    points: list[ScalePoint] = []
    t1 = None
    for d in device_counts:
        n = rows_per_device * d
        info, rows, cols, vals = synthetic_cant(
            n=n, avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth,
            seed=seed)
        mesh = make_mesh(d)
        t = 0.0
        if mesh.member:
            sh = RowShardedSpmv(format, info.nrows, info.ncols, rows, cols, vals,
                                mesh, gather_x=gather_x)
            x = np.random.default_rng(seed).standard_normal(
                info.ncols).astype(np.float32)
            t = _time_sharded(sh, x, iters_a=iters_a, iters_b=iters_b,
                              repeats=repeats)
            del sh
        t = _slowest(t, mesh.device)
        if t1 is None:
            t1 = t
        points.append(ScalePoint(
            devices=d, nrows=info.nrows, nnz=rows.size,
            ms_per_spmv=t * 1e3,
            gnnz_per_s=rows.size / t / 1e9,
            efficiency=t1 / t,
        ))
    return points


def analytic_weak_scaling(
    t1_s: float,
    *,
    rows_per_device: int,
    avg_nnz_per_row: int = 32,
    device_counts=(2, 4, 8, 16),
    link_bw: float = H100_NVLINK_BPS,
) -> list[dict]:
    """Expected weak-scaling efficiency from a measured one-card time plus
    a link cost model: the bound a machine with one card can give for D ≥
    2 without the cards.

    The D-device step all-gathers x (4 B per row, ring algorithm: each
    device receives (D−1)/D of the D·rows_per_device-entry vector over its
    links at ``link_bw`` bytes per second, by default NVLink 4's
    data-sheet figure). ``eff_no_overlap`` serialises the gather after the
    multiply (the lower bound); ``eff_overlap`` is the perfect-overlap
    bound (1.0 until the gather outlasts the multiply). The overlap
    structure exists, ``dist.overlap.ChunkedRowSpmv``'s chunked gathers
    and ``dist.ring``'s shift in flight during each step's multiply, but
    on one card its effect can only be modelled. The multiply's time is
    t1 by construction of weak scaling (bytes per device constant).
    """
    out = []
    for d in device_counts:
        recv_bytes = 4.0 * rows_per_device * (d - 1)
        t_comm = recv_bytes / link_bw
        out.append({
            "devices": int(d),
            "t_comm_us": t_comm * 1e6,
            "eff_no_overlap": t1_s / (t1_s + t_comm),
            "eff_overlap": min(1.0, t1_s / max(t1_s, t_comm)),
        })
    return out


def weak_scaling_report(**kwargs) -> dict:
    """The sweep as a JSON-able report (JAX's keys; ``backend`` is the
    process group's, ``card`` the card's name and power limit or None).
    With ranks on cards, or ``force_model``, it carries the modelled
    efficiency for D ≥ 2 (``link_bw`` overrides the bandwidth)."""
    from spmv_tpu_torch.dist.mesh import make_mesh

    force_model = kwargs.pop("force_model", False)
    link_bw = kwargs.pop("link_bw", H100_NVLINK_BPS)
    backend = dist.get_backend()
    device = make_mesh().device
    card = None
    if device.type == "cuda":
        from spmv_tpu_torch.probes.timing import card_line

        card = card_line(device)
    points = weak_scaling(**kwargs)
    rep = {
        "config": {"format": kwargs.get("format", "cmrs"),
                   "gather_x": kwargs.get("gather_x", True)},
        "backend": backend,
        "card": card,
        "simulated": device.type != "cuda",
        "timing": ("CUDA graph of gcd(iters_a, iters_b) chained steps, NCCL "
                   "all-gathers captured, replayed; CUDA events"
                   if device.type == "cuda" else
                   "eager chained steps; host clock"),
        "points": [p.to_dict() for p in points],
        "max_devices_efficiency": points[-1].efficiency if points else None,
    }
    if points and (device.type == "cuda" or force_model):
        rep["modeled_efficiency"] = analytic_weak_scaling(
            points[0].ms_per_spmv * 1e-3,
            rows_per_device=kwargs.get("rows_per_device", 16384),
            avg_nnz_per_row=kwargs.get("avg_nnz_per_row", 32),
            link_bw=link_bw,
        )
        rep["modeled"] = (
            f"NVLink ring all-gather cost model on the measured D=1 time (the "
            f"device's step, from the CUDA graph), at "
            f"{link_bw / 1e9:.0f} GB/s per direction (the H100 SXM data "
            f"sheet's NVLink 4 figure unless given); eff_no_overlap is the "
            f"lower bound, eff_overlap the perfect-overlap bound; the "
            f"overlap structure exists (dist.overlap.ChunkedRowSpmv's chunked "
            f"gathers, dist.ring's shift in flight during each step) but is "
            f"modelled, not measured, on one card")
    return rep

"""A profiled stretch of jobs after the window: the device's busy and idle
time, the device operations that took most time, and the longest idle
gaps by what the host was doing.

``torch.profiler`` (CUPTI) traces the card. The stretch is the span of the
``bench.stretch`` range: from its start on the host to the end of its last
device operation. Busy time is the union of the device's kernels, copies
and fills within it.

Whether the profiler recorded every kernel is checked. The port counts its
own kernels' launches (``kernels.engines.LAUNCHES``) when the host issues
them, so an eager launch counts at once and a captured one counts at
capture, not at each replay. The expected count of the port's kernels in
the stretch is then: the eager launches counted over it, plus for each
graph replay the loop's ``chunk`` bodies times the launches of one
``matvec``. The recorded count is the trace's kernels whose name holds a
counter's name. ``complete`` is true only where the two agree.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["Stretch", "profiled"]

_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _start_end(e) -> tuple[float, float]:
    if hasattr(e, "start_ns"):
        s = e.start_ns() / 1e9
        return s, s + e.duration_ns() / 1e9
    s = e.start_us() / 1e6
    return s, s + e.duration_us() / 1e6


def _activity(e, on_device: bool) -> str:
    """The event's kineto activity: ``kernel``, ``gpu_memcpy``, ... Where the
    event does not say (older PyTorch), a device event is an annotation
    when it says so or bears the stretch's name, else a kernel; a host
    event is an ``op``."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if annotation or e.name() == "bench.stretch":
        return "annotation"
    return "kernel" if on_device else "op"


class Stretch:
    """The readings of one profiled stretch."""

    def __init__(self):
        self.window_s = self.busy_s = 0.0
        self.device_ops: list = []  # [name, seconds], most time first
        self.idle_gaps: list = []  # [host activity, seconds], most time first
        self.kernels_recorded = 0  # the port's kernels in the trace
        self.kernels_expected = None  # from the launch counters and replays
        self.jobs = 0
        self.kinds = {}  # "device:<activity>" or "host:<activity>" -> events

    @property
    def complete(self) -> bool:
        return self.kernels_expected is not None and self.kernels_recorded == self.kernels_expected

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_activities(cpu, times):
    """For each of the increasing ``times``, the innermost host operation
    running then: of those that cover it, the one that started last."""
    import heapq

    cpu = sorted(cpu)
    live, out, i = [], [], 0
    for t in times:
        while i < len(cpu) and cpu[i][0] <= t:
            s, e, name = cpu[i]
            heapq.heappush(live, (-s, e, name))
            i += 1
        while live and live[0][1] < t:
            heapq.heappop(live)
        out.append(live[0][2] if live else "(no host operation)")
    return out


def read(events, launch_keys, stretch: Stretch, top: int = 10) -> Stretch:
    """Fill ``stretch`` from the profiler's events. The device's events
    are those of the whole profiled session, which holds the stretch
    alone; the window is the longer of the host's span of the stretch and
    the device's span of its operations."""
    cpu, dev = [], []
    begin = end = None
    for e in events:
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        kind = _activity(e, on_device)
        s, t = _start_end(e)
        key = f"{'device' if on_device else 'host'}:{kind}"
        stretch.kinds[key] = stretch.kinds.get(key, 0) + 1
        if on_device:
            if kind in _DEVICE_ACTIVITIES:
                dev.append((s, t, e.name()))
        elif e.name() == "bench.stretch":
            begin, end = s, t
        else:
            cpu.append((s, t, e.name()))
    if begin is None or not dev:
        return stretch
    lo = min([begin] + [d[0] for d in dev])
    hi = max([end] + [d[1] for d in dev])
    stretch.window_s = hi - lo
    busy = _merge([[s, t] for s, t, _ in dev])
    stretch.busy_s = sum(t - s for s, t in busy)
    by_name = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    stretch.device_ops = [[n[:160], v] for n, v in
                          sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    keys = sorted(launch_keys, key=len, reverse=True)
    stretch.kernels_recorded = sum(1 for _, _, name in dev if any(k in name for k in keys))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps = {}
    for (a, b), name in zip(spans, _host_activities(cpu, [(a + b) / 2 for a, b in spans])):
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    stretch.idle_gaps = [[n[:160], v] for n, v in
                         sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
    return stretch


@contextmanager
def profiled(stretch: Stretch, launch_keys):
    """Profile the body as the stretch; fill ``stretch`` on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.stretch"):
            yield stretch
        torch.cuda.synchronize()
    read(prof.profiler.kineto_results.events(), launch_keys, stretch)

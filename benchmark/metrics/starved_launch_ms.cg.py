"""starved_launch_ms.cg: the host time per cg solve of the graph launches
issued right after a host read of the solve's values, in ms: launches
with none of the solve's work queued, so the device waits through them.
Σ durations of the profiled stretch's ``solve.replay`` spans with
``after_read`` 1 inside ``solve.cg`` solves, over those solves (host
clock, on the profiler's clock; ``spmv_tpu_torch.trace``, which a
profiler arms). Nothing where the stretch holds no such solve or no
replay of one."""


def read(ctx):
    try:
        from spmv_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.spans()
    cg = {s.request for s in spans if s.name == "solve.cg"}
    replays = [s for s in spans if s.name == "solve.replay" and s.request in cg]
    if not replays:
        return None
    starved = sum(s.end_ns - s.start_ns for s in replays if s.counts.get("after_read"))
    return starved / 1e6 / len(cg)

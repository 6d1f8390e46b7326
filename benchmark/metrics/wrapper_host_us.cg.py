"""wrapper_host_us.cg: the median host time of one call of the port's
SpMV dispatch wrapper inside the cg solves, in µs (each solve's eager r0
SpMV): the durations of the profiled stretch's ``spmv.wrapper`` spans
inside ``solve.cg`` solves (host clock, on the profiler's clock;
``spmv_tpu_torch.trace``, which a profiler arms)."""

import statistics


def read(ctx):
    try:
        from spmv_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.spans()
    cg = {s.request for s in spans if s.name == "solve.cg"}
    times = [s.end_ns - s.start_ns for s in spans
             if s.name == "spmv.wrapper" and s.request in cg]
    return statistics.median(times) / 1e3 if times else None

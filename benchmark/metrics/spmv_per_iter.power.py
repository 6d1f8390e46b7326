"""spmv_per_iter.power: the SpMVs the port's power iteration jobs issued
per iteration they asked for, over the profiled stretch: Σ ``spmvs`` over
Σ ``iterations`` of the stretch's ``solve.power_iteration`` spans (the
program's own counts; ``spmv_tpu_torch.trace``, which a profiler arms).
Above 1: the Rayleigh quotient's SpMV and the masked bodies of the last
graph replay."""


def read(ctx):
    try:
        from spmv_tpu_torch import trace
    except ImportError:
        return None
    roots = [s for s in trace.spans() if s.name == "solve.power_iteration"]
    iters = sum(s.counts.get("iterations", 0) for s in roots)
    return sum(s.counts.get("spmvs", 0) for s in roots) / iters if iters else None

"""spmv_per_iter.cg: the SpMVs the port's cg solves issued per iteration
they returned, over the profiled stretch: Σ ``spmvs`` over Σ
``iterations`` of the stretch's ``solve.cg`` spans (the program's own
counts; ``spmv_tpu_torch.trace``, which a profiler arms). Above 1: the
r0 SpMV and the masked bodies of each solve's last graph replay."""


def read(ctx):
    try:
        from spmv_tpu_torch import trace
    except ImportError:
        return None
    roots = [s for s in trace.spans() if s.name == "solve.cg"]
    iters = sum(s.counts.get("iterations", 0) for s in roots)
    return sum(s.counts.get("spmvs", 0) for s in roots) / iters if iters else None

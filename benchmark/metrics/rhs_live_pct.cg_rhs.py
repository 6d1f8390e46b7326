"""rhs_live_pct.cg_rhs: the share of the columns that the port's block cg
solves computed in their SpMMs that a live column asked for, in percent:
100 × Σ ``column_iterations`` over Σ ``rhs`` × ``spmvs`` of the profiled
stretch's ``solve.cg`` spans of more than one right-hand side (the
program's own counts; ``spmv_tpu_torch.trace``, which a profiler arms).
Below 100: columns that stopped before the slowest, the masked bodies of
each solve's last graph replay, and R0's SpMM. Nothing where the stretch
holds no block solve or the program does not count its columns."""


def read(ctx):
    try:
        from spmv_tpu_torch import trace
    except ImportError:
        return None
    blocks = [s for s in trace.spans()
              if s.name == "solve.cg" and s.counts.get("rhs", 1) > 1
              and "column_iterations" in s.counts]
    computed = sum(s.counts["rhs"] * s.counts["spmvs"] for s in blocks)
    live = sum(s.counts["column_iterations"] for s in blocks)
    return 100.0 * live / computed if computed else None

"""spmm_roofline.cg_rhs: K8 (``seg_spmm_tiles``) inside the block cg
solves as a share of its HBM-peak bound, in percent. The bound of one call
is the least bytes of a float32 CSR SpMM at the solve's R
(``benchmark/roofline_rhs.py``) over 3.35 TB/s; the calls are the SpMMs of
the profiled stretch's ``solve.cg`` spans of more than one right-hand side
(Σ ``spmvs``: R0's and every masked body replayed; ``spmv_tpu_torch.trace``,
which a profiler arms); the time is K8's device seconds in the stretch's
trace. Nothing where the stretch holds no block solve or no K8."""

from benchmark.roofline import roofline_pct
from benchmark.roofline_rhs import least_csr_spmm_bytes

KERNEL = "seg_spmm_tiles"


def read(ctx):
    s = ctx.stretch
    if s is None:
        return None
    try:
        from spmv_tpu_torch import trace
    except ImportError:
        return None
    m = ctx.matrix
    nbytes = sum(x.counts["spmvs"] * least_csr_spmm_bytes(m.nrows, m.ncols, m.nnz, x.counts["rhs"])
                 for x in trace.spans()
                 if x.name == "solve.cg" and x.counts.get("rhs", 1) > 1)
    seconds = sum(t for name, t in s.device_ops if KERNEL in name)
    return roofline_pct(nbytes, seconds) if nbytes and seconds > 0 else None

"""The container's ``matvec`` as a share of its HBM-peak bound: the least
bytes a float32 CSR SpMV of this matrix must move, over 3.35 TB/s, over
the call's time by CUDA events around a CUDA graph of 20 calls
(``benchmark/roofline.py``)."""

from benchmark.roofline import least_csr_bytes, roofline_pct


def read(ctx):
    if not ctx.matvec_s:
        return None
    m = ctx.matrix
    return roofline_pct(least_csr_bytes(m.nrows, m.ncols, m.nnz), ctx.matvec_s)

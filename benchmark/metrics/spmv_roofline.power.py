"""The container's ``matvec`` as a share of its HBM-peak bound: the least
bytes a CSR SpMV of this matrix must move, values, x and y at the width of
the configuration's dtype (4 B for float32, 8 B for float64), over
3.35 TB/s, over the call's time by CUDA events around a CUDA graph of 20
calls (``benchmark/roofline.py``)."""

from benchmark.roofline import VALUE_BYTES, least_csr_bytes, roofline_pct


def read(ctx):
    if not ctx.matvec_s:
        return None
    m = ctx.matrix
    nbytes = least_csr_bytes(m.nrows, m.ncols, m.nnz, VALUE_BYTES[m.dtype])
    return roofline_pct(nbytes, ctx.matvec_s)

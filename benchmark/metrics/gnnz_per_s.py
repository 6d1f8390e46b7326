"""gnnz_per_s: the matrix's nonzeros times the SpMVs that the window's
completed jobs asked for (a power iteration job: its iterations and its
Rayleigh ``matvec``), over the window's seconds (host clock), in 1e9/s."""


def read(ctx):
    w = ctx.window
    return ctx.matrix.nnz * w.spmvs / w.seconds / 1e9 if w.spmvs else None

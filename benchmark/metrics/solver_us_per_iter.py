"""solver_us_per_iter: the window's microseconds over its iterations, less
the isolated ``matvec`` time (``spmv_roofline``'s timing): what the solver
loop adds to each iteration's SpMV (vector updates, masked bodies, graph
replays, host reads and the work between solves)."""


def read(ctx):
    it = sum(ctx.window.iters)
    if not it or not ctx.matvec_s:
        return None
    return ctx.window.seconds * 1e6 / it - ctx.matvec_s * 1e6

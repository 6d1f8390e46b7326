"""cg_iters: the mean of ``cg``'s returned iteration count over the
window's solves (the program's own count)."""


def read(ctx):
    it = ctx.window.iters
    return sum(it) / len(it) if it else None

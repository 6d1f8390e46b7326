"""solves_per_s: solves completed in the window over the window's seconds
(host clock), the window ending when the job running at its close returns."""


def read(ctx):
    w = ctx.window
    return len(w.times) / w.seconds if w.times else None

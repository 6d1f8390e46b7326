"""setup_s: seconds from the run's start to the window's start (host clock)."""


def read(ctx):
    return ctx.setup_s

"""The device's idle share over the profiled stretch, in percent: 1 − busy
over the stretch (``benchmark/trace.py``). Nothing where the profiler did
not record every kernel of the port that the stretch launched."""


def read(ctx):
    s = ctx.stretch
    if s is None or not s.complete or s.window_s <= 0:
        return None
    return s.idle_pct

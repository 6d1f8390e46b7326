"""solve_p95_ms: the 95th percentile of the window's solve times, each
from the ``cg`` call to its x and k on the host, read by CUDA events on the
device's clock."""

import numpy as np


def read(ctx):
    t = ctx.window.times
    return float(np.percentile(t, 95)) * 1e3 if t else None

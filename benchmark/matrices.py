"""A configuration's matrix, made on the device from the seed.

The configuration names its generator (``"generator"``), a module
``benchmark/gen/<generator>.py`` whose ``make(config, seed, device)``
returns ``(nrows, ncols, rows, cols, vals)``: indices in (row, col) order,
each (row, col) once, and float32 values, the type they are served in, on
the device, in a few large calls. Whatever of the matrix is fixed (a mesh,
a graph) comes from the configuration; what the run's seed moves, the
generator says. The triplets then come to the host once, as int32 indices
and float32 values: the same arrays for the program's ``from_coo`` and for
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from benchmark import spec

__all__ = ["Matrix", "build", "seed_streams"]


@dataclass
class Matrix:
    name: str
    nrows: int
    ncols: int
    rows: np.ndarray  # int32, (row, col) order
    cols: np.ndarray  # int32
    vals: np.ndarray  # float32
    format: str
    dtype: str

    @property
    def nnz(self) -> int:
        return int(self.cols.size)


def seed_streams(seed: int) -> dict:
    """Independent generators of one run: ``jobs`` (the job seeds) and
    ``sample`` (which answers are checked)."""
    seed = int(seed) % 2 ** 64
    return {k: np.random.default_rng([seed, i]) for i, k in enumerate(("jobs", "sample"), 1)}


def build(config: dict, seed: int, device, root: Path | str = spec.ROOT) -> Matrix:
    """The configuration's matrix for ``seed``, its triplets on the host."""
    make = spec.generator(root, config["generator"]).make
    with torch.no_grad():
        n, m, rows, cols, vals = make(config, seed, torch.device(device))
        host = [t.to(dt).cpu().numpy() for t, dt in
                ((rows, torch.int32), (cols, torch.int32), (vals, torch.float32))]
    del rows, cols, vals
    mat = Matrix(config["name"], int(n), int(m), *host, format=config["format"],
                 dtype=config["dtype"])
    for key in ("nrows", "nnz"):
        if key in config and int(config[key]) != getattr(mat, key):
            raise ValueError(f"{config['name']}: {key} is {getattr(mat, key)}, "
                             f"the configuration states {config[key]}")
    return mat

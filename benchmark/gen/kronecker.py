"""Graph500's Kronecker graph, weighted as its SSSP kernel weights it.

The generator is the Graph500 specification's (``kronecker_generator.m``):
N = 2^scale vertices and M = edgefactor · N edges; for each of ``scale``
bit levels an edge's source bit is 1 with probability 1 − (A + B), and its
target bit is 1 with probability C / (1 − (A + B)) where the source bit is
1, else A / (A + B); then the vertex labels are permuted at random. The
edges are undirected, self-loops and repeats included, as the
specification leaves them. Each edge has a weight uniform in [0, 1) (on the grid of 2^-24), as
the specification's third kernel gives them.

The matrix is the graph's weighted adjacency: both directions of each
edge, a self-loop once, the weights of repeated edges summed. The edges
come from the configuration's ``graph_seed``, fixed as a graph is; the
weights from the run's seed. Nonnegative and symmetric, so power
iteration converges to the Perron vector.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make", "torch_seed"]


def torch_seed(seed: int, stream: int) -> int:
    """A ``torch.Generator`` seed for ``stream`` of ``seed``."""
    return int(np.random.default_rng([int(seed) % 2 ** 64, stream]).integers(2 ** 63))


def make(config: dict, seed: int, device) -> tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(nrows, ncols, rows, cols, vals)``: int64 indices in (row, col)
    order and float32 values, on ``device``."""
    scale, m = int(config["scale"]), int(config["edgefactor"]) << int(config["scale"])
    n = 1 << scale
    a, b, c = (float(p) for p in config["initiator"])
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    gen = torch.Generator(device).manual_seed(torch_seed(config["graph_seed"], 0))
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        src_bit = torch.rand(m, generator=gen, device=device) > ab
        dst_p = torch.where(src_bit, c_norm, a_norm)
        dst_bit = torch.rand(m, generator=gen, device=device) > dst_p
        src += src_bit.to(torch.int64) << level
        dst += dst_bit.to(torch.int64) << level
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    # weights on the grid of 2^-24 in [0, 1), as float32 holds them
    weights = torch.randint(0, 1 << 24, (m,), device=device,
                            generator=torch.Generator(device).manual_seed(torch_seed(seed, 1)))
    loop = src == dst
    keys = torch.cat([src * n + dst, (dst * n + src)[~loop]])
    w = torch.cat([weights, weights[~loop]]).to(torch.float64) * 2.0 ** -24
    del src, dst, weights, loop
    keys, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    # the weights are multiples of 2^-24, so these float64 sums are exact
    # and do not depend on the order of the additions
    vals = torch.zeros(keys.numel(), dtype=torch.float64, device=device).index_add_(0, inverse, w)
    return n, n, keys // n, keys % n, vals.to(torch.float32)

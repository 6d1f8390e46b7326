"""The yardstick of the kernels layer: the least bytes of a CSR SpMV, the
card's published peak, and the time of the container's ``matvec`` by CUDA
events around a CUDA graph of back-to-back calls.

The bytes depend on the matrix and its configuration's dtype alone,
whatever format or kernel serves the call: a value and a 4 B column index
for each nonzero, 4 B per row pointer (nrows + 1), x read once and y
written once, values, x and y at the dtype's width (``VALUE_BYTES``: 4 B
for float32, 8 B for float64). The timing is
``spmv_tpu_torch/probes/timing.py``'s capture and replay, copied so that
the yardstick does not move with the port.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["PEAK_BYTES_PER_S", "VALUE_BYTES", "least_csr_bytes", "graph_seconds",
           "roofline_pct"]

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 (at the 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12

# a configuration's dtype -> the bytes of one value, x or y entry
VALUE_BYTES = {"float32": 4, "float64": 8}


def least_csr_bytes(nrows: int, ncols: int, nnz: int, value_bytes: int = 4) -> int:
    """Values, x and y of ``value_bytes`` each (the configuration's width,
    ``VALUE_BYTES``), int32 columns and row pointers."""
    return nnz * (value_bytes + 4) + (nrows + 1) * 4 + (ncols + nrows) * value_bytes


def _capture(fn, calls: int) -> torch.cuda.CUDAGraph:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a call before capture, as CUDA graphs ask
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return g


def _replay_ms(g: torch.cuda.CUDAGraph) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def graph_seconds(fn, calls: int = 20, rounds: int = 5) -> float:
    """Seconds per call of ``fn``: the median over ``rounds`` replays of a
    CUDA graph of ``calls`` back-to-back calls, after one replay."""
    g = _capture(fn, calls)
    g.replay()
    return statistics.median(_replay_ms(g) / calls for _ in range(rounds)) / 1e3


def roofline_pct(nbytes: int, seconds: float) -> float:
    """The share of the HBM-peak bound ``nbytes / PEAK_BYTES_PER_S`` that a
    call of ``seconds`` reaches, in percent."""
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds

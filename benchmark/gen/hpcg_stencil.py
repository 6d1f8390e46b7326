"""HPCG's matrix: the 27-point stencil on an nx × ny × nz grid.

As HPCG's reference code (``GenerateProblem_ref.cpp``) defines it: grid
point (ix, iy, iz) is row ``(iz·ny + iy)·nx + ix``; its row holds every
point of the 3 × 3 × 3 cube around it that lies in the grid, the diagonal
26 and each other entry -1. The matrix is symmetric and diagonally
dominant, strictly on the boundary, so SPD. It has no free values: the
run's seed does not move it.
"""

from __future__ import annotations

import torch

__all__ = ["make"]


def make(config: dict, seed: int, device) -> tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(nrows, ncols, rows, cols, vals)``: int64 indices in (row, col)
    order and float32 values, on ``device``."""
    nx, ny, nz = (int(config[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    idx = torch.arange(n, device=device)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    steps = torch.tensor((-1, 0, 1), device=device)
    sz, sy, sx = (s.reshape(-1) for s in torch.meshgrid(steps, steps, steps, indexing="ij"))
    jx, jy, jz = ix[:, None] + sx, iy[:, None] + sy, iz[:, None] + sz
    inside = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz))
    # offsets in (sz, sy, sx) order raise the column: each row's columns ascend
    cols = ((jz * ny + jy) * nx + jx)[inside]
    rows = idx[:, None].expand(-1, 27)[inside]
    vals = torch.where(rows == cols, 26.0, -1.0).to(torch.float32)
    return n, n, rows, cols, vals

"""Conjugate gradients' body after its SpMV, for one vector or a block of
right-hand sides: the dots, the updates of x, r and p and the recurrence's
scalars, each column under its own mask, in place.

=============  =================================  =======================
wrapper        kernels (csrc/cg_body.cu)          replaces
=============  =================================  =======================
``Body``       ``cg_body_pap``, ``cg_body_xr``,   no Pallas kernel: the
               ``cg_body_p``                      JAX body is ``jnp``
                                                  outside ``pallas_call``
=============  =================================  =======================

``body_reference``, the plain version, is the body's arithmetic as
PyTorch calls (``torch.dot`` for a vector, a column sum for an (n, R)
block) followed by the rewrite of each state tensor through
``torch.where`` on the column mask ``rs > tol2 & k < kmax``, taken from
the body's entry state, so a column whose loop has stopped keeps its
bits.

``Body`` runs one body of one loop, the body ``solve.cg`` runs: with its
``kernels`` flag, on a card, the three kernels, which compute the mask on
the device, write only the columns it holds on (a body with none writes
no vector) and give x, r and p the plain version's bits for the same
alpha and beta; without it (the CPU, the sharded containers) the plain
version. Only the kernels' dots reduce in another order than
``torch.dot`` and the column sums; they are deterministic, so two runs of
the same body give the same bits. Each launch adds one to
``LAUNCHES[kernel]``. These are not keys of ``engines.LAUNCHES``, which
counts the kernels of one SpMV: a solve's count there (and a trace's
kernels that hold one of its keys) stays that of its SpMVs.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.kernels.engines import MULTI_RHS_MAX, _launch

__all__ = ["Body", "body_reference", "LAUNCHES", "BLOCKS"]

LAUNCHES = {"cg_body_pap": 0, "cg_body_xr": 0, "cg_body_p": 0}

# The kernels' grid cap: at most this many blocks of 256 threads, each
# looping over its share of the rows, so the grid (and the dots' order) is
# fixed for a given (n, R). 1024 blocks hold about 8 per SM of an H100, and
# the last block sums at most 1024 partials per column.
BLOCKS = 1024


def body_reference(x, r, p, ap, rs, k, tol2, kmax) -> None:
    """Plain version: the body after its SpMV ``ap = A·p`` by PyTorch
    calls, each column of an (n, R) state its own recurrence, rs of shape
    (R,); x, r, p, rs and k + 1 written back in place through
    ``torch.where`` on ``rs > tol2 & k < kmax`` of the entry state."""
    if x.dim() == 1:
        dot = torch.dot
    else:
        def dot(u, v):
            return (u * v).sum(0)
    on = (rs > tol2) & (k < kmax)
    alpha = rs / dot(p, ap)
    x_new = x + alpha * p
    r_new = r - alpha * ap
    rs_new = dot(r_new, r_new)
    p_new = r_new + (rs_new / rs) * p
    for s, new in zip((x, r, p, rs, k), (x_new, r_new, p_new, rs_new, k + 1)):
        torch.where(on, new, s, out=s)


class Body:
    """One loop's body on ``shape`` (n,) or (n, R), 1 ≤ R ≤
    ``MULTI_RHS_MAX``, on ``device``; ``kernels`` where the body may run
    the kernels (on a card). The kernels' scratch (per-block partials, the
    ticket the last block takes, the mask, alpha and beta) is allocated at
    the first call: the solver's loops run a body, eagerly or as the
    capture's warm-up, before they capture one, so outside any capture,
    and a replayed loop allocates none. Calling it runs one body."""

    def __init__(self, shape, device, kernels: bool = True):
        self.shape = tuple(shape)
        self.n, self.rhs = shape[0], (shape[1] if len(shape) == 2 else 1)
        if not 1 <= self.rhs <= MULTI_RHS_MAX:
            raise ValueError(f"the fused body takes 1 to {MULTI_RHS_MAX} columns, "
                             f"got {self.rhs}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.kernels = kernels and self.device.type == "cuda"
        self.partials = None

    def _scratch(self) -> None:
        R = self.rhs
        f = torch.zeros(BLOCKS * R + 2 * R, dtype=torch.float32, device=self.device)
        i = torch.zeros(1 + R, dtype=torch.int32, device=self.device)
        self.partials, self.alpha, self.beta = f.split([BLOCKS * R, R, R])
        self.ticket, self.mask = i[:1], i[1:]

    def __call__(self, x, r, p, ap, rs, k, tol2, kmax) -> None:
        """One body on the state (x, r, p, rs, k), in place, with ``ap`` =
        A·p and the constants tol2 (a float per column) and kmax (one
        int64)."""
        shape, cols = self.shape, self.shape[1:]
        if tuple(x.shape) != shape:
            raise ValueError(f"state of shape {tuple(x.shape)}, the body's is {shape}")
        for name, t, want, dtype in (("x", x, shape, torch.float32),
                                     ("r", r, shape, torch.float32),
                                     ("p", p, shape, torch.float32),
                                     ("ap", ap, shape, torch.float32),
                                     ("rs", rs, cols, torch.float32),
                                     ("k", k, cols, torch.int32),
                                     ("tol2", tol2, cols, torch.float32),
                                     ("kmax", kmax, (), torch.int64)):
            if tuple(t.shape) != want or t.dtype != dtype or t.device != self.device:
                raise ValueError(f"{name}: expected {dtype} of shape {want} on "
                                 f"{self.device}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if not self.kernels:
            body_reference(x, r, p, ap, rs, k, tol2, kmax)
            return
        if self.partials is None:
            self._scratch()
        for name, t in (("x", x), ("r", r), ("p", p), ("ap", ap)):
            if t.data_ptr() % 16:  # rows read and written in 16-byte units
                raise ValueError(f"{name} must be 16-byte aligned")
        n, R = self.n, self.rhs
        _launch("cg_body_pap", x, p, ap, rs, k, tol2, kmax, self.partials, self.ticket,
                self.mask, self.alpha, n, R, BLOCKS, counts=LAUNCHES)
        _launch("cg_body_xr", x, x, r, p, ap, rs, k, self.mask, self.alpha, self.beta,
                self.partials, self.ticket, n, R, BLOCKS, counts=LAUNCHES)
        _launch("cg_body_p", x, r, p, self.mask, self.beta, n, R, BLOCKS, counts=LAUNCHES)

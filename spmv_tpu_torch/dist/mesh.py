"""Process groups and the collectives of the sharded containers.

Counterpart of ``spmv_tpu/dist/mesh.py``. JAX's mesh is a 1-D
``jax.sharding.Mesh`` over every device, driven by one program. Here each
rank is one process that owns one device, and a ``Mesh`` is the process
group of the first n ranks with this rank's place in it. The collectives
are XLA's on the TPU; their counterparts here are ``torch.distributed``'s
(NCCL on CUDA cards, gloo on the CPU):

* ``all_gather``: every rank's tensor, concatenated rank-major along dim
  0 (``jax.lax.all_gather(..., tiled=True)``);
* ``all_reduce``: the sum over ranks (``jax.lax.psum``);
* ``ring_shift``: this rank's tensor to rank r + 1, rank r − 1's to this
  one (``jax.lax.ppermute`` round the ring).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "init_distributed", "free_port", "local_rank",
           "all_gather", "all_reduce", "ring_shift"]


def free_port() -> int:
    """A free TCP port on this host, for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_rank() -> int:
    """This process's card on its host: torchrun's ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None, device="cuda") -> None:
    """Bring up the default process group; a no-op when one is up.

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for
    the CPU: it follows the device the caller names and never probes for a
    card. Without ``coordinator`` the group reads torchrun's environment
    (``env://``); with one (``host:port`` or a URL such as
    ``tcp://localhost:29500``) it takes ``num_processes`` (default 1) and
    ``process_id`` (default 0). On CUDA the rank's card is
    ``cuda:LOCAL_RANK`` and becomes the current device."""
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    kwargs = {}
    if kind == "cuda":
        torch.cuda.set_device(local_rank())
        kwargs["device_id"] = torch.device("cuda", local_rank())
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
        return
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes or 1,
                            rank=process_id or 0, **kwargs)


@dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the default group. ``rank`` is this
    process's place in it, and ``group`` its process group; a rank outside
    (``member`` false) has neither and may not build a sharded container.
    ``device`` is the rank's device: ``cuda:LOCAL_RANK`` under NCCL, else
    the CPU."""
    group: object
    size: int
    rank: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A ``Mesh`` of the first ``n_devices`` ranks (all of them by default).
    Every rank of the default group must call it, as ``new_group``
    requires. Too few ranks raise JAX's ``ValueError``; a process with no
    group counts as one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    me = dist.get_rank()
    device = (torch.device("cuda", local_rank()) if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    if me >= n:
        return Mesh(group=None, size=n, rank=-1, device=device)
    return Mesh(group=group, size=n, rank=me, device=device)


def _gather_into():
    # all_gather_single where the installed torch has it (it deprecates
    # all_gather_into_tensor in its favour), the older name elsewhere
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, mesh: Mesh, async_op: bool = False):
    """Every rank's ``t`` (one shape on every rank), rank-major along dim 0.
    With ``async_op``: ``(out, work)``, ``out`` valid after ``work.wait()``."""
    t = t.contiguous()
    out = t.new_empty((mesh.size * t.shape[0], *t.shape[1:]))
    work = _gather_into()(out, t, group=mesh.group, async_op=async_op)
    return (out, work) if async_op else out


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``t``, in place."""
    dist.all_reduce(t, group=mesh.group)
    return t


def ring_shift(t: torch.Tensor, mesh: Mesh):
    """Send ``t`` to rank r + 1 and receive rank r − 1's into a new tensor,
    both in flight: ``(received, works)``, valid after each work's
    ``wait()``. A ring of one rank has no neighbour (a send to one's own
    rank fails), so callers skip the shift there."""
    t = t.contiguous()
    got = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, (mesh.rank + 1) % mesh.size, mesh.group),
           dist.P2POp(dist.irecv, got, (mesh.rank - 1) % mesh.size, mesh.group)]
    return got, dist.batch_isend_irecv(ops)

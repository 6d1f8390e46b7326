"""One gloo rank of the port's distributed tests (``test_torch_dist_mp.py``).

    _torch_dist_worker.py <port> <world> <rank> <out_dir> [--scaling]

Brings up a CPU process group of ``world`` ranks on ``127.0.0.1:<port>``
through ``spmv_tpu_torch.dist.mesh.init_distributed``, runs every case of
``CASES`` at each size of ``SIZES`` on the port's sharded containers (the
plain PyTorch versions), and saves each case's whole output (y, Y, or cg's
x, k and residual) to ``<out_dir>/rank<rank>.npz``. With ``--scaling`` it
then runs ``bench --scaling --device cpu --rows-per-device 1024`` through
the port's CLI in the same group (rank 0 writes ``<out_dir>/scaling0.json``;
the other ranks neither print nor write).
It ends by asserting that it never imported ``jax`` or ``spmv_tpu``.

The case list, the seeded inputs and ``build``/``run`` take the classes as
an argument, so the parent test builds the JAX package's sharded
containers from the same specs and triplets. This module imports numpy
only at its top.
"""

import os
import sys
from typing import NamedTuple

import numpy as np

SIZES = (700, 1021)  # 1021: ragged against every slab
RHS = 4
SCALING_ROWS = 1024


class Case(NamedTuple):
    kind: str  # row, col, ring, chunked, cg-row, cg-col
    fmt: str
    gather_x: bool | None = None
    x2: bool = False
    rhs: int = 1

    @property
    def name(self) -> str:
        g = "" if self.gather_x is None else f"-g{int(self.gather_x)}"
        return (f"{self.kind}-{self.fmt}{g}{'-x2' if self.x2 else ''}"
                f"{f'-R{self.rhs}' if self.rhs > 1 else ''}")


def _cases() -> list:
    out = [Case("row", f, g) for f in ("csr", "coo", "cmrs", "ell", "sell", "hyb")
           for g in (True, False)]
    out += [Case("col", f) for f in ("csr", "ell", "sell", "hyb")]
    out += [Case("ring", f) for f in ("csr", "cmrs", "ell", "sell", "hyb")]
    out += [Case("chunked", f) for f in ("csr", "cmrs", "ell", "sell", "hyb")]
    out += [Case("row", f, g, x2=True) for f in ("csr", "cmrs", "ell", "sell")
            for g in (True, False)]
    out += [Case("col", f, x2=True) for f in ("csr", "coo", "ell", "sell")]
    out += [Case(k, f, True if k == "row" else None, rhs=RHS)
            for k in ("row", "col", "ring") for f in ("csr", "sell", "hyb")]
    out += [Case("chunked", f, rhs=RHS) for f in ("csr", "sell")]
    out += [Case("row", "bsr", g, rhs=RHS) for g in (True, False)]
    out += [Case("cg-row", "csr", True), Case("cg-col", "csr")]
    return out


CASES = _cases()


def data(n: int, synth) -> dict:
    """The seeded inputs of size ``n`` (``synth``: either package's
    ``synth`` module; the port's is a copy of JAX's)."""
    info, r, c, v = synth.synthetic_cant(n=n, avg_nnz_per_row=10, bandwidth=50,
                                         seed=4)
    d = {"info": info, "r": r, "c": c, "v": v,
         "x": np.random.default_rng(5).standard_normal(info.ncols).astype(np.float32),
         "X": np.random.default_rng(6).standard_normal((info.ncols, RHS)).astype(np.float32),
         # fp64-only mantissa content, as tests/test_dist.py:_x2_data makes it
         "v64": np.asarray(v, np.float64) * (1 + 1e-9 * np.arange(v.size)),
         "x64": np.random.default_rng(7).standard_normal(info.ncols),
         "b": np.random.default_rng(8).standard_normal(info.nrows).astype(np.float32)}
    dense = np.zeros((info.nrows, info.ncols))
    dense[r, c] = v
    spd = dense @ dense.T + info.nrows * np.eye(info.nrows)  # __graft_entry__.py:169-172
    d["spd"] = np.nonzero(spd) + (spd[np.nonzero(spd)],)
    return d


def build(classes: dict, case: Case, d: dict, mesh):
    """``case``'s sharded container from ``classes`` (``row``, ``col``,
    ``ring``, ``chunked``: either package's classes)."""
    info = d["info"]
    if case.kind.startswith("cg"):
        n = info.nrows
        return classes[case.kind[3:]](case.fmt, n, n, *d["spd"], mesh)
    v = d["v64"] if case.x2 else d["v"]
    args = (case.fmt, info.nrows, info.ncols, d["r"], d["c"], v, mesh)
    kw = {"dtype": "f32x2"} if case.x2 else {}
    if case.kind == "row":
        return classes["row"](*args, gather_x=case.gather_x, **kw)
    if case.kind == "chunked":
        return classes["chunked"](*args, chunks=2)
    return classes[case.kind](*args, **kw)


def run(a, case: Case, d: dict, spmm):
    """``case``'s output of ``a``. ``spmm`` is the package's ``api.spmm``:
    the chunked form goes through it, since JAX's has no ``spmm`` of its
    own and its ``api.spmm`` stacks one ``matvec`` per column."""
    if case.rhs > 1:
        return spmm(a, d["X"]) if case.kind == "chunked" else a.spmm(d["X"])
    return a.matvec(d["x64"] if case.x2 else d["x"])


def main() -> int:
    port, world, rank, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # ranks share the host's cores

    from spmv_tpu_torch import cli, solve, spmm, synth
    from spmv_tpu_torch.dist.mesh import init_distributed, make_mesh
    from spmv_tpu_torch.dist.overlap import ChunkedRowSpmv
    from spmv_tpu_torch.dist.ring import RingShardedSpmv
    from spmv_tpu_torch.dist.sharded import ColShardedSpmv, RowShardedSpmv

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, dist.get_backend()) == (world, rank, "gloo")
    classes = {"row": RowShardedSpmv, "col": ColShardedSpmv,
               "ring": RingShardedSpmv, "chunked": ChunkedRowSpmv}
    results = {}
    for n in SIZES:
        d = data(n, synth)
        for case in CASES:
            a = build(classes, case, d, mesh)
            key = f"{n}/{case.name}"
            if case.kind.startswith("cg"):
                x, k, res = solve.cg(a, d["b"], tol=1e-5, maxiter=400)
                results.update({f"{key}/x": x.numpy(), f"{key}/k": np.array(k),
                                f"{key}/res": np.array(res)})
                continue
            y = run(a, case, d, spmm)
            again = run(a, case, d, spmm)
            assert bool((y == again).all()), f"{key}: two calls differ"
            results[key] = y.numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    if "--scaling" in sys.argv:
        argv = ["bench", "--scaling", "--device", "cpu", "--rows-per-device",
                str(SCALING_ROWS), "--json", os.path.join(out, f"scaling{rank}.json")]
        assert cli.main(argv) == 0
    dist.barrier()
    dist.destroy_process_group()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "spmv_tpu"))
    assert not leaked, f"the port imported {leaked}"
    print(f"rank {rank}: done, {len(results)} arrays; no jax, no spmv_tpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``python -m spmv_tpu_torch.probes tiled``: one matrix past one plan's
int32 index range, through ``load``'s routing (``api.route``), on the card.

The matrix is ``synthetic_cant(n=34_000_000, avg_nnz_per_row=64,
bandwidth=350, seed=0)``: about 2.18·10⁹ nonzeros, past 2³¹ − 1, so one CSR
plan cannot index it and the default rule gives a ``TiledSpmv`` of two row
slabs. ``synth.synthetic_cant`` makes its triplets straight into their
final arrays (16 B per nonzero, no sort). The steps, each printed with its
seconds:

1. the host's ``MemTotal`` and ``MemAvailable`` (``/proc/meminfo``) and the
   card's free memory, beside what the run needs; it stops there, with
   the figures, where either cannot hold it;
2. the triplets, then ``api.route("csr", ...)``: the slabs, their nonzeros
   and plan bytes;
3. one ``matvec`` of a seeded float32 x in a window of the kernel counters,
   held to ``golden_spmv`` (fp64 on the host, block by block of rows: each
   row's sum is the whole call's) by ``kernel_check``;
4. its time by CUDA-graph replay (20 calls) beside its bound: the bytes
   the function must move (the plans, x and y, each once) over 3.35 TB/s;
5. the library time: ``torch.sparse_csr_tensor`` with int64 indices
   (cuSPARSE) over the same matrix on the card, checked against the same
   oracle, where the card holds it beside the tiled plans; a call that
   cuSPARSE refuses is recorded as not measured.

``--n`` and ``--bound`` (a plan bound lowered from int32's) rehearse it at
a small size, and ``--device cpu`` on the plain versions (no times).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

__all__ = ["run_tiled", "MATRIX", "meminfo"]

# the past-int32 matrix: synthetic_cant's parameters
MATRIX = dict(n=34_000_000, avg_nnz_per_row=64, bandwidth=350, seed=0)
# host bytes per nonzero the run holds at its peak: the triplets (int32,
# int32, float64), the float32 values of the plans, and one slab's int64
# row indices while its row pointer is counted
HOST_B_PER_NNZ = 16 + 4 + 8
# card bytes per nonzero: the plans (int32 column, float32 value) and the
# library's copy (int64 column, float32 value)
CARD_B_PER_NNZ = 8 + 12


def meminfo() -> dict:
    """``MemTotal`` and ``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def _golden_blocks(trip, x: np.ndarray, block: int = 1 << 22):
    """``golden_spmv`` and ``row_scale`` of row-ordered triplets, ``block``
    rows at a time (each row's sum as one whole call makes it), and the
    longest row."""
    from spmv_tpu_torch.big import _positions
    from spmv_tpu_torch.oracle import golden_spmv, row_scale

    info, rows, cols, vals = trip
    bounds = np.append(np.arange(0, info.nrows, block, dtype=np.int64), info.nrows)
    at = _positions(rows, bounds)
    exp, scale = [], []
    for i in range(len(bounds) - 1):
        r0, n = int(bounds[i]), int(bounds[i + 1] - bounds[i])
        r = rows[at[i]:at[i + 1]] - r0
        c, v = cols[at[i]:at[i + 1]], vals[at[i]:at[i + 1]]
        exp.append(golden_spmv(n, r, c, v, x))
        scale.append(row_scale(n, r, c, v, x))
    longest = int(np.diff(_positions(rows, np.arange(info.nrows + 1))).max())
    return np.concatenate(exp), np.concatenate(scale), longest


def _library(a, trip, device) -> torch.Tensor:
    """The matrix as ``torch.sparse_csr_tensor`` with int64 indices on the
    card, from the tiled plans' device columns and values (no host copy)."""
    from spmv_tpu_torch.big import _positions

    info, rows = trip[0], trip[1]
    crow = torch.from_numpy(_positions(rows, np.arange(info.nrows + 1, dtype=np.int64)))
    col = torch.empty(rows.size, dtype=torch.int64, device=device)
    val = torch.empty(rows.size, dtype=torch.float32, device=device)
    at = 0
    for slab in a.tiles:
        for _, c in slab:
            n = c.dev.nnz
            col[at:at + n].copy_(c.dev.cols)
            val[at:at + n].copy_(c.dev.vals)
            at += n
    return torch.sparse_csr_tensor(crow.to(device), col, val,
                                   size=(info.nrows, info.ncols))


def _library_run(make, x, check) -> tuple[float | None, str]:
    """(ms per call by CUDA-graph replay or None, what happened) of ``m @
    x`` for the matrix ``m = make()``, checked by ``check`` first. A call
    the library refuses is recorded, not raised."""
    from spmv_tpu_torch.probes.timing import graph_ms

    try:
        m = make()
        rep = check(m @ x)
        return graph_ms(lambda: m @ x), f": {rep}"
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f": not measured, {str(e).splitlines()[0][:200]}"


def run_tiled(n: int = MATRIX["n"], *, avg_nnz_per_row: int = MATRIX["avg_nnz_per_row"],
              bandwidth: int = MATRIX["bandwidth"], seed: int = MATRIX["seed"],
              device="cuda", bound: int | None = None, json_path: str = "",
              out=print) -> dict:
    """The run the module docstring describes; returns its figures (and
    writes them to ``json_path``). A wrong y raises AssertionError."""
    from spmv_tpu_torch import api, synth
    from spmv_tpu_torch.bench.runner import traffic_model
    from spmv_tpu_torch.big import TiledSpmv
    from spmv_tpu_torch.formats import base
    from spmv_tpu_torch.kernels.engines import LAUNCHES
    from spmv_tpu_torch.oracle import kernel_check
    from spmv_tpu_torch.probes.bounds import bound_ms
    from spmv_tpu_torch.probes.timing import card_line, graph_ms

    device = torch.device(device)
    on_card = device.type == "cuda"
    card = card_line(device) if on_card else "plain PyTorch versions, CPU"
    params = dict(n=n, avg_nnz_per_row=avg_nnz_per_row, bandwidth=bandwidth, seed=seed)
    res: dict = {"matrix": f"synthetic_cant({params})", "card": card, "seconds": {}}
    mem = meminfo()
    est = n * avg_nnz_per_row
    res.update(host_mem_total=mem["MemTotal"], host_mem_available=mem["MemAvailable"],
               estimated_nnz=est, host_bytes_needed=est * HOST_B_PER_NNZ)
    if on_card:
        free, total = torch.cuda.mem_get_info(device)
        res.update(card_mem_free=free, card_mem_total=total,
                   card_bytes_needed=est * CARD_B_PER_NNZ)
    out(f"probe tiled: {res['matrix']}, about {est} nonzeros  [{card}]")
    out(f"  host: MemTotal {mem['MemTotal']} B, MemAvailable {mem['MemAvailable']} B, "
        f"needs about {res['host_bytes_needed']} B; card: "
        + (f"{res['card_mem_free']} B free of {res['card_mem_total']}, needs about "
           f"{res['card_bytes_needed']} B (the library's copy included)" if on_card
           else "none"))
    if res["host_bytes_needed"] > mem["MemAvailable"]:
        raise MemoryError(f"the host cannot hold the run: {res['host_bytes_needed']} B "
                          f"needed, {mem['MemAvailable']} B available")

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        res["seconds"][name] = time.perf_counter() - t0
        return r

    trip = step("triplets", lambda: synth.synthetic_cant(**params))
    info, rows, cols, vals = trip
    res["nnz"] = int(rows.size)
    out(f"  triplets: {info.nrows} x {info.ncols}, {rows.size} nonzeros "
        f"({rows.size / (2**31 - 1):.3f} × 2^31 - 1) in {res['seconds']['triplets']:.1f} s")
    real = base.plan_entry_limit
    if bound is not None:
        base.plan_entry_limit = lambda tile, slice_rows=1: bound
    try:
        a = step("route", lambda: api.route("csr", info.nrows, info.ncols, rows, cols,
                                            vals, device=device))
    finally:
        base.plan_entry_limit = real
    if not isinstance(a, TiledSpmv):
        raise AssertionError(f"route gave a {type(a).__name__}, not a TiledSpmv")
    plan_bytes = a.stream_bytes
    res.update(DR=a.DR, DC=a.DC, n_tiles=a.n_tiles, plan_bytes=plan_bytes,
               aux_bytes=a.aux_traffic_bytes,
               slab_rows=[int(r) for r in np.diff(a.row_bounds)],
               slab_nnz=[int(c.nnz) for slab in a.tiles for _, c in slab])
    out(f"  route: TiledSpmv of {a.DR} slab(s) x {a.DC} panel, rows {res['slab_rows']}, "
        f"nonzeros {res['slab_nnz']}, plans {plan_bytes} B, in "
        f"{res['seconds']['route']:.1f} s")

    x = np.random.default_rng(3).standard_normal(info.ncols).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    before = dict(LAUNCHES)
    y = step("matvec", lambda: a.matvec(xd).cpu().numpy())
    res["launches_per_call"] = {k: v - before[k] for k, v in LAUNCHES.items()
                                if v > before[k]}
    expected, scale, longest = step("golden", lambda: _golden_blocks(trip, x))
    rep = kernel_check(expected, y, scale, longest)
    res["check"] = str(rep)
    out(f"  matvec: {rep} (golden_spmv in fp64 on the host, "
        f"{res['seconds']['golden']:.1f} s); launches {res['launches_per_call']}")
    if not rep.ok:
        raise AssertionError(f"the tiled matvec against golden_spmv: {rep}")

    nbytes = plan_bytes + 4 * (info.nrows + info.ncols)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2 * rows.size)
    res["bound_bytes"] = nbytes
    res["traffic_model_bytes"] = traffic_model(a)[1] + 4 * (info.nrows + info.ncols)
    res["ms"] = res["library_ms"] = None
    if on_card:
        res["ms"] = step("timing", lambda: graph_ms(lambda: a.matvec(xd)))
        out(f"  time: {res['ms']:.4f} ms per call by CUDA-graph replay (20 calls) "
            f"against its bound {res['bound_ms']:.4f} ms ({nbytes} B at 3.35 TB/s; "
            f"{res['bound_ms'] / res['ms']:.1%}), {rows.size / res['ms'] / 1e6:.2f} "
            f"Gnnz/s  [{card}]")
        _write(res, json_path)  # the figures so far, should a library call fail hard

        def check(y):
            return kernel_check(expected, y.cpu().numpy(), scale, longest)

        free = torch.cuda.mem_get_info(device)[0]
        need = 12 * rows.size + 8 * (info.nrows + 1)
        res["library"] = "torch.sparse_csr_tensor (int64 indices) @ x, cuSPARSE"
        if need > free:
            res["library"] += f": not measured, {need} B needed and {free} B free"
        else:
            res["library_ms"], note = step("library", lambda: _library_run(
                lambda: _library(a, trip, device), xd, check))
            res["library"] += note
        out(f"  library: {res['library']}" + (f", {res['library_ms']:.4f} ms" if
                                               res["library_ms"] else "") + f"  [{card}]")
    else:
        out("  time: not measured (no card)")
    _write(res, json_path)
    return res


def _write(res: dict, json_path: str) -> None:
    if json_path:
        with open(json_path, "w") as f:
            json.dump(res, f, indent=2)

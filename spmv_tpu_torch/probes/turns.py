"""Two checkouts' segmented tile kernels, timed in turns on one card.

    python -m spmv_tpu_torch.probes.turns OTHER_ROOT [--out DIR]
        [--probe NAME:MATRIX ...] [--rounds N]

Measures a change to K1/K12 (``kernels/csrc/seg_tile.cuh``) against another
checkout of the repository (the commit it changes, unpacked with ``git
archive``) in one run on one card, in turns: OTHER, THIS, THIS, OTHER. Each
turn is a fresh process that imports ``spmv_tpu_torch`` from one checkout,
so it builds and launches that checkout's kernels through that checkout's
wrappers, and:

* runs K1 and K12 on cant, ``pl_big``, ``pl_wide`` and band-1024 (the
  probes' ``common.MATRICES``, named to the worker by generator and
  arguments, so an older checkout builds the same ones; x from a seed) and saves
  their y and carries as ``.npy`` under ``DIR/<turn>-<checkout>/``;
* times K1, the K1 + K2 path, K12 and the K12 + K13 path (``timing.graph_ms``:
  CUDA-graph replay, warm), and cuSPARSE on the same plan in float32 and
  float64 (``torch.sparse_csr_tensor @ x``, a yardstick the port never
  calls), beside each kernel's HBM-peak bound (``bounds``);
* then runs each ``--probe NAME:MATRIX`` (``python -m spmv_tpu_torch.probes``)
  in that checkout, its output saved beside the arrays.

At the end every saved output is compared bit for bit across the four
turns, and each time is printed as the median of its checkout's two turns,
with the card's name and power limit; ``DIR/turns.json`` keeps all of it.
Exits 1 without a card, and when two outputs differ.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

THIS_ROOT = Path(__file__).resolve().parents[2]

# the probes' matrices (``common.MATRICES``) each turn runs K1 and K12 on
TURN_MATRICES = ("cant", "pl_big", "pl_wide", "band")


def matrix_specs(names=TURN_MATRICES) -> dict:
    """name → [generator in ``spmv_tpu_torch.synth``, its keyword
    arguments] of ``common.MATRICES``: what a worker in another checkout,
    whose table may lack a name, builds the same matrices from."""
    from spmv_tpu_torch.probes.common import MATRICES

    return {n: [MATRICES[n].func.__name__, MATRICES[n].keywords] for n in names}


def _worker(out_dir: Path, specs: dict) -> dict:
    """One turn, in a process whose ``spmv_tpu_torch`` is the checkout in
    the working directory: K1 and K12 on the matrices of ``specs``
    (``matrix_specs``), the outputs saved, the times returned."""
    import torch

    import spmv_tpu_torch
    from spmv_tpu_torch import synth
    from spmv_tpu_torch.device import DevCsr
    from spmv_tpu_torch.formats.base import build_csr_plan, csr_ptr
    from spmv_tpu_torch.kernels import engines as E
    from spmv_tpu_torch.kernels import engines_x2 as X2
    from spmv_tpu_torch.probes import bounds as B
    from spmv_tpu_torch.probes.timing import card_line, graph_ms

    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {"f32": (torch.float32, E.segmented_spmv_partials, E.carry_fixup),
               "f64": (torch.float64, X2.segmented_spmv_x2_partials, X2.carry_fixup_x2)}
    res = {"card": card_line(), "package": spmv_tpu_torch.__file__, "ms": {}}
    for name, (gen, kwargs) in specs.items():
        info, r, c, v = getattr(synth, gen)(**kwargs)
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], np.asarray(v, np.float64)[order]
        ptr = csr_ptr(r, info.nrows)
        for key, (dtype, tiles, fixup) in kernels.items():
            vals = v if key == "f32" else v * (1 + 1e-9 * np.arange(v.size) / max(v.size, 1))
            np_dtype = np.float32 if key == "f32" else np.float64
            dev = DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, ptr, c, vals,
                                                  dtype=np_dtype), "cuda")
            xh = np.random.default_rng(3).standard_normal(info.ncols).astype(np_dtype)
            x = torch.from_numpy(xh).cuda()
            y, carry = tiles(dev, x)
            np.save(out_dir / f"{name}_{key}_y.npy", y.cpu().numpy())
            np.save(out_dir / f"{name}_{key}_carry.npy", carry.cpu().numpy())
            A = torch.sparse_csr_tensor(dev.ptr, dev.cols, dev.vals, (dev.nrows, dev.ncols))
            flops = 2 * dev.nnz
            res["ms"][f"{name} {key} tiles"] = graph_ms(lambda: tiles(dev, x))
            res["ms"][f"{name} {key} path"] = graph_ms(lambda: fixup(dev, *tiles(dev, x)))
            res["ms"][f"{name} {key} cusparse"] = graph_ms(lambda: A @ x)
            res["ms"][f"{name} {key} tiles bound"] = B.bound_ms(
                B.seg_tiles_bytes(dev), flops, dtype)[0]
            res["ms"][f"{name} {key} path bound"] = B.bound_ms(
                B.csr_spmv_bytes(dev), flops, dtype)[0]
            del dev, A
        torch.cuda.synchronize()
    return res


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def compare(dirs: list[Path]) -> list[str]:
    """The saved outputs that differ, bit for bit, from the first turn's."""
    bad = []
    for f in sorted(dirs[0].glob("*.npy")):
        first = _bits(np.load(f))
        for d in dirs[1:]:
            other = d / f.name
            if not other.exists() or not np.array_equal(first, _bits(np.load(other))):
                bad.append(f"{d.name}/{f.name}")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spmv_tpu_torch.probes.turns",
                                description=__doc__.splitlines()[0])
    p.add_argument("other", help="root of the other checkout")
    p.add_argument("--out", default="turns_out",
                   help="directory for the outputs and turns.json")
    p.add_argument("--probe", action="append", default=[],
                   help="NAME:MATRIX, run in each turn, e.g. ablate:pl_big")
    p.add_argument("--rounds", type=int, default=5, help="rounds of each probe")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("turns: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    roots = {"other": Path(args.other).resolve(), "this": THIS_ROOT}
    out = Path(args.out).resolve()
    turns, dirs = [], {"other": [], "this": []}
    specs = json.dumps(matrix_specs())
    for i, tree in enumerate(("other", "this", "this", "other")):
        d = out / f"{i}-{tree}"
        proc = subprocess.run([sys.executable, __file__, "--worker", str(d), specs],
                              cwd=roots[tree], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = tree
        for spec in args.probe:
            name, matrix = spec.split(":")
            probe = subprocess.run(
                [sys.executable, "-m", "spmv_tpu_torch.probes", name, "--matrix",
                 matrix, "--rounds", str(args.rounds)],
                cwd=roots[tree], capture_output=True, text=True)
            (d / f"probe_{name}_{matrix}.txt").write_text(probe.stdout + probe.stderr)
            print(f"turn {i} ({tree}, {roots[tree]}): probes {name} --matrix {matrix}")
            print(probe.stdout)
            if probe.returncode:
                print(probe.stderr, file=sys.stderr)
                return 1
        turns.append(res)
        dirs[tree].append(d)
        print(f"turn {i} ({tree}) done  [{res['card']}]", flush=True)

    bad = compare(dirs["other"] + dirs["this"])
    card = turns[0]["card"]
    print(f"K1 / K12 device ms, median of each checkout's two turns (CUDA-graph "
          f"replay, warm); 'bound' is the HBM-peak bound  [{card}]")
    medians = {}
    for key in turns[0]["ms"]:
        m = {tree: statistics.median(t["ms"][key] for t in turns if t["tree"] == tree)
             for tree in ("other", "this")}
        medians[key] = m
        ratio = m["this"] / m["other"] if m["other"] else float("nan")
        print(f"  {key:28s} other {m['other'] * 1e3:9.2f} µs  this "
              f"{m['this'] * 1e3:9.2f} µs  this/other {ratio:.3f}")
    n = len(list(dirs["other"][0].glob("*.npy")))
    print(f"bit for bit: {n} outputs of each of four turns; "
          + ("all equal" if not bad else f"{len(bad)} differ: {bad}"))
    (out / "turns.json").write_text(json.dumps(
        {"roots": {k: str(v) for k, v in roots.items()}, "turns": turns,
         "medians_ms": medians, "differ": bad}, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        # run as a file: import spmv_tpu_torch from the working directory,
        # the checkout of this turn, not from the directory of this file
        sys.path[0] = os.getcwd()
        print(json.dumps(_worker(Path(sys.argv[2]), json.loads(sys.argv[3]))))
        sys.exit(0)
    sys.exit(main())

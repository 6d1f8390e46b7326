"""``python -m spmv_tpu_torch.probes NAME``: one probe from the command
line (see ``spmv_tpu_torch.probes``), or ``tiled``: the past-int32 run of
``probes.tiled`` (``--n``, ``--bound`` and ``--json`` are its). Without a
card it stops with "no CUDA device" unless ``--device cpu`` asks for the
plain versions."""

from __future__ import annotations

import argparse
import sys

from spmv_tpu_torch.cli import _device_error
from spmv_tpu_torch.errors import ReturnCode
from spmv_tpu_torch.kernels._build import BuildError
from spmv_tpu_torch.kernels.engines import KernelError
from spmv_tpu_torch.probes import MATRICES, PROBES, run_probe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m spmv_tpu_torch.probes",
                                description="on-card probes of the segmented kernels")
    p.add_argument("probe", choices=sorted(PROBES) + ["tiled"])
    p.add_argument("--matrix", default="cant", choices=sorted(MATRICES))
    p.add_argument("--rounds", type=int, default=5,
                   help="interleaved timing rounds (medians are printed)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu (the "
                        "plain versions, checked, no times)")
    p.add_argument("--n", type=int, default=None,
                   help="tiled: rows of the matrix (default 34,000,000)")
    p.add_argument("--bound", type=int, default=None,
                   help="tiled: a plan bound lowered from int32's, to rehearse small")
    p.add_argument("--json", default="", help="tiled: write the figures here")
    args = p.parse_args(argv)
    why = _device_error(args.device)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return ReturnCode.DEVICE_ERROR
    try:
        if args.probe == "tiled":
            from spmv_tpu_torch.probes.tiled import MATRIX, run_tiled

            run_tiled(args.n or MATRIX["n"], device=args.device, bound=args.bound,
                      json_path=args.json)
        else:
            run_probe(args.probe, args.matrix, rounds=args.rounds, device=args.device)
    except (ValueError, BuildError, KernelError, MemoryError) as e:
        print(f"error: {e}", file=sys.stderr)
        return ReturnCode.PROGRAM_ERROR
    except AssertionError as e:
        print(f"check failed: {e}", file=sys.stderr)
        return ReturnCode.VALIDATION_FAILED
    return ReturnCode.SUCCESS


if __name__ == "__main__":
    sys.exit(int(main()))

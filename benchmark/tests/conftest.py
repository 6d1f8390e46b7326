"""A copy of the benchmark at a size the CPU runs in seconds.

``tiny_root`` is a directory laid out as a checkout's: ``BENCHMARK.json``
as committed, ``benchmark/{traffic,metrics,limits,kinds,gen}`` copied, and
each configuration file cut to a few thousand rows (and its stated counts
dropped). Run with ``python -m pytest benchmark/tests`` from
the repository's root.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = {"hpcg_stencil": {"nx": 14, "ny": 13, "nz": 12}, "kronecker": {"scale": 11}}
COPIED = ("traffic", "metrics", "limits", "kinds", "gen")


def make_tiny_root(dest: Path) -> Path:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for d in COPIED:
        shutil.copytree(ROOT / "benchmark" / d, dest / "benchmark" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "benchmark" / "configs").mkdir(parents=True)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY[cfg["generator"]])
        for k in ("nrows", "nnz"):
            cfg.pop(k, None)
        (dest / c["file"]).write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the ``file`` its ``configs`` entry names, and
the configuration names its matrix's generator,
``benchmark/gen/<generator>.py``; its traffic mix is
``benchmark/traffic/<traffic>.json``, which names its job kind,
``benchmark/kinds/<job>.py``; its correctness limits are
``benchmark/limits/<workload>.json``; a metric's reader is
``benchmark/metrics/<metric>.py``. A later cell adds files and entries and
edits none of these.

A configuration's ``dtype`` is one of ``DTYPES``. It picks the port's
container (``benchmark/session.py``: ``from_coo``'s for float32, the
fp64-grade ``X2Matrix`` for float64), the type of the inputs that the job
kinds draw and of the traced ``matvec``'s x, and the width at which the
rooflines count values, x and y (``benchmark/roofline.py``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["ROOT", "DTYPES", "Cell", "load_cell", "metric_reader", "kind", "generator"]

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("float32", "float64")


@dataclass
class Cell:
    root: Path
    workload: dict  # the ``workloads`` entry
    config: dict  # the configuration file's content
    traffic: dict  # the traffic file's content
    limits: dict  # compared number -> limit
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path | str = ROOT) -> Cell:
    """The cell named ``workload`` and everything it names, under ``root``
    (the directory of ``BENCHMARK.json``). A configuration whose ``dtype``
    is not one of ``DTYPES`` is refused here, before any card is touched."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"choose from {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    file = configs[w["config"]]["file"]
    config = json.loads((root / file).read_text())
    if config["dtype"] not in DTYPES:
        raise ValueError(f"{file}: dtype {config['dtype']!r}; the benchmark runs "
                         f"{' or '.join(map(repr, DTYPES))}")
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(root=root, workload=w, config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, workload)])


def _module(root: Path, folder: str, name: str):
    path = Path(root) / "benchmark" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(root: Path, name: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    return _module(root, "metrics", name).read


def kind(root: Path, name: str):
    """The job kind ``benchmark/kinds/<name>.py``."""
    return _module(root, "kinds", name)


def generator(root: Path, name: str):
    """The matrix generator ``benchmark/gen/<name>.py``."""
    return _module(root, "gen", name)

"""Nothing the run loads is JAX or the JAX package, compared by whole
top-level module names; the reference loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from benchmark import run

from .conftest import ROOT


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spmv_tpu_torch_lookalike", types.ModuleType("x"))
    assert "spmv_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spmv_tpu.solve", types.ModuleType("spmv_tpu.solve"))
    assert run.forbidden_modules() == ["spmv_tpu"]
    monkeypatch.delitem(sys.modules, "spmv_tpu.solve")
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib"]


def test_a_run_loads_none(tiny_root):
    code = (
        "import sys, json\n"
        "from benchmark import run\n"
        f"r = run.run_cell('kron22.power', 5, 0.2, False, root={str(tiny_root)!r}, "
        "device='cpu', note=lambda *a: None)\n"
        "print(json.dumps([r['correct'], run.forbidden_modules(), "
        "'spmv_tpu_torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[true, [], true]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.check, benchmark.reference.plain, benchmark.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'spmv_tpu_torch', 'spmv_tpu', 'jax', 'jaxlib'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_sources_name_no_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("spmv_tpu_torch", "spmv_tpu", "jax"), path

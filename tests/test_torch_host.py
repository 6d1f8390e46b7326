"""The PyTorch port's host copies (synth, mmio, oracle, errors) against the
JAX package's originals, and the port's import boundary: the port must run
where JAX is not installed."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spmv_tpu import errors as ref_errors
from spmv_tpu import oracle as ref_oracle
from spmv_tpu import synth as ref_synth
from spmv_tpu.io import mmio as ref_mmio
from spmv_tpu_torch import errors, oracle, synth
from spmv_tpu_torch.io import mmio

REPO = Path(__file__).resolve().parents[1]

GENERATORS = {
    "synthetic_cant_1024": lambda s: s.synthetic_cant(
        n=1024, avg_nnz_per_row=16, bandwidth=60, seed=5),
    "synthetic_cant_sorted": lambda s: s.synthetic_cant(
        n=999, sorted_by_row_length=True, seed=2),
    "power_law_4096": lambda s: s.power_law(n=4096, seed=3),
    "power_law_banded": lambda s: s.power_law(
        n=4096, avg_nnz_per_row=24, bandwidth=64, seed=1),
    "random_coo": lambda s: s.random_coo(500, 300, 4000, seed=3),
    "random_coo_duplicates": lambda s: s.random_coo(
        50, 40, 3000, seed=4, allow_duplicates=True),
}

MTX = {
    "symmetric_real": "%%MatrixMarket matrix coordinate real symmetric\n"
                      "% a comment\n4 4 5\n1 1 2.0\n2 1 -1.5\n3 2 4.25\n"
                      "4 4 1e-3\n4 1 7\n",
    "skew_symmetric": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
                      "3 3 2\n2 1 1.5\n3 1 -2\n",
    "pattern_symmetric": "%%MatrixMarket matrix coordinate pattern symmetric\n"
                         "5 5 4\n1 1\n3 1\n5 2\n4 4\n",
    "pattern_general": "%%MatrixMarket matrix coordinate pattern general\n"
                       "3 4 3\n1 4\n3 1\n2 2\n",
    "integer_general": "%%MatrixMarket matrix coordinate integer general\n"
                       "2 3 3\n1 1 3\n2 3 -4\n1 2 7\n",
    "empty": "%%MatrixMarket matrix coordinate real general\n3 3 0\n",
}


def assert_same_triplets(mine, ref):
    assert dataclasses.astuple(mine[0]) == dataclasses.astuple(ref[0])
    for a, b in zip(mine[1:], ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_synth_generators_give_identical_bytes(name):
    assert_same_triplets(GENERATORS[name](synth), GENERATORS[name](ref_synth))


@pytest.mark.parametrize("edge", sorted(ref_synth.EDGE_CASES))
def test_synth_edge_cases_give_identical_bytes(edge):
    assert sorted(synth.EDGE_CASES) == sorted(ref_synth.EDGE_CASES)
    assert_same_triplets(synth.edge_case(edge, seed=3),
                         ref_synth.edge_case(edge, seed=3))


def test_read_coo_example_matches_original():
    path = REPO / "databases" / "example.mtx"
    assert_same_triplets(mmio.read_coo(path), ref_mmio.read_coo(path))


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("name", sorted(MTX))
def test_read_coo_hand_written_files_match_original(tmp_path, name, expand):
    path = tmp_path / f"{name}.mtx"
    path.write_text(MTX[name])
    assert_same_triplets(mmio.read_coo(path, expand_symmetry=expand),
                         ref_mmio.read_coo(path, expand_symmetry=expand))


def test_read_coo_gzip_and_banner(tmp_path):
    import gzip

    path = tmp_path / "m.mtx.gz"
    with gzip.open(path, "wt") as f:
        f.write(MTX["symmetric_real"])
    assert_same_triplets(mmio.read_coo(path), ref_mmio.read_coo(path))
    dense = tmp_path / "d.mtx"
    dense.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n")
    assert (dataclasses.astuple(mmio.read_banner(dense))
            == dataclasses.astuple(ref_mmio.read_banner(dense)))


@pytest.mark.parametrize("body", [
    "%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n3 3 1\n4 1 1.0\n",
    "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "%%NotMatrixMarket matrix coordinate real general\n1 1 1\n1 1 1\n",
])
def test_read_coo_refuses_what_the_original_refuses(tmp_path, body):
    path = tmp_path / "bad.mtx"
    path.write_text(body)
    with pytest.raises(ref_mmio.MMError):
        ref_mmio.read_coo(path)
    with pytest.raises(mmio.MMError):
        mmio.read_coo(path)


def test_read_path_or_synthesize_matches_original(tmp_path):
    pointer = tmp_path / "cant.mtx"
    pointer.write_text("version https://git-lfs.github.com/spec/v1\n"
                       "oid sha256:0\nsize 1\n")
    for path in (pointer, tmp_path / "missing.mtx"):
        assert not mmio.is_real_mtx(str(path))
        assert_same_triplets(
            mmio.read_path_or_synthesize(str(path), n=600, seed=4),
            ref_mmio.read_path_or_synthesize(str(path), n=600, seed=4))
    real = REPO / "databases" / "example.mtx"
    assert mmio.is_real_mtx(str(real)) == ref_mmio.is_real_mtx(str(real))


def test_oracle_copies_match_original():
    info, r, c, v = synth.random_coo(60, 50, 700, seed=2, allow_duplicates=True)
    x = np.random.default_rng(0).standard_normal(info.ncols)
    y = oracle.golden_spmv(info.nrows, r, c, v, x)
    assert y.tobytes() == ref_oracle.golden_spmv(info.nrows, r, c, v, x).tobytes()
    noisy = y + 1e-7 * np.arange(y.size)
    for kw in ({}, {"tol_abs": 1e-9}, {"tol_rel": 1e-3, "scale": np.abs(y)}):
        assert (str(oracle.check_result(y, noisy, **kw))
                == str(ref_oracle.check_result(y, noisy, **kw)))
    assert oracle.EPSILON == ref_oracle.EPSILON
    assert oracle.default_x(7).tobytes() == ref_oracle.default_x(7).tobytes()
    for k in (0, 1, 64, 1000):
        assert oracle.fp32_rel_tol(k) == ref_oracle.fp32_rel_tol(k)


def test_kernel_check_bounds_by_row_scale():
    info, r, c, v = synth.synthetic_cant(n=300, avg_nnz_per_row=12,
                                         bandwidth=30, seed=1)
    x = np.random.default_rng(1).standard_normal(info.ncols)
    y = oracle.golden_spmv(info.nrows, r, c, v, x)
    scale = oracle.row_scale(info.nrows, r, c, v, x)
    lengths = np.bincount(r, minlength=info.nrows)
    assert oracle.kernel_check(y, y.astype(np.float32), scale, lengths.max()).ok
    off = y.copy()
    off[5] += 1e-3 + scale[5] * 1e-2
    rep = oracle.kernel_check(y, off, scale, lengths.max())
    assert not rep.ok and rep.first_bad == 5


def test_return_codes_match_original():
    assert ({m.name: int(m) for m in errors.ReturnCode}
            == {m.name: int(m) for m in ref_errors.ReturnCode})


def test_import_loads_neither_jax_nor_spmv_tpu():
    code = (
        "import sys\n"
        "import spmv_tpu_torch, spmv_tpu_torch.cli, spmv_tpu_torch.api\n"
        "import spmv_tpu_torch.kernels.engines, spmv_tpu_torch.kernels._build\n"
        "import spmv_tpu_torch.kernels.panel, spmv_tpu_torch.formats.split\n"
        "import spmv_tpu_torch.kernels.probes, spmv_tpu_torch.probes\n"
        "import spmv_tpu_torch.probes.__main__, spmv_tpu_torch.sym\n"
        "import spmv_tpu_torch.solve, spmv_tpu_torch.cache\n"
        "import spmv_tpu_torch.bench.runner, spmv_tpu_torch.io.native\n"
        "import spmv_tpu_torch.dist.sharded, spmv_tpu_torch.dist.ring\n"
        "import spmv_tpu_torch.dist.overlap, spmv_tpu_torch.bench.scaling\n"
        "import spmv_tpu_torch.bench.suite\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'spmv_tpu', 'bench'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_import_jax():
    """Nor the root ``bench.py`` (module ``bench``), which imports the JAX
    package."""
    files = sorted((REPO / "spmv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "spmv_tpu", "bench"), (
                    f"{f.relative_to(REPO)} imports {n}")

"""The MatrixMarket extras of ``spmv_tpu_torch.io``: ``write_coo`` and
``write_dense`` byte for byte the JAX package's, ``read_dense`` its arrays,
and the C++ body parser (``io.native``) against JAX's and the numpy path,
built from the port's own source into ``spmv_tpu_torch/_build/``."""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spmv_tpu.io import mmio as jax_mmio
from spmv_tpu.io import native as jax_native

from spmv_tpu_torch import synth
from spmv_tpu_torch.io import mmio, native

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh_native():
    """The binding's load state reset before and after the test."""
    native._tried, native._lib = False, None
    yield native
    native._tried, native._lib = False, None


@pytest.fixture
def needs_native(fresh_native):
    if not native.ensure_built():
        pytest.skip("no C++ compiler: the native parser cannot be built")
    return fresh_native


def written(write, *args, **kw) -> bytes:
    f = io.StringIO()
    write(f, *args, **kw)
    return f.getvalue().encode()


TRIPLETS = {
    "real": (np.array([0, 4, 2, 2]), np.array([3, 0, 2, 1]),
             np.array([1.5, -2.25e-7, 3.0, 1 / 3])),
    "integer_values": (np.array([1, 0]), np.array([0, 1]), np.array([7, -3])),
    "pattern": (np.array([0, 4, 1]), np.array([3, 0, 1]), None),
    "complex": (np.array([0, 3]), np.array([1, 2]), np.array([1 + 2j, -0.5 - 1e-9j])),
    "empty": (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)),
}


@pytest.mark.parametrize("name", sorted(TRIPLETS))
@pytest.mark.parametrize("comment", [None, "written by a test\nsecond line"])
def test_write_coo_is_jaxs_bytes(name, comment):
    r, c, v = TRIPLETS[name]
    ours = written(mmio.write_coo, 5, 4, r, c, v, comment=comment)
    assert ours == written(jax_mmio.write_coo, 5, 4, r, c, v, comment=comment)


def test_write_coo_files_are_jaxs_and_read_back(tmp_path):
    info, r, c, v = synth.synthetic_cant(n=700, avg_nnz_per_row=7, bandwidth=30, seed=4)
    ours, theirs = tmp_path / "a.mtx", tmp_path / "b.mtx.gz"
    mmio.write_coo(str(ours), info.nrows, info.ncols, r, c, v)
    jax_mmio.write_coo(str(theirs), info.nrows, info.ncols, r, c, v)
    import gzip
    assert ours.read_bytes() == gzip.decompress(theirs.read_bytes())
    for path in (ours, theirs):
        _, r2, c2, v2 = mmio.read_coo(str(path))
        assert np.array_equal(r2, r) and np.array_equal(c2, c) and np.array_equal(v2, v)


@pytest.mark.parametrize("a", [np.arange(12, dtype=np.float64).reshape(3, 4) / 7.0,
                               np.array([[1 + 2j, -3.5j]]), np.zeros((0, 3)),
                               np.array([[1, 2], [3, 4]], dtype=np.int32)])
@pytest.mark.parametrize("comment", [None, "dense"])
def test_write_dense_is_jaxs_bytes_and_round_trips(tmp_path, a, comment):
    ours = written(mmio.write_dense, a, comment=comment)
    assert ours == written(jax_mmio.write_dense, a, comment=comment)
    p = tmp_path / "d.mtx"
    mmio.write_dense(str(p), a, comment=comment)
    info, b = mmio.read_dense(str(p), dtype=np.result_type(a.dtype, np.float64))
    assert (info.nrows, info.ncols) == a.shape and np.array_equal(b, a)


def test_write_dense_refuses_what_jax_refuses():
    for write in (mmio.write_dense, jax_mmio.write_dense):
        with pytest.raises(ValueError, match="2-D"):
            write(io.StringIO(), np.zeros(3))


DENSE = {
    "general": "%%MatrixMarket matrix array real general\n2 3\n1\n2\n3\n4\n5\n6\n",
    "symmetric": "%%MatrixMarket matrix array real symmetric\n3 3\n1\n2\n3\n4\n5\n6\n",
    "skew-symmetric": "%%MatrixMarket matrix array real skew-symmetric\n3 3\n"
                      "0\n2\n3\n0\n5\n0\n",
    "hermitian": "%%MatrixMarket matrix array complex hermitian\n2 2\n1 0\n2 -1\n3 0\n",
    "complex": "%%MatrixMarket matrix array complex general\n% a comment\n2 1\n"
               "1.5 -2\n0 1e-3\n",
    "integer": "%%MatrixMarket matrix array integer general\n1 2\n7\n-8\n",
}


@pytest.mark.parametrize("name", sorted(DENSE))
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_read_dense_is_jaxs(name, dtype):
    info, a = mmio.read_dense(io.StringIO(DENSE[name]), dtype=dtype)
    jinfo, ja = jax_mmio.read_dense(io.StringIO(DENSE[name]), dtype=dtype)
    assert (info.nrows, info.ncols, info.field, info.symmetry) == \
        (jinfo.nrows, jinfo.ncols, jinfo.field, jinfo.symmetry)
    assert a.dtype == ja.dtype and np.array_equal(a, ja)


def test_read_dense_and_read_coo_refuse_the_other_format():
    with pytest.raises(mmio.MMError, match="use read_coo"):
        mmio.read_dense(io.StringIO("%%MatrixMarket matrix coordinate real general\n"
                                    "1 1 1\n1 1 7\n"))
    with pytest.raises(mmio.MMError, match="use read_dense"):
        mmio.read_coo(io.StringIO(DENSE["general"]))


BODIES = {"real": 3, "pattern": 2, "complex": 4}  # field → tokens per entry


def body_file(tmp_path, field: str) -> Path:
    info, r, c, v = synth.synthetic_cant(n=900, avg_nnz_per_row=9, bandwidth=40, seed=12)
    p = tmp_path / f"{field}.mtx"
    if field == "pattern":
        mmio.write_coo(str(p), info.nrows, info.ncols, r, c)
    elif field == "complex":
        mmio.write_coo(str(p), info.nrows, info.ncols, r, c, v * (1 - 0.5j))
    else:
        mmio.write_coo(str(p), info.nrows, info.ncols, r, c, v)
    return p


def body_of(path: Path) -> tuple[bytes, int]:
    text = path.read_bytes()
    lines = text.split(b"\n", 2)  # banner, size line, body
    return lines[2], int(lines[1].split()[2])


@pytest.mark.parametrize("field", sorted(BODIES))
def test_native_parser_is_jaxs_and_the_numpy_paths(tmp_path, needs_native, monkeypatch, field):
    p = body_file(tmp_path, field)
    buf, count = body_of(p)
    ours = native.parse_body(buf, count, BODIES[field])
    if jax_native.available():
        theirs = jax_native.parse_body(buf, count, BODIES[field])
        for a, b in zip(ours, theirs):
            assert (a is None and b is None) or (a.dtype == b.dtype and np.array_equal(a, b))
    got = mmio.read_coo(str(p), dtype=np.complex128)
    monkeypatch.setenv("SPMV_TPU_NO_NATIVE", "1")
    native._tried, native._lib = False, None
    want = mmio.read_coo(str(p), dtype=np.complex128)
    jax_want = jax_mmio.read_coo(str(p), dtype=np.complex128)
    for a, b, c in zip(got[1:], want[1:], jax_want[1:]):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("no_native", [False, True])
def test_a_truncated_body_raises_mmerror_in_both_packages(fresh_native, monkeypatch, no_native):
    if no_native:
        monkeypatch.setenv("SPMV_TPU_NO_NATIVE", "1")
    elif not native.ensure_built():
        pytest.skip("no C++ compiler: the native parser cannot be built")
    text = "%%MatrixMarket matrix coordinate real general\n4 4 5\n1 1 1.0\n2 2 2.0\n3 3 3\n"
    with pytest.raises(mmio.MMError, match="truncated"):
        mmio.read_coo(io.StringIO(text))
    with pytest.raises(jax_mmio.MMError, match="truncated"):
        jax_mmio.read_coo(io.StringIO(text))
    if not no_native:
        with pytest.raises(ValueError, match="truncated"):
            native.parse_body(text.split("\n", 2)[2].encode(), 5, 3)


def test_no_native_forces_the_numpy_parser(tmp_path, fresh_native, monkeypatch):
    monkeypatch.setenv("SPMV_TPU_NO_NATIVE", "1")
    assert not native.available()
    assert native.parse_body(b"1 1 1\n", 1, 3) is None
    p = body_file(tmp_path, "real")
    _, r, _, _ = mmio.read_coo(str(p))
    assert r.size


def test_the_library_builds_under_the_ports_build_dir(needs_native):
    path = native.library_path()
    assert path.parent == REPO / "spmv_tpu_torch" / "_build" and path.exists()
    assert native.SOURCE == REPO / "spmv_tpu_torch" / "io" / "csrc" / "mm_parse.cpp"
    assert native.available()
    lib = native._lib
    assert lib.mm_native_abi_version() == 1
    assert "native" not in path.parts[len(REPO.parts):]


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Four processes build into one empty directory at once (as test
    workers may): each loads a whole library and parses with it, and no
    temporary file is left behind."""
    code = ("import sys; from pathlib import Path\n"
            "import spmv_tpu_torch.io.native as n\n"
            "n.BUILD_DIR = Path(sys.argv[1])\n"
            "ok = n.ensure_built() and n.available()\n"
            "print(ok and n.parse_body(b'2 3 4.5\\n', 1, 3)[2][0])\n")
    if not native.ensure_built():
        pytest.skip("no C++ compiler: the native parser cannot be built")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _ in outs] == ["4.5"] * 4
    assert [f.name for f in tmp_path.iterdir()] == [native.library_path().name]


def test_a_failed_build_raises_only_when_asked(tmp_path, monkeypatch, fresh_native):
    """Without a compiler ``ensure_built`` returns False (read_coo keeps the
    numpy parser); ``check=True`` raises ``BuildError``."""
    from spmv_tpu_torch.kernels._build import BuildError

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.ensure_built() is False
    with pytest.raises(BuildError):
        native.ensure_built(check=True)
    assert not native.available()
    _, r, _, _ = mmio.read_coo(io.StringIO(
        "%%MatrixMarket matrix coordinate real general\n2 2 1\n2 1 5\n"))
    assert r.tolist() == [1]
    assert not any(tmp_path.iterdir())

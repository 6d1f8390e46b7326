"""``python -m spmv_tpu_torch``: the run / info / devices commands on the
CPU route, and no hidden CPU fallback on the default CUDA route."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_tpu_torch import cli
from spmv_tpu_torch.errors import ReturnCode

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = str(REPO / "databases" / "example.mtx")


def run_module(*args):
    return subprocess.run([sys.executable, "-m", "spmv_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=300)


def test_run_on_the_cpu_route_prints_ok():
    proc = run_module("run", "--format", "csr", "--matrix", EXAMPLE,
                      "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "result is ok" in proc.stdout
    assert "CPU:" in proc.stdout and "(ok)" in proc.stdout


def test_default_device_without_a_card_stops():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    proc = run_module("run", "--format", "csr", "--matrix", EXAMPLE)
    assert proc.returncode == ReturnCode.DEVICE_ERROR
    assert "no CUDA device" in proc.stderr
    assert "result is" not in proc.stdout


@pytest.mark.parametrize("fmt", ["coo", "cmrs", "ell", "sell", "hyb"])
@pytest.mark.parametrize("x", ["index", "random"])
def test_run_formats_in_process(capsys, fmt, x):
    rc = cli.main(["run", "--format", fmt, "--matrix", EXAMPLE, "--x", x,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS, out
    assert f"{fmt}: 64 x 64, nnz 565" in out and "result is ok" in out


def test_run_synthesizes_a_missing_matrix(capsys, tmp_path):
    rc = cli.main(["run", "--matrix", str(tmp_path / "cant.mtx"),
                   "--synth-n", "900", "--device", "cpu"])
    assert rc == ReturnCode.SUCCESS
    assert "csr: 900 x 900" in capsys.readouterr().out


def test_run_reports_a_bad_file_and_a_bad_device(capsys, tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1 1\n")
    assert cli.main(["run", "--matrix", str(bad), "--device", "cpu"]) == \
        ReturnCode.FILE_ERROR
    assert cli.main(["run", "--matrix", EXAMPLE, "--device", "meta"]) == \
        ReturnCode.DEVICE_ERROR
    assert "unsupported device" in capsys.readouterr().err


def test_info(capsys):
    assert cli.main(["info", "--matrix", EXAMPLE]) == ReturnCode.SUCCESS
    out = capsys.readouterr().out
    assert "64 x 64, nnz 565 (real general)" in out
    assert "shortest 0, longest 17" in out


def test_devices(capsys):
    rc = cli.main(["devices"])
    if torch.cuda.is_available():
        assert rc == ReturnCode.SUCCESS
    else:
        assert rc == ReturnCode.DEVICE_ERROR
        assert "no CUDA device" in capsys.readouterr().err


def test_a_conversion_error_returns_jaxs_code(capsys, tmp_path):
    """``run --format bsr`` on a matrix past the BSR fill guard (a 40,000-row
    diagonal: 313 tiles of 64 KB, 20.5 MB at 128x fill) fails while
    converting, before any kernel; the port returns PROGRAM_ERROR as the
    JAX package does (``spmv_tpu/cli.py:203-205``), with its message."""
    import spmv_tpu.cli

    n = 40_000
    path = tmp_path / "diag.mtx"
    i = np.arange(1, n + 1)
    path.write_text("%%MatrixMarket matrix coordinate real general\n"
                    f"{n} {n} {n}\n"
                    + "\n".join(f"{k} {k} 1.5" for k in i) + "\n")
    rc = cli.main(["run", "--format", "bsr", "--matrix", str(path),
                   "--device", "cpu"])
    assert "error:" in capsys.readouterr().err
    rc_jax = spmv_tpu.cli.main(["run", "--format", "bsr", "--matrix", str(path)])
    assert rc == rc_jax == ReturnCode.PROGRAM_ERROR == 2


def _row_length_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("row length:")]


@pytest.mark.parametrize("extra", [[], ["--rhs", "3"], ["--dtype", "f32x2"]],
                         ids=["rhs1", "rhs3", "f32x2"])
def test_run_ell_prints_jaxs_row_length_line(capsys, extra):
    """``run --format ell`` prints JAX's ``row length: …`` line before the
    verdict (``spmv_tpu/cli.py:207-210``) for any ``--rhs``, and not under
    ``--dtype f32x2``: the same lines from both CLIs on the same file."""
    import spmv_tpu.cli

    args = ["run", "--format", "ell", "--matrix", EXAMPLE, *extra]
    assert cli.main([*args, "--device", "cpu"]) == ReturnCode.SUCCESS
    port = capsys.readouterr().out
    assert spmv_tpu.cli.main(args) == ReturnCode.SUCCESS
    jax_out = capsys.readouterr().out
    assert _row_length_lines(port) == _row_length_lines(jax_out)
    assert len(_row_length_lines(port)) == (0 if "f32x2" in extra else 1)
    if not extra:
        assert _row_length_lines(port) == ["row length: average 8.83, "
                                           "shortest 0, longest 17"]
        assert port.index("row length:") < port.index("result is ok")


def test_any_exception_while_multiplying_returns_program_error(capsys,
                                                               monkeypatch):
    """A torch ``RuntimeError`` (a CUDA error, out of memory) during the
    SpMV returns PROGRAM_ERROR, as JAX's ``except Exception`` does
    (``spmv_tpu/cli.py:203-205``), not a traceback with exit status 1."""
    import spmv_tpu.cli
    import spmv_tpu.formats.csr
    import spmv_tpu_torch.formats.csr

    def boom(self, x):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(spmv_tpu_torch.formats.csr.CSRMatrix, "matvec", boom)
    monkeypatch.setattr(spmv_tpu.formats.csr.CSRMatrix, "matvec", boom)
    args = ["run", "--format", "csr", "--matrix", EXAMPLE]
    rc = cli.main([*args, "--device", "cpu"])
    assert "RuntimeError: CUDA error: out of memory" in capsys.readouterr().err
    assert rc == spmv_tpu.cli.main(args) == ReturnCode.PROGRAM_ERROR == 2


def test_any_exception_while_loading_returns_file_error(capsys, monkeypatch):
    """Any exception while reading the matrix returns FILE_ERROR, as
    ``spmv_tpu/cli.py:185-187`` does; the port caught only ``OSError`` and
    ``ValueError``."""
    import spmv_tpu.cli

    def boom(args):
        raise RuntimeError("unreadable")

    monkeypatch.setattr(cli, "_load", boom)
    monkeypatch.setattr(spmv_tpu.cli, "_load", boom)
    args = ["run", "--format", "csr", "--matrix", EXAMPLE]
    rc = cli.main([*args, "--device", "cpu"])
    assert "unreadable" in capsys.readouterr().err
    assert rc == spmv_tpu.cli.main(args) == ReturnCode.FILE_ERROR

"""``python -m spmv_tpu_torch``: the run / info / devices commands on the
CPU route, and no hidden CPU fallback on the default CUDA route."""

import subprocess
import sys
from pathlib import Path

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


@pytest.mark.parametrize("fmt", ["coo", "cmrs"])
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

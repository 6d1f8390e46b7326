"""``python -m spmv_tpu_torch``: the run / solve / info / devices commands
on the CPU route, ``--cache-dir``, and no hidden CPU fallback on the
default CUDA route."""

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


# ---------------------------------------------------------------- solve


def spd_file(tmp_path, m=8):
    """The 5-point Laplacian on an m×m grid plus 0.05·I, as a general .mtx."""
    n = m * m
    A = np.zeros((n, n))
    for i in range(m):
        for j in range(m):
            k = i * m + j
            A[k, k] = 4.05
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                if 0 <= i + di < m and 0 <= j + dj < m:
                    A[k, (i + di) * m + j + dj] = -1
    r, c = np.nonzero(A)
    path = tmp_path / "spd.mtx"
    path.write_text(f"%%MatrixMarket matrix coordinate real general\n{n} {n} {r.size}\n"
                    + "".join(f"{i + 1} {j + 1} {float(A[i, j])!r}\n" for i, j in zip(r, c)))
    return str(path)


def _iterations(out: str) -> int:
    return int(out.split(" iterations")[0].split()[-1])


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_solve_matches_jax_on_the_cpu_route(capsys, tmp_path, solver):
    import spmv_tpu.cli

    args = ["solve", "--format", "csr", "--solver", solver, "--matrix",
            spd_file(tmp_path), "--tol", "1e-6"]
    assert cli.main([*args, "--device", "cpu"]) == ReturnCode.SUCCESS
    port = capsys.readouterr().out
    assert spmv_tpu.cli.main(args) == ReturnCode.SUCCESS
    jax_out = capsys.readouterr().out
    assert port.startswith(f"{solver}: ") and "(converged)" in port
    assert abs(_iterations(port) - _iterations(jax_out)) <= 2
    rel = float(port.split("fp64 relative residual ")[1].split()[0])
    assert rel < 1e-5


def test_solve_power_matches_jax(capsys, tmp_path):
    import spmv_tpu.cli

    args = ["solve", "--solver", "power", "--maxiter", "200", "--matrix",
            spd_file(tmp_path)]
    assert cli.main([*args, "--device", "cpu"]) == ReturnCode.SUCCESS
    port = capsys.readouterr().out
    assert spmv_tpu.cli.main(args) == ReturnCode.SUCCESS
    jax_out = capsys.readouterr().out

    def lam(text):
        return float(text.split("~= ")[1].split()[0])

    assert abs(lam(port) - lam(jax_out)) / lam(jax_out) < 1e-3
    assert "(200 iterations" in port


@pytest.mark.parametrize("fmt", cli.SOLVE_FORMATS)
def test_solve_every_format_in_process(capsys, tmp_path, fmt):
    rc = cli.main(["solve", "--format", fmt, "--solver", "cg", "--matrix",
                   spd_file(tmp_path), "--device", "cpu"])
    assert rc == ReturnCode.SUCCESS
    assert "(converged)" in capsys.readouterr().out


def test_solve_exit_codes_match_jax(capsys, tmp_path, monkeypatch):
    """OTHER_ERROR (4) for a non-square matrix, VALIDATION_FAILED (5) when
    neither the count nor the fp64 residual says converged, PROGRAM_ERROR
    (2) for a conversion error, as ``spmv_tpu/cli.py:354-404`` returns."""
    import spmv_tpu
    import spmv_tpu.cli

    rect = tmp_path / "rect.mtx"
    rect.write_text("%%MatrixMarket matrix coordinate real general\n3 4 2\n1 1 1\n3 4 2\n")
    spd = spd_file(tmp_path)
    cases = [
        (["--matrix", str(rect)], ReturnCode.OTHER_ERROR),
        (["--matrix", spd, "--solver", "cg", "--tol", "1e-12", "--maxiter", "2"],
         ReturnCode.VALIDATION_FAILED),
    ]
    for extra, code in cases:
        rc = cli.main(["solve", *extra, "--device", "cpu"])
        assert rc == spmv_tpu.cli.main(["solve", *extra]) == code, extra
    assert "solve requires a square matrix, got 3x4" in capsys.readouterr().err

    def refuse(*args, **kwargs):
        raise ValueError("refused")

    monkeypatch.setattr("spmv_tpu_torch.from_coo", refuse)
    monkeypatch.setattr(spmv_tpu, "from_coo", refuse)
    rc = cli.main(["solve", "--matrix", spd, "--device", "cpu"])
    assert rc == spmv_tpu.cli.main(["solve", "--matrix", spd]) == ReturnCode.PROGRAM_ERROR
    assert "csr: ValueError: refused" in capsys.readouterr().err
    for main in (cli.main, spmv_tpu.cli.main):  # BSR is SpMM-shaped
        with pytest.raises(SystemExit) as e:
            main(["solve", "--format", "bsr"])
        assert e.value.code == 2
    capsys.readouterr()


def test_solve_without_a_card_stops(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    rc = cli.main(["solve", "--matrix", spd_file(tmp_path)])
    assert rc == ReturnCode.DEVICE_ERROR
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", [["run", "--format", "sell"], ["info"],
                                 ["solve", "--format", "hyb", "--solver", "cg"]])
def test_cache_dir_keeps_triplets_and_plans(capsys, tmp_path, monkeypatch, cmd):
    from spmv_tpu_torch import cache
    from spmv_tpu_torch.io import mmio

    d = tmp_path / "cache"
    device = [] if cmd[0] == "info" else ["--device", "cpu"]
    args = [*cmd, "--matrix", spd_file(tmp_path), "--cache-dir", str(d), *device]
    assert cli.main(args) == ReturnCode.SUCCESS
    first = capsys.readouterr().out
    files = sorted(p.name for p in d.iterdir())
    assert any("coo-triplets" in f for f in files)
    assert any(f.startswith("plan-") for f in files) == (cmd[0] != "info")
    assert cache._PLAN_CACHE_DIR is None  # main restores the setting

    def no_parse(*a, **k):
        raise AssertionError("parsed again")

    monkeypatch.setattr(mmio, "read_path_or_synthesize", no_parse)
    assert cli.main(args) == ReturnCode.SUCCESS
    second = capsys.readouterr().out
    assert sorted(p.name for p in d.iterdir()) == files

    def strip_times(text):
        return [ln.split(" ms")[0] if "CPU:" in ln else ln.split(",")[0]
                for ln in text.splitlines() if "CPU:" not in ln]

    assert strip_times(first) == strip_times(second)


def test_solve_on_an_indefinite_matrix_is_not_converged_as_in_jax(capsys, tmp_path):
    """cg on the indefinite cant proxy: the two packages' float32 paths part
    after a few iterations (here the port's may overflow to NaN, which
    stops its loop early, while JAX's stays finite and runs to maxiter);
    both CLIs return VALIDATION_FAILED."""
    import spmv_tpu.cli

    args = ["solve", "--format", "csr", "--solver", "cg", "--maxiter", "20",
            "--synth-n", "3000", "--matrix", str(tmp_path / "missing.mtx")]
    rc = cli.main([*args, "--device", "cpu"])
    assert "NOT converged" in capsys.readouterr().out
    assert rc == spmv_tpu.cli.main(args) == ReturnCode.VALIDATION_FAILED


def test_solve_calls_a_nan_residual_not_converged(capsys, tmp_path, monkeypatch):
    """A NaN stops the loop before maxiter, and JAX's rule alone ("iters <
    maxiter") would call that converged; the port asks for a finite
    residual too."""
    from spmv_tpu_torch import solve

    monkeypatch.setattr(solve, "cg", lambda a, b, **kw: (
        torch.full((a.nrows,), float("nan")), 3, float("nan")))
    rc = cli.main(["solve", "--solver", "cg", "--matrix", spd_file(tmp_path),
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "cg: 3 iterations" in out and "NOT converged" in out
    assert rc == ReturnCode.VALIDATION_FAILED

"""``python -m spmv_tpu_torch bench`` and ``run --bench/--json`` on the CPU
route (the host clock, no card named), JAX's options and exit codes, and
no hidden CPU fallback on the default CUDA route."""

import json
from pathlib import Path

import pytest
import torch

from spmv_tpu import cli as jax_cli
from spmv_tpu.bench import runner as jax_runner
from spmv_tpu.x2 import X2_FORMATS as JAX_X2_FORMATS

from spmv_tpu_torch import cli
from spmv_tpu_torch.errors import ReturnCode

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = str(REPO / "databases" / "example.mtx")
JAX_FIELDS = {f for f in jax_runner.BenchResult.__dataclass_fields__} - {"min_history_ms"}


def bench(tmp_path, *args):
    out = tmp_path / "bench.json"
    rc = cli.main(["bench", "--matrix", EXAMPLE, "--device", "cpu", "--json", str(out),
                   *args])
    return rc, json.loads(out.read_text()) if rc == 0 else None


def format_lines(text: str) -> list[str]:
    return [ln.split(":")[0].strip() for ln in text.splitlines()
            if ln.split(":")[0].strip() in (jax_cli.CLI_FORMATS
                                             + [f"{f}/x2" for f in jax_cli.CLI_FORMATS])]


def test_all_formats_print_one_line_each_and_match_the_json(capsys, tmp_path):
    rc, res = bench(tmp_path)
    out = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS
    assert cli.ALL_FORMATS == jax_cli.ALL_FORMATS
    assert format_lines(out) == jax_cli.ALL_FORMATS == list(res)
    head = out.splitlines()[0]
    assert head.startswith("bench: 64 x 64, nnz 565") and "[host clock, no card]" in head
    for name, d in res.items():
        assert JAX_FIELDS <= set(d) and d["format"] == name
        assert d["timing"] == "host" and d["card"] is None and d["roofline_pct"] is None
        assert d["ms_per_spmv"] > 0
    assert "roofline not measured" in out


def test_bsr_runs_spmm_at_r_128(capsys, tmp_path):
    rc, res = bench(tmp_path, "--formats", "bsr")
    assert rc == ReturnCode.SUCCESS
    assert list(res) == ["bsr"] and res["bsr"]["rhs"] == 128 and "fill" in res["bsr"]
    assert "(R=128, host)" in capsys.readouterr().out


def test_rhs_benches_spmm_for_every_format(capsys, tmp_path):
    rc, res = bench(tmp_path, "--formats", "csr,sell,bsr", "--rhs", "3")
    assert rc == ReturnCode.SUCCESS
    assert list(res) == ["csr", "sell", "bsr"]
    assert {d["rhs"] for d in res.values()} == {3}
    assert format_lines(capsys.readouterr().out) == ["csr", "sell", "bsr"]


def test_f32x2_keeps_the_x2_formats(capsys, tmp_path):
    rc, res = bench(tmp_path, "--formats", "csr,bsr,sell,hyb", "--dtype", "f32x2")
    assert rc == ReturnCode.SUCCESS
    kept = [f for f in ("csr", "bsr", "sell", "hyb") if f in JAX_X2_FORMATS]
    assert list(res) == [f"{f}/x2" for f in kept]
    assert format_lines(capsys.readouterr().out) == list(res)


def test_profile_writes_a_chrome_trace(capsys, tmp_path):
    rc, _ = bench(tmp_path, "--formats", "csr", "--profile", str(tmp_path / "prof"))
    assert rc == ReturnCode.SUCCESS
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in trace
    assert "writing profiler trace" in capsys.readouterr().err


@pytest.mark.parametrize("args, keys", [((), JAX_FIELDS), (("--rhs", "3"), None),
                                        (("--dtype", "f32x2"), JAX_FIELDS)])
def test_run_bench_writes_one_result(capsys, tmp_path, args, keys):
    out = tmp_path / "run.json"
    rc = cli.main(["run", "--format", "sell", "--matrix", EXAMPLE, "--device", "cpu",
                   "--bench", "--json", str(out), *args])
    text = capsys.readouterr().out
    assert rc == ReturnCode.SUCCESS and "result is ok" in text
    d = json.loads(out.read_text())
    if keys is None:  # spmm: JAX's bench_spmm keys
        assert d["rhs"] == 3 and "ms_per_spmm" in d and "ms/SpMM" in text
    else:
        assert keys <= set(d) and "ms/SpMV" in text
        assert d["format"] == ("sell/x2" if args else "sell")


def test_a_bad_matrix_is_a_file_error_as_in_jax(capsys, tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1 1\n")
    assert jax_cli.main(["bench", "--matrix", str(bad)]) == ReturnCode.FILE_ERROR
    assert cli.main(["bench", "--matrix", str(bad), "--device", "cpu"]) == \
        ReturnCode.FILE_ERROR
    assert "error reading" in capsys.readouterr().err


def test_no_card_no_bench(capsys):
    """The default device is cuda: without a card ``bench`` returns ``run``'s
    device error and does not carry on on the CPU; --probe-bw needs a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    assert cli.main(["bench", "--matrix", EXAMPLE]) == ReturnCode.DEVICE_ERROR
    assert cli.main(["run", "--matrix", EXAMPLE, "--bench"]) == ReturnCode.DEVICE_ERROR
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and "bench:" not in err.out


def test_probe_bw_on_the_cpu_is_refused(capsys):
    assert cli.main(["bench", "--matrix", EXAMPLE, "--device", "cpu", "--probe-bw"]) == \
        ReturnCode.DEVICE_ERROR
    assert "HBM ceiling of a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--scaling", "--rows-per-device=4"])
def test_scaling_waits_for_distribution(capsys, flag):
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", flag, "--device", "cpu"])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err

"""Empty shapes, the port against the JAX package: ``spmm`` with no
right-hand sides, and the panel formats on a matrix with no rows.

* X of shape (ncols, 0): JAX's BSR returns an (nrows, 0) Y, and so must
  the port's; the engine formats and the fp64-grade containers stack one
  ``matvec`` per column in JAX and raise its ``ValueError`` (``jnp.stack``'s
  and ``np.stack``'s messages), and the port raises the same class with
  the same message before it stacks.
* ``from_coo("ell" | "hyb" | "sell", 0, 5, [], [], [])``: JAX's ``matvec``
  returns an empty y, and so must the port's on the CPU (the plain K6,
  ``panel_spmv_fused_reference``, returns zeros of the plan's rows, as the
  kernel's wrapper does).
* ``run --rhs 0`` keeps its exit code: the CLI runs one column there, in
  both packages.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import spmv_tpu
from spmv_tpu.x2 import X2Matrix as JaxX2
import spmv_tpu_torch
from spmv_tpu_torch import X2Matrix, synth
from spmv_tpu_torch.kernels import panel as P


def case():
    return synth.random_coo(64, 48, 300, seed=11)


def jax_outcome(fn):
    """``("shape", shape)`` of what ``fn`` returns, or ``("raises", class,
    message)``."""
    try:
        return ("shape", tuple(np.asarray(fn()).shape))
    except Exception as e:  # the outcome is what the test compares
        return ("raises", type(e), str(e))


@pytest.mark.parametrize("fmt", ["bsr", "csr", "coo", "cmrs", "ell", "sell", "hyb"])
def test_spmm_with_no_columns_matches_jax(fmt):
    info, r, c, v = case()
    X = np.zeros((info.ncols, 0), np.float32)
    want = jax_outcome(lambda: spmv_tpu.spmm(
        spmv_tpu.from_coo(fmt, info.nrows, info.ncols, r, c, v), X))
    a = spmv_tpu_torch.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    if want[0] == "shape":
        Y = spmv_tpu_torch.spmm(a, X)
        assert ("shape", tuple(Y.shape)) == want == ("shape", (info.nrows, 0))
    else:
        with pytest.raises(want[1]) as got:
            spmv_tpu_torch.spmm(a, X)
        assert str(got.value) == want[2]
    if fmt == "bsr":
        assert want[0] == "shape"
    else:
        assert want[1] is ValueError


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_x2_spmm_with_no_columns_matches_jax(fmt):
    info, r, c, v = case()
    X = np.zeros((info.ncols, 0))
    want = jax_outcome(lambda: spmv_tpu.spmm(
        JaxX2.from_coo(fmt, info.nrows, info.ncols, r, c, v), X))
    assert want[:2] == ("raises", ValueError)
    a = X2Matrix.from_coo(fmt, info.nrows, info.ncols, r, c, v, device="cpu")
    with pytest.raises(ValueError) as got:
        spmv_tpu_torch.spmm(a, X)
    assert str(got.value) == want[2]


@pytest.mark.parametrize("fmt", ["ell", "hyb", "sell"])
def test_matvec_on_no_rows_matches_jax(fmt):
    x = np.arange(5, dtype=np.float32)
    y_jax = np.asarray(spmv_tpu.from_coo(fmt, 0, 5, [], [], []).matvec(x))
    a = spmv_tpu_torch.from_coo(fmt, 0, 5, [], [], [], device="cpu")
    y = a.matvec(x)
    assert y.shape == y_jax.shape == (0,)
    assert tuple(spmv_tpu_torch.spmm(a, np.ones((5, 3))).shape) == (0, 3)


@pytest.mark.parametrize("fmt", ["ell", "hyb"])
def test_plain_k6_on_no_rows_gives_the_wrappers_zeros(fmt):
    a = spmv_tpu_torch.from_coo(fmt, 0, 5, [], [], [], device="cpu")
    y = P.panel_spmv_fused_reference(a.dev, torch.zeros(5))
    assert y.shape == (a.dev.nrows,) == (0,) and y.dtype == torch.float32


def test_run_with_no_right_hand_sides_keeps_its_exit_code(capsys):
    from spmv_tpu import cli as jax_cli
    from spmv_tpu_torch import cli

    example = Path(__file__).resolve().parents[1] / "databases" / "example.mtx"
    args = ["run", "--format", "csr", "--matrix", str(example), "--rhs", "0"]
    want = jax_cli.main(args)
    capsys.readouterr()
    assert cli.main([*args, "--device", "cpu"]) == want == 0
    assert "result is ok" in capsys.readouterr().out

"""The fp64-grade mode's engines: wrappers of K12-K15, each with its plain
PyTorch version beside it, and the σ gather of an fp64 y.

Counterpart of ``spmv_tpu/kernels/engines_x2.py``.

===========================  ========================  =========================================
wrapper                      kernel (csrc/)            replaces (spmv_tpu/kernels/)
===========================  ========================  =========================================
segmented_spmv_x2_partials   K12 seg_spmv_tiles_x2     engines_x2.py:267 ``_seg_kernel_x2``
carry_fixup_x2               K13 carry_fixup_x2        engines_x2.py:267, its fixed-up sum
panel_spmv_x2_partials       K14 panel_spmv_tiles_x2   engines_x2.py:205 ``_panel_kernel_x2``
panel_fixup_x2               K15 panel_fixup_x2        engines_x2.py:205, its fixed-up sum
inverse_permute_x2           K7 inverse_permute        engines.py:719 ``_perm_kernel`` (fp64 y)
===========================  ========================  =========================================

The JAX engines carry each value as f32 hi and lo planes, x as a (2S, 128)
hi∥lo table, and y as ``(y_hi, y_lo)``, with Dekker splits, TwoSum chains
and 8-bit integer planes on the MXU (``engines_x2.py:48-134``): the TPU's
VPU has no FMA and its MXU takes bf16. Hopper has native fp64 FMA, so the
port computes in fp64 throughout: fp64 values (at least as precise as
hi + lo), fp64 x, every product and sum in fp64, fp64 y. A k-term row then
errs by about k·2⁻⁵³·Σ|v||x|, far inside JAX's window·2⁻³⁸. Each TPU
kernel folds its fixed-up sum into one dispatch; the port keeps its own
two-dispatch shape (tile kernel, then fix-up) on the f32 kernels' tile
schedules, and K12-K15 are K1, K2, K4 and K5 built for double.

Routing, as in ``kernels.engines``: CPU tensors run the plain version,
CUDA tensors launch the kernel or raise, and each launch adds one to
``engines.LAUNCHES[kernel]``. Every wrapper refuses a plan, x, y or carry
that is not float64, before any launch.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.device import DevCsr, DevPanel
from spmv_tpu_torch.kernels.engines import (_seg_fixup, _seg_tiles,
                                            carry_fixup_reference,
                                            segmented_spmv_partials_reference)
from spmv_tpu_torch.kernels.panel import (_panel_fixup, _panel_tiles,
                                          inverse_permute,
                                          inverse_permute_reference,
                                          panel_fixup_reference,
                                          panel_spmv_partials_reference)

__all__ = ["segmented_spmv_x2", "segmented_spmv_x2_partials", "carry_fixup_x2",
           "panel_spmv_x2", "panel_spmv_x2_partials", "panel_fixup_x2",
           "panel_and_spill_spmv_x2", "inverse_permute_x2",
           "segmented_spmv_x2_partials_reference", "carry_fixup_x2_reference",
           "panel_spmv_x2_partials_reference", "panel_fixup_x2_reference",
           "inverse_permute_x2_reference"]

_F64 = torch.float64

# Plain K12-K15: plain K1, K2, K4 and K5, which sum in the plan's dtype.
segmented_spmv_x2_partials_reference = segmented_spmv_partials_reference
carry_fixup_x2_reference = carry_fixup_reference
panel_spmv_x2_partials_reference = panel_spmv_partials_reference
panel_fixup_x2_reference = panel_fixup_reference


def segmented_spmv_x2_partials(dev: DevCsr, x: torch.Tensor):
    """K12: ``(y, carry)`` in float64 on K1's tile schedule: y holds every
    row wholly inside one tile, ``carry`` the split rows' head and tail
    partials, for ``carry_fixup_x2``."""
    return _seg_tiles("seg_spmv_tiles_x2", _F64, dev, x)


def carry_fixup_x2(dev: DevCsr, y: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """K13: adds each split row's fp64 partials, in tile order, into ``y``
    in place, and returns it."""
    return _seg_fixup("carry_fixup_x2", _F64, dev, y, carry)


def segmented_spmv_x2(dev: DevCsr, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in float64 over a float64 CSR plan: K12, then K13."""
    y, carry = segmented_spmv_x2_partials(dev, x)
    return carry_fixup_x2(dev, y, carry)


def panel_spmv_x2_partials(dev: DevPanel, x: torch.Tensor):
    """K14: ``(y, part)`` in float64 on K4's tile schedule: y holds the
    rows of every slice wholly inside one tile, ``part`` (2·ntiles, 32)
    the split slices' head and tail partials, for ``panel_fixup_x2``."""
    return _panel_tiles("panel_spmv_tiles_x2", _F64, dev, x)


def panel_fixup_x2(dev: DevPanel, y: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """K15: adds each split slice's fp64 partials, in tile order, into
    ``y`` in place, and returns it."""
    return _panel_fixup("panel_fixup_x2", _F64, dev, y, part)


def panel_spmv_x2(dev: DevPanel, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in float64 over a float64 panel: K14, then K15."""
    y, part = panel_spmv_x2_partials(dev, x)
    return panel_fixup_x2(dev, y, part)


def panel_and_spill_spmv_x2(dev: DevPanel, dev_spill: DevCsr | None,
                            x: torch.Tensor) -> torch.Tensor:
    """y = panel part + spill part in float64 (HYB's and the split ELL's
    and SELL's two plans over the same rows). An empty part launches
    nothing. The two add with an fp64 torch add on the device; JAX adds
    them in fp64 on the host (``spmv_tpu/x2.py:154-164``): both round once
    at 2⁻⁵³."""
    if dev_spill is None:
        return panel_spmv_x2(dev, x)
    if dev.nslots == 0:  # pure spill: no dispatch for an empty panel
        return segmented_spmv_x2(dev_spill, x)
    y = panel_spmv_x2(dev, x)
    return y.add_(segmented_spmv_x2(dev_spill, x))


def _as_pairs(y: torch.Tensor) -> torch.Tensor:
    """An fp64 vector viewed as rows of 2 float32 (the same bytes)."""
    if y.dtype != _F64 or y.dim() != 1 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous float64 vector, got {y.dtype} "
                         f"{tuple(y.shape)}")
    return y.view(torch.float32).view(-1, 2)


def inverse_permute_x2(invperm: torch.Tensor, y_sorted: torch.Tensor,
                       nrows: int) -> torch.Tensor:
    """K7 on an fp64 y: ``y[i] = y_sorted[invperm[i]]`` for ``i < nrows``.
    One launch over rows of 2 floats, each the bytes of one double, so the
    gather is an exact bit copy; JAX applies its ``inverse_permute_blocks``
    to each half (``spmv_tpu/x2.py:165-177``)."""
    return inverse_permute(invperm, _as_pairs(y_sorted), nrows).view(_F64).view(-1)


def inverse_permute_x2_reference(invperm: torch.Tensor, y_sorted: torch.Tensor,
                                 nrows: int) -> torch.Tensor:
    """Plain fp64 K7: the same index gather over the same rows of 2
    floats."""
    return inverse_permute_reference(invperm, _as_pairs(y_sorted),
                                      nrows).view(_F64).view(-1)

"""The fp64-grade mode's engines: wrappers of K12-K14, each with its plain
PyTorch version beside it, and K7 on an fp64 y, every fp64 panel's
epilogue.

Counterpart of ``spmv_tpu/kernels/engines_x2.py``.

===========================  ========================  =========================================
wrapper                      kernel (csrc/)            replaces (spmv_tpu/kernels/)
===========================  ========================  =========================================
segmented_spmv_x2_partials   K12 seg_spmv_tiles_x2     engines_x2.py:267 ``_seg_kernel_x2``
carry_fixup_x2               K13 carry_fixup_x2        engines_x2.py:267, its fixed-up sum
panel_spmv_x2_partials       K14 panel_spmv_tiles_x2   engines_x2.py:205 ``_panel_kernel_x2``
panel_fixup_x2               K7 inverse_permute_x2     engines_x2.py:205, its fixed-up sum
                             (identity, no spill)
inverse_permute_x2           K7 inverse_permute_x2     engines.py:719 ``_perm_kernel`` (fp64 y)
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
schedules: K12-K14 are K1, K2 and K4 built for double, and a panel's
fix-up is K7 built for double.

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
from spmv_tpu_torch.kernels.panel import (_epilogue, _panel_fixup, _panel_tiles,
                                          inverse_permute_reference,
                                          panel_fixup_reference,
                                          panel_spmv_partials_reference)

__all__ = ["segmented_spmv_x2", "segmented_spmv_x2_partials", "carry_fixup_x2",
           "panel_spmv_x2", "panel_spmv_x2_partials", "panel_fixup_x2",
           "panel_and_spill_spmv_x2", "inverse_permute_x2",
           "sorted_panel_and_spill_spmv_x2",
           "segmented_spmv_x2_partials_reference", "carry_fixup_x2_reference",
           "panel_spmv_x2_partials_reference", "panel_fixup_x2_reference",
           "inverse_permute_x2_reference"]

_F64 = torch.float64

# Plain K12-K14, the fp64 fix-up and the fp64 K7: plain K1, K2, K4,
# ``panel_fixup`` and K7, which work in their inputs' dtype.
segmented_spmv_x2_partials_reference = segmented_spmv_partials_reference
carry_fixup_x2_reference = carry_fixup_reference
panel_spmv_x2_partials_reference = panel_spmv_partials_reference
panel_fixup_x2_reference = panel_fixup_reference
inverse_permute_x2_reference = inverse_permute_reference


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
    """Each split slice's rows of ``y`` from its fp64 partials, summed in
    tile order: K7's identity mode without a spill, in float64 (a launch
    counted under ``inverse_permute``). Updates ``y`` in place and returns
    it."""
    return _panel_fixup("inverse_permute_x2", _F64, dev, y, part)


def panel_spmv_x2(dev: DevPanel, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in float64 over a float64 panel: K14, then K7's identity
    mode on the split slices."""
    y, part = panel_spmv_x2_partials(dev, x)
    return panel_fixup_x2(dev, y, part)


def panel_and_spill_spmv_x2(dev: DevPanel, dev_spill: DevCsr | None,
                            x: torch.Tensor) -> torch.Tensor:
    """y = panel part + spill part in float64 (HYB's and the split ELL's
    and SELL's two plans over the same rows): K14, the spill's K12 + K13,
    then K7's identity mode in float64, which sums the split slices and
    adds the spill's y in place. An empty part launches nothing. K7 adds
    in fp64 on the device; JAX adds the two in fp64 on the host
    (``spmv_tpu/x2.py:154-164``): both round once at 2⁻⁵³."""
    if dev_spill is None:
        return panel_spmv_x2(dev, x)
    if dev.nslots == 0:  # pure spill: no dispatch for an empty panel
        return segmented_spmv_x2(dev_spill, x)
    y, part = panel_spmv_x2_partials(dev, x)
    spill = segmented_spmv_x2(dev_spill, x)
    return inverse_permute_x2(None, y, dev.nrows, dev=dev, part=part, spill=spill)


def inverse_permute_x2(invperm: torch.Tensor | None, y_sorted: torch.Tensor, nrows: int, *,
                       dev: DevPanel | None = None, part: torch.Tensor | None = None,
                       spill: torch.Tensor | None = None) -> torch.Tensor:
    """K7 in float64, the fp64-grade panel's epilogue: ``kernels.panel.
    inverse_permute`` on fp64 y′, K14's partials and an fp64 spill, the
    sums in fp64, counted under ``inverse_permute`` (``invperm`` None: the
    identity, in place on y′). Without partials or a spill it is the
    gather alone, an exact bit copy; JAX applies its
    ``inverse_permute_blocks`` to each half (``spmv_tpu/x2.py:165-177``)."""
    return _epilogue("inverse_permute_x2", _F64, invperm, y_sorted, nrows, dev, part,
                     spill)


def sorted_panel_and_spill_spmv_x2(dev: DevPanel, dev_spill: DevCsr | None,
                                   invperm: torch.Tensor, x: torch.Tensor,
                                   nrows: int) -> torch.Tensor:
    """y = A·x in float64 for a σ-sorted SELL, in row order and cut to
    ``nrows``: K14, the spill's K12 + K13 where there is a spill, then K7 in
    float64: the chain of ``panel_and_spill_spmv_x2`` with the row order
    given to K7."""
    y, part = panel_spmv_x2_partials(dev, x)
    spill = segmented_spmv_x2(dev_spill, x) if dev_spill is not None else None
    return inverse_permute_x2(invperm, y, nrows, dev=dev, part=part, spill=spill)

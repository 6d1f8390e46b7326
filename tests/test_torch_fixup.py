"""The carry slots of the segmented engine, on the host: which the tile
kernel writes and which the fix-ups read.

On the card the tile kernels K1, K12 and K8 (``spmv_tpu_torch/kernels/
csrc/seg_tile.cuh``) write only the carry slots that a split row uses, and
their wrappers allocate the carries without a fill
(``engines.tile_outputs``), so a slot no row uses holds whatever the memory
held. That is right only if the fix-ups K2, K13 and K9 read no other slot.
The tests here hold the three descriptions of those slots to one another:

* a host mirror of the kernel's emit rule (``emit_row``: the head slot
  ``2t`` for the row that began before tile t, else the tail slot
  ``2t+1`` for the row that runs on past it);
* ``engines.carry_slot_rows``, the slots the fix-ups read, by which the
  checks on the card compare carries;
* the plain K1/K8, whose nonzero slots on all-ones inputs are the slots
  it writes, and the plain K2/K9, whose y must not change when the unused
  slots hold NaN.

``test_torch_gpu.py`` and ``chip_smoke.py`` make the same check on the
card, with the launchers writing into NaN-filled carries.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spmv_tpu_torch import synth
from spmv_tpu_torch.device import DevCsr
from spmv_tpu_torch.formats.base import TILE_NNZ, build_csr_plan, cdiv, csr_ptr
from spmv_tpu_torch.io.mmio import MMInfo
from spmv_tpu_torch.kernels import engines as E
from spmv_tpu_torch.probes import turns
from spmv_tpu_torch.probes.common import TILE_SHAPES

CSRC = Path(__file__).resolve().parents[1] / "spmv_tpu_torch" / "kernels" / "csrc"


def no_split_rows():
    """64 rows of exactly 16 nonzeros: at tiles of 16 and of 1024 no row
    crosses a tile boundary."""
    rows = np.repeat(np.arange(64), 16)
    cols = np.tile(np.arange(16), 64)
    vals = np.random.default_rng(2).standard_normal(rows.size)
    return MMInfo("matrix", "coordinate", "real", "general", 64, 16, rows.size), rows, cols, vals


# the matrices ``probes.turns`` runs (cant, pl_big, pl_wide, band-1024) at a
# small size, the extremes of the tile kernel's stage (a hub row over six
# tiles of 1024, over hundreds of 16), and a plan with no split row
MATRICES = {
    "cant": lambda: synth.synthetic_cant(n=2048, avg_nnz_per_row=64, bandwidth=350, seed=0),
    "pl_big": lambda: synth.power_law(n=4096, avg_nnz_per_row=24, bandwidth=512, seed=0),
    "pl_wide": lambda: synth.power_law(n=4096, avg_nnz_per_row=24, seed=0),
    "band": lambda: synth.synthetic_cant(n=1024, avg_nnz_per_row=16, bandwidth=60, seed=5),
    **TILE_SHAPES,
    "no_split_rows": no_split_rows,
}
TILES = (TILE_NNZ, 16)


def plan(name, tile):
    info, r, c, v = MATRICES[name]()
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], np.asarray(v, np.float32)[order]
    return DevCsr.from_plan(build_csr_plan(info.nrows, info.ncols, csr_ptr(r, info.nrows),
                                           c, v, tile=tile), "cpu")


def kernel_writes(ptr: np.ndarray, tile: int, nnz: int) -> np.ndarray:
    """Host mirror of the tile kernel's emit: the row whose partial each
    carry slot receives, -1 where the kernel writes nothing. Only a
    tile's first and last rows can cross its bounds [ts, te); emit_row
    sends a row that began before ts to the head slot 2t, else one that
    runs on past te to the tail slot 2t+1."""
    owner = np.full(2 * cdiv(nnz, tile), -1, np.int64)
    for t in range(cdiv(nnz, tile)):
        ts, te = t * tile, min((t + 1) * tile, nnz)
        first, last = np.searchsorted(ptr, [ts, te - 1], side="right") - 1
        for r in {int(first), int(last)}:
            if ptr[r] < ts:
                owner[2 * t] = r
            elif ptr[r + 1] > te:
                owner[2 * t + 1] = r
    return owner


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_the_tile_kernel_writes_exactly_the_slots_the_fixups_read(name, tile):
    dev = plan(name, tile)
    ptr = dev.ptr.numpy().astype(np.int64)
    owner = E.carry_slot_rows(dev).numpy()
    assert np.array_equal(owner, kernel_writes(ptr, tile, dev.nnz))
    if name == "no_split_rows":
        assert dev.ncarry == 0 and (owner == -1).all()
    else:
        assert dev.ncarry and (owner >= 0).any()
    # the plain K1 and K8 on all-ones inputs: each written slot holds the
    # count of its row's nonzeros in its tile, every other slot 0
    ones = DevCsr(dev.ptr, dev.cols, torch.ones_like(dev.vals), dev.tile_row0,
                  dev.carry_rows, dev.nrows, dev.ncols, dev.tile, dev.max_row_nnz)
    carry = E.segmented_spmv_partials_reference(ones, torch.ones(dev.ncols))[1].numpy()
    slot = np.arange(owner.size)
    t = slot // 2
    r = np.maximum(owner, 0)
    count = (np.minimum(ptr[r + 1], np.minimum((t + 1) * tile, dev.nnz))
             - np.maximum(ptr[r], t * tile))
    assert np.array_equal(carry, np.where(owner >= 0, count, 0).astype(np.float32))
    carry8 = E.segmented_spmv_multi_partials_reference(ones, torch.ones(dev.ncols, 3))[1]
    assert np.array_equal(carry8.numpy(), np.repeat(carry[:, None], 3, axis=1))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_the_fixups_give_the_same_y_with_nan_in_unused_slots(name, tile):
    """The plain K2 (and K9 at R = 3) gives y bit for bit whether the slots
    no split row uses hold 0, as the plain K1 leaves them, or NaN."""
    dev = plan(name, tile)
    unused = E.carry_slot_rows(dev) < 0
    rng = np.random.default_rng(4)
    for x in (torch.from_numpy(rng.standard_normal(dev.ncols).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((dev.ncols, 3)).astype(np.float32))):
        y, carry = E.segmented_spmv_partials_reference(dev, x)
        assert not carry[unused].any()
        poisoned = carry.clone()
        poisoned[unused] = float("nan")
        want = E.carry_fixup_reference(dev, y.clone(), carry)
        got = E.carry_fixup_reference(dev, y.clone(), poisoned)
        assert torch.equal(got, want) and not got.isnan().any()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_turns_masks_the_slots_carry_slot_rows_leaves_out(name):
    """``probes.turns`` keeps its own host copy of the used slots (its
    worker may import an older checkout): it agrees with the engine's."""
    for tile in TILES:
        dev = plan(name, tile)
        assert np.array_equal(turns._unused_slots(dev), (E.carry_slot_rows(dev) < 0).numpy())


def body_of(src: str, signature: str) -> str:
    body = src[src.index(signature):]
    return body[:body.index("\n}\n")]


def test_the_fixup_waits_for_the_tile_kernel_before_it_reads_carry():
    """K2/K13/K9 (``carry_fixup_kernel``) read the row and its offsets, then
    ``griddepcontrol.wait``, then the carries, never through the read-only
    path; the launcher goes through ``launch_programmatic``, which sets the
    programmatic-serialization attribute; K9 is the kernel's R-wide
    instantiation, and its own kernel is gone."""
    src = (CSRC / "seg_tile.cuh").read_text()
    body = body_of(src, "carry_fixup_kernel(const int*")
    wait = body.index('asm volatile("griddepcontrol.wait;" ::: "memory")')
    for read in ("__ldg(carry_rows + j)", "__ldg(ptr + r)", "__ldg(ptr + r + 1)"):
        assert body.index(read) < wait, read
    assert body.index("carry[(2 * ta + 1) * R + col]") > wait and "__ldg(carry +" not in body
    assert re.search(r"const T\* carry,", body)  # no __restrict__: no read-only loads
    launcher = body_of(src, "int launch_carry_fixup(")
    assert "launch_programmatic(" in launcher and "<<<" not in launcher
    helper = body_of(src, "int launch_programmatic(")
    assert "cudaLaunchKernelEx(" in helper and "<<<" not in helper
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in helper
    assert "programmaticStreamSerializationAllowed = 1" in helper
    # every fix-up of this template goes through that launcher: K2, K13, K9
    # at R = 2..8 (a macro case each), the probe's
    seg = (CSRC / "seg_spmv.cu").read_text()
    callers = re.findall(r"launch_carry_fixup<(\w+), (\w+)(?:, (\w+))?>",
                         seg + (CSRC / "probe_spmv.cu").read_text())
    assert sorted(callers) == sorted([("float", "kTileNnz", ""), ("double", "kTileNnz", ""),
                                      ("float", "kTileNnz", "R"), ("float", "128", ""),
                                      ("float", "512", ""), ("float", "2048", "")])
    k9 = body_of(seg, "int carry_fixup_multi(")
    assert "K9_CASE(2) K9_CASE(3) K9_CASE(4) K9_CASE(5) K9_CASE(6) K9_CASE(7) K9_CASE(8)" in k9
    assert "carry_fixup_multi_kernel" not in seg and "<<<" not in k9

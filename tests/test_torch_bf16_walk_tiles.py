"""The bf16 flow chains' plan after the WN walk's transposed conv took its
epilogue in column pairs and the folded A moved onto wgmma, on the CPU
(``tc_gemm.bf16_block_products``, the plain version of csrc/bf16_gemm.cu's
dispatch).

* At the shipped shapes ([32, 704] and [16, 704]) and widths (h 192 and
  256): the transposed convs alone lay their epilogue's columns out in
  pairs (64 apart: each f32 load or store of gx by a warp spans 64
  neighbouring columns); every product on the TMA-fed kernel, within a
  block's 232,448 bytes; the device operations a call unchanged (rows 8 /
  12 / 7 / 11: 26 / 36 / 35 / 46; rows 9 / 10: 13 / 14; 5 / 6: 9).
* A thread's columns in pairs keep each column's rows in the order the
  neighbouring layout sums them: the tile sums (phases of rows, then the
  phases in order) are the same bits whichever thread holds a column.
* The folded A (zp) of a bf16 chain on the TMA-fed wgmma kernel, the f32
  chains' on the CUDA cores.
"""

import pytest
import torch

from glow_tts_train_tpu_torch.ops import tc_gemm

SMS = 132  # the H100's streaming multiprocessors
MAX_BLOCK_SMEM = 232448


def _plans(batch, h):
    base = (batch, 704, 160, h, 4, 5, 2, SMS)
    wn = (batch, 704, 0, h, 4, 5, 2, SMS)
    return {
        10: tc_gemm.bf16_block_products(*base),
        9: tc_gemm.bf16_block_products(*base, saves=False),
        12: tc_gemm.bf16_block_products(*base, backward=True),
        11: tc_gemm.bf16_block_products(*base, backward=True, recompute=True),
        6: tc_gemm.bf16_block_products(*wn),
        5: tc_gemm.bf16_block_products(*wn, saves=False),
        8: tc_gemm.bf16_block_products(*wn, backward=True),
        7: tc_gemm.bf16_block_products(*wn, backward=True, recompute=True),
    }


@pytest.mark.parametrize("batch", [32, 16])
@pytest.mark.parametrize("h", [192, 256])
def test_column_pairs_and_device_operations_at_shipped_shapes(batch, h):
    """The plan of the eight bf16 decoder rows at the shipped shapes: the
    transposed convs' epilogues in column pairs (three chunks a tile),
    nothing else's; every product TMA-fed within a block's shared memory
    (the WN forward's in-layer convs and res/skip products on the
    warp-specialised unit, the rest on the 64-row one); the device
    operations a call as before."""
    plans = _plans(batch, h)
    for row, plan in plans.items():
        for p in plan["products"]:
            unit = "ws" if p["name"].startswith(("in_", "res_skip_")) else "tma"
            assert p["unit"] == unit and p["smem"] <= MAX_BLOCK_SMEM, (row, p)
            if p["kind"] == "conv_gemm":
                assert p["column_pairs"] == p["name"].startswith("transposed_"), (row, p)
                assert not p["column_pairs"] or p["chunks"] == 3
    launches = {r: plan["launches"] for r, plan in plans.items()}
    assert launches == {12: 36, 11: 46, 8: 26, 7: 35, 10: 14, 9: 13, 6: 9, 5: 9}
    pairs = {r: sum(p.get("column_pairs", False) for p in plan["products"])
             for r, plan in plans.items()}
    assert pairs == {12: 4, 11: 4, 8: 4, 7: 4, 10: 0, 9: 0, 6: 0, 5: 0}


def _tile_sums_by_layout(values, kw, pairs):
    """A 64-row tile [64, 64 chunks] f32's column sums as the TMA-fed
    kernel's epilogue takes them: 128 threads, kGroups column groups of kw
    columns (neighbouring, or kw / 2 pairs 2 kGroups apart), each thread
    adding its columns over the rows of its phase in order, then each
    column's phases added in order."""
    cols = values.shape[1]
    groups = cols // kw
    phases = 128 // groups
    stride = 2 * groups if pairs else 2
    out = torch.zeros(cols)
    for q in range(groups):
        first = 2 * q if pairs else kw * q
        mine = [first + (e // 2) * stride + e % 2 for e in range(kw)]
        for c in mine:
            v = torch.zeros((), dtype=torch.float32)
            for phase in range(phases):
                cs = torch.zeros((), dtype=torch.float32)
                for row in range(phase, 64, phases):
                    cs = cs + values[row, c]
                v = v + cs
            out[c] = v
    return out


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_column_pairs_keep_the_tile_sums_bits(chunks):
    """Every column lies in exactly one thread's group under either layout,
    and its tile sum (rows by phase, then the phases in order) is the same
    bits under both."""
    kw = 6 if chunks == 3 else 4
    groups = 64 * chunks // kw
    for pairs in (False, True):
        stride = 2 * groups if pairs else 2
        covered = sorted((2 * q if pairs else kw * q) + (e // 2) * stride + e % 2
                         for q in range(groups) for e in range(kw))
        assert covered == list(range(64 * chunks))
    values = torch.randn(64, 64 * chunks, generator=torch.Generator().manual_seed(chunks)) * 1e3
    assert torch.equal(_tile_sums_by_layout(values, kw, False),
                       _tile_sums_by_layout(values, kw, True))


def test_folded_a_unit_by_precision():
    """zp = x @ A: bf16 on the TMA-fed kernel (JAX rounds zp to bf16 right
    after the product; the check in ``tests/test_torch_bf16_tc.py``), f32
    on the CUDA cores (a tensor-core accumulator's 1e-7 lean moves f32
    ActNorm's scale gradient by 1e-3)."""
    bf16 = tc_gemm.bf16_block_products(32, 704, 160, 192, 4, 5, 1, SMS)
    f32 = tc_gemm.forward_products(16 * 704, 160, 192, 4, 5, 1, SMS)
    assert next(p for p in bf16["products"] if p["name"] == "zp")["unit"] == "tma"
    assert next(p for p in f32["products"] if p["name"] == "zp")["unit"] == "core"
    assert bf16["counts"]["core_gemm"] == 0 and f32["counts"]["core_gemm"] == 1

"""The bf16 WN forward's two products on the warp-specialised unit (bf16
rows 5 and 6, and the forwards of rows 7, 9, 10 and 11), on the CPU.

* The plan (``tc_gemm.bf16_block_products`` with ``tc_gemm.bf16_ws_plan``,
  the plain version of ``ws_plan`` in ``csrc/bf16_gemm.cu``): at [32,
  704], [16, 704] at the large width (h 256) and [32, 1408], with and
  without the speaker conditioning, every in-layer conv and res/skip
  product on the new unit (``ws``), the rest of the flow block's bf16
  products, the WN walk's and the text chains' on the units they had,
  the f32 plans without it; the device operations a call unchanged.
* The unit's static order puts every 64-row tile of every sample, by
  every column tile, in exactly one slot of one block, no tile crossing a
  sample; its shared memory within a block's 232,448 bytes; the last
  layer's res/skip computes only the skip half (N = h).
* The layer products' plain version (``tc_gemm.bf16_wn_product``, whose
  CUDA route is the new unit) chained over the layers against the plain
  bf16 stack and the JAX package's ``wn_stack_fused`` with dtype bf16 (its
  Pallas kernels in interpret mode) within half of JAX's own bf16-vs-f32
  gap (``tests/test_torch_bf16.py``'s measure).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import wn_pallas
from glow_tts_train_tpu_torch.ops import tc_gemm, wn_cuda

from test_torch_bf16 import BF16, _inputs, _np, held_to_gap

SMS = 132  # the H100's streaming multiprocessors
MAX_BLOCK_SMEM = 232448
TAPS = 5
# (batch, t, h, gin): base [32, 704], large [16, 704] at h 256, a long
# bucket [32, 1408], and the multispeaker width's conditioning
SHAPES = [(32, 704, 192, 0), (16, 704, 256, 0), (32, 1408, 192, 0), (32, 704, 192, 256)]
# widths that are not a multiple of 64: the unit takes them too (its last
# column tile reaches past h, and the kernel's epilogues write nothing there)
ODD_WIDTHS = [(32, 704, 160, 0), (32, 704, 96, 256)]


def _plans(batch, t, h, c=160, with_g=False):
    base = (batch, t, c, h, 4, TAPS, 1, SMS)
    wn = (batch, t, 0, h, 4, TAPS, 1, SMS)
    return {
        10: tc_gemm.bf16_block_products(*base), 9: tc_gemm.bf16_block_products(*base, saves=False),
        12: tc_gemm.bf16_block_products(*base, backward=True, with_g=with_g),
        11: tc_gemm.bf16_block_products(*base, backward=True, with_g=with_g, recompute=True),
        6: tc_gemm.bf16_block_products(*wn), 5: tc_gemm.bf16_block_products(*wn, saves=False),
        8: tc_gemm.bf16_block_products(*wn, backward=True, with_g=with_g),
        7: tc_gemm.bf16_block_products(*wn, backward=True, with_g=with_g, recompute=True),
    }


@pytest.mark.parametrize("batch,t,h,gin", SHAPES + ODD_WIDTHS)
def test_forward_products_take_the_ws_unit(batch, t, h, gin):
    """Every in-layer conv and res/skip product of the eight bf16 rows on
    the warp-specialised unit, two row tiles a unit and one buffer for the
    in-layer conv, one and two for res/skip; the folded A, the start conv,
    the coupling and the walk's products on the 64-row TMA-fed unit; the
    counts by unit (at a width that is not a multiple of 64 a weight
    gradient of the walk may take the mma.sync kernel, as before)."""
    plans = _plans(batch, t, h, with_g=gin > 0)
    for row, plan in plans.items():
        for p in plan["products"]:
            wn_forward = p["name"].startswith(("in_", "res_skip_"))
            others = ("tma", "mma") if h % 64 and p["kind"] == "wgrad" else ("tma",)
            assert p["unit"] == "ws" if wn_forward else p["unit"] in others, (row, p)
            if p["name"].startswith("in_"):
                assert (p["chunks"], p["rows"], p["bufs"]) == (2, 2, 1)
                assert p["shape"] == [batch * t, TAPS * h, 2 * h]
            elif p["name"].startswith("res_skip_"):
                assert (p["chunks"], p["rows"], p["bufs"]) == (3, 1, 2)
        fwd = sum(p["name"].startswith(("in_", "res_skip_")) for p in plan["products"])
        assert plan["counts"]["bf16_ws_gemm"] == fwd
        assert fwd == (8 if row in (5, 6, 7, 9, 10, 11) else 0), row
        assert plan["counts"]["bf16_gemm"] == plan["counts"]["core_gemm"] == 0


@pytest.mark.parametrize("batch,t,h,gin", SHAPES)
def test_text_chains_and_f32_plans_keep_their_units(batch, t, h, gin):
    """The bf16 text chains (encoder layer, prenet, duration stack at [32,
    192]) keep the 64-row unit by their split-K plan, and the f32 forward
    plan (``tc_gemm.forward_products``) its TMA-fed 3xTF32 kernel: no
    product of either on the new unit."""
    for bwd in (False, True):
        for plan in (tc_gemm.bf16_encoder_products(32, 192, 192, 768, 3, SMS, bwd),
                     tc_gemm.bf16_prenet_products(32, 192, 192, 3, 5, SMS, bwd),
                     tc_gemm.bf16_duration_products(32, 192, 192 + gin, 256, 3, SMS, bwd)):
            assert {p["unit"] for p in plan["products"]} == {"tma"}
            assert "bf16_ws_gemm" not in plan["counts"]
    for save in (False, True):
        for c in (0, 160):
            plan = tc_gemm.forward_products(batch * t, c, h, 4, TAPS, 1, SMS, save=save)
            assert {p["unit"] for p in plan["products"]} <= {"tc", "core"}
            assert "bf16_ws_gemm" not in plan["counts"]


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
def test_device_operations_a_call_unchanged(with_g):
    """At base width and [32, 704]: 9 / 9 / 13 / 14 / 35 / 46 / 26 / 36
    device operations a call of rows 5 / 6 / 9 / 10 / 7 / 11 / 8 / 12, one
    launch a product on either unit (the new unit has no second pass)."""
    plans = _plans(32, 704, 192, with_g=with_g)
    want = {5: 9, 6: 9, 9: 13, 10: 14, 7: 35, 11: 46, 8: 26, 12: 36}
    assert {row: plan["launches"] for row, plan in plans.items()} == want
    for plan in plans.values():
        assert all(p["launches"] == 1 for p in plan["products"] if p["unit"] == "ws")


@pytest.mark.parametrize("batch,t", [(32, 704), (16, 704), (32, 1408), (5, 100), (7, 37),
                                     (3, 65), (1, 64)])
@pytest.mark.parametrize("kind", ["in_conv", "res_skip", "res_skip_last"])
def test_static_order_puts_every_tile_in_one_slot(batch, t, kind):
    """The static order (unit u on block u mod blocks, each unit's row
    tiles the next ones in row order, its column tile turned by its round):
    every 64-row tile of every sample, by every column tile, in exactly one
    unit of one block; a tile's rows within its sample; a unit of the
    in-layer conv two tiles but the last where the count is odd; no more
    blocks than SMs or units, a whole number of column tiles' blocks; a
    block's units taking the column tiles in turn."""
    for h in (96, 160, 192, 256):
        gate, last = kind == "in_conv", kind == "res_skip_last"
        plan = tc_gemm.bf16_ws_plan(batch, t, h, 2 * h, SMS, gate, last, TAPS if gate else 1)
        order = tc_gemm.bf16_ws_order(batch, t, plan)
        assert len(order) == plan["blocks"] == min(SMS // plan["col_tiles"] * plan["col_tiles"],
                                                   plan["units"])
        assert plan["blocks"] % plan["col_tiles"] == 0
        tiles_t = -(-t // 64)
        seen = {}
        for blk, units in enumerate(order):
            for tiles, ct in units:
                assert 1 <= len(tiles) <= plan["rows"]
                for sample, t0 in tiles:
                    assert 0 <= sample < batch and 0 <= t0 < t and t0 % 64 == 0
                    key = (sample, t0, ct)
                    assert key not in seen, key
                    seen[key] = blk
        assert set(seen) == {(b, 64 * i, ct) for b in range(batch) for i in range(tiles_t)
                             for ct in range(plan["col_tiles"])}
        for units in order:  # the column tiles in turn
            cts = [ct for _, ct in units]
            assert all(b == (a + 1) % plan["col_tiles"] for a, b in zip(cts, cts[1:])), cts
        short = [len(tiles) for units in order for tiles, _ in units if len(tiles) < plan["rows"]]
        assert len(short) == plan["col_tiles"] * ((batch * tiles_t) % plan["rows"])


@pytest.mark.parametrize("h", [64, 96, 160, 192, 256])
def test_shared_memory_within_a_block(h):
    """The unit's ring, accumulator buffers and barriers within a block's
    232,448 bytes: the in-layer conv four stages of two A boxes and two B
    chunks beside one buffer of 128 rows; res/skip three stages beside two
    buffers (at h 192 its whole K walk of three steps); a bare product's 1
    to 3 chunks."""
    gate = tc_gemm.bf16_ws_plan(32, 704, h, 2 * h, SMS, True, taps=TAPS)
    res = tc_gemm.bf16_ws_plan(32, 704, h, 2 * h, SMS, False)
    assert gate["smem"] <= MAX_BLOCK_SMEM and res["smem"] <= MAX_BLOCK_SMEM
    assert gate["stages"] == 4 and gate["threads"] == 640
    assert res["stages"] == (3 if res["chunks"] == 3 else 6) and res["threads"] == 512
    assert res["steps"] == -(-h // 64) and (h > 192 or res["steps"] <= res["stages"])
    for chunks in (1, 2, 3):
        layout = tc_gemm.bf16_ws_layout(chunks, 1, 2)
        assert 3 <= layout["stages"] <= 8 and layout["smem"] <= MAX_BLOCK_SMEM


@pytest.mark.parametrize("h", [96, 160, 192, 256])
def test_last_res_skip_computes_the_skip_half(h):
    """The last layer's res/skip (its residual half discarded) takes only
    B's skip columns: N = h from column h, half the middle layers' units."""
    plans = _plans(32, 704, h)
    for row in (5, 6, 9, 10):
        by_name = {p["name"]: p for p in plans[row]["products"]}
        last, middle = by_name["res_skip_3"], by_name["res_skip_1"]
        assert last["shape"] == [32 * 704, h, h] and last["col0"] == h
        assert middle["shape"] == [32 * 704, h, 2 * h] and middle["col0"] == 0
        assert last["units"] == 32 * 11 * -(-h // 192)
        assert middle["units"] == 32 * 11 * -(-2 * h // 192)


H, L, DILATION = 32, 3, 2


def test_layer_products_chain_within_half_of_jax_gap():
    """The in-layer conv and res/skip of ``tc_gemm.bf16_wn_product`` (CPU:
    their plain versions) chained over 3 layers as the forward-save chain
    runs them (x updated by each res/skip, the skip sum written by the
    first and added to by the rest, skipm by the last), dropout on: the
    skip output and every layer's saves (x, th, sg) equal the plain bf16
    stack's within one bf16 step of their max, and the output within half
    of JAX's own bf16-vs-f32 gap of ``wn_stack_fused`` with dtype bf16."""
    rng = np.random.default_rng(11)
    w_in = (rng.standard_normal((L, TAPS * H, 2 * H)) * (TAPS * H) ** -0.5).astype(np.float32)
    w_rs = (rng.standard_normal((L, H, 2 * H)) * H ** -0.5).astype(np.float32)
    w_rs[-1, :, :H] = 0.0
    b_in = (0.1 * rng.standard_normal((L, 2 * H))).astype(np.float32)
    b_rs = (0.1 * rng.standard_normal((L, 2 * H))).astype(np.float32)
    b_rs[-1, :H] = 0.0
    x, mask = _inputs(20, H, seed=12)
    p, seed = 0.05, 17
    tw = (torch.from_numpy(w_in).to(BF16), torch.from_numpy(b_in),
          torch.from_numpy(w_rs).to(BF16), torch.from_numpy(b_rs))
    tx, tm = torch.from_numpy(x).to(BF16), torch.from_numpy(mask)
    xs, ths, sgs = [], [], []
    skip = torch.zeros(tx.shape)
    cur = tx
    for l in range(L):
        xs.append(cur)
        acts, th, sg = tc_gemm.bf16_wn_product(
            "gate", cur, tw[0][l], tw[1][l], taps=TAPS, dilation=DILATION ** l,
            drop=(p, seed, l, L), saves=True)
        ths.append(th)
        sgs.append(sg)
        nxt, skip, skipm = tc_gemm.bf16_wn_product(
            "res_skip", acts, tw[2][l], tw[3][l], x_l=cur, skip=skip, mask=tm, layer=l,
            n_layers=L, skip_mask=True)
        cur = nxt if nxt is not None else cur
    ref_saves: dict = {}
    ref = wn_cuda.wn_stack_plain_bf16(tw, None, tx, tm, TAPS, DILATION, p, seed,
                                      saves=ref_saves)
    for name, got, want in [("out", [skipm], [ref]), ("xs", xs, ref_saves["xs"]),
                            ("th", ths, ref_saves["th"]), ("sg", sgs, ref_saves["sg"])]:
        for i, (a, b) in enumerate(zip(got, want)):
            a, b = a.float(), b.float()
            assert (a - b).abs().max().item() <= 2 ** -7 * b.abs().max().item(), (name, i)
    # JAX at dropout 0 (its keep masks are the port's; the gap is measured
    # without them, as tests/test_torch_bf16_modes.py measures it)
    outs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        m = jnp.asarray(mask, dt)
        out = wn_pallas.wn_stack_fused(
            *(jnp.asarray(a, dt if i in (0, 2) else jnp.float32)
              for i, a in enumerate((w_in, b_in, w_rs, b_rs))),
            jnp.asarray(x, dt), m, jnp.zeros((x.shape[0], L, 2 * H), dt), jnp.int32(0),
            kernel_size=TAPS, dilation_rate=DILATION, n_layers=L, p_dropout=0.0,
            deterministic=True, interpret=True, residuals="store")
        outs[dt] = out * m
    skip = torch.zeros(tx.shape)
    cur = tx
    for l in range(L):
        (acts,) = tc_gemm.bf16_wn_product("gate", cur, tw[0][l], tw[1][l], taps=TAPS,
                                          dilation=DILATION ** l)
        nxt, skip, skipm = tc_gemm.bf16_wn_product(
            "res_skip", acts, tw[2][l], tw[3][l], x_l=cur, skip=skip, mask=tm, layer=l,
            n_layers=L, skip_mask=True)
        cur = nxt if nxt is not None else cur
    assert held_to_gap("out", _np(skipm), outs[jnp.bfloat16], outs[jnp.float32]) < 0.5

"""The WN forward chains' redesign for the tensor cores on the CPU: their
plan and the arithmetic their kernels do.

* ``tc_gemm.forward_products``, the plain version of the dispatch of the
  WN stack's and the flow block's forward calls (csrc/block_train.cu):
  every product, the unit and mode it takes (the in-layer conv TMA-fed,
  ``conv_gemm_tma_kernel``), its tile and cluster, the weight matrices
  split in the call's one launch, and the device operations of a call of
  ``gtt_wn_forward``, ``gtt_wn_fwd_save``, ``gtt_block_fwd`` and
  ``gtt_block_fwd_save`` (rows 5, 6, 9 and 10 of PERF.md's table) and of
  the forward part of ``gtt_wn_bwd`` and ``gtt_block_bwd`` (rows 7 and 11),
  at base width [16, 704, 192], the DDI batch [16, 576, 192], large width
  (h 256), dilation rate 2 and narrow widths, where every product is
  declined to the CUDA cores.
* The TMA-fed kernel's shared memory within a block's 232,448 bytes.
* The weights' split in a paired epilogue's tile order (what the TMA-fed
  kernel reads, ``WeightSplit::pair``): today's split, the same bits, its
  rows reordered.
* An emulation of the forward's arithmetic on the CPU
  (``forward_emulated``): each product by ``tc_gemm.matmul_3xtf32_plain``
  per 32-deep slice, the in-layer conv's K walked channel slice outer and
  tap inner, the gate, dropout and conditioning in its epilogue.  Its skip
  sum and its saves (the layers' inputs and gates) against
  ``wn_stack_plain`` and against the JAX package's forward-save kernel
  (``wn_pallas``, interpret mode, portable bits, as
  ``test_torch_decoder_modes.py`` runs it) and its fused stack's forward,
  each within 1e-5 of the output's max (f32, summation order and the
  split's 2^-21 only): dropout off and on, with and without g, dilation 1
  and 2, one and two channel slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import wn_pallas
from glow_tts_train_tpu_torch.ops import tc_gemm, wn_cuda

SMS = 132
BASE_ROWS = 16 * 704
DDI_ROWS = 16 * 576
RTOL = 1e-5

# name -> (c, save, device operations a call) at base width
ROW_CALLS = {
    "row5_wn_forward": (0, False, 10),
    "row6_wn_fwd_save": (0, True, 10),
    "row9_block_fwd": (160, False, 14),
    "row10_block_fwd_save": (160, True, 15),
}


@pytest.mark.parametrize("name", sorted(ROW_CALLS))
def test_forward_plan_at_base_width(name):
    """At [16, 704, 192], 4 layers, 5 taps, dilation 1: every in-layer conv
    TMA-fed in TMA_TILE_ROWS-row tiles and clusters of TMA_CLUSTER, every
    res/skip product too (TMA_ONE_TAP), the block's start and coupling
    products on the tensor cores tap by tap and zp on the CUDA cores by
    design; one
    weight-split launch for every tensor-core product; 10 device
    operations a WN call (split, copy, 8 products), 14 and 15 a block call
    (split, 10 products, ld's two sums, and the forward-save's z copy)."""
    c, save, launches = ROW_CALLS[name]
    plan = tc_gemm.forward_products(BASE_ROWS, c, 192, 4, 5, 1, SMS, save)
    by_name = {p["name"]: p for p in plan["products"]}
    for l in range(4):
        conv = by_name[f"in_{l}"]
        assert (conv["mode"], conv["unit"], conv["shape"]) == ("TMA ring", "tc",
                                                               [BASE_ROWS, 960, 384])
        assert (conv["tile_rows"], conv["cluster"]) == (tc_gemm.TMA_TILE_ROWS, tc_gemm.TMA_CLUSTER)
        rs = by_name[f"res_skip_{l}"]
        assert rs["mode"] == ("TMA ring" if tc_gemm.TMA_ONE_TAP else "whole K")
        assert rs["unit"] == "tc"
    assert plan["launches"] == launches
    n_convs = 8 + (3 if c else 0)
    want = {"tc_gemm": n_convs - (1 if c else 0), "tc_wgrad": 0,
            "core_gemm": 1 if c else 0, "core_wgrad": 0, "declined_gemm": 0,
            "declined_wgrad": 0, "tap_staged_gemm": 0, "bias_wgrad": 0, "split_dy_wgrad": 0,
            "tma_gemm": 8 if tc_gemm.TMA_ONE_TAP else 4}
    assert plan["counts"] == want
    # the folded A's product stays on the CUDA cores and splits nothing
    assert plan["splits"] == want["tc_gemm"] <= 24
    if c:
        assert by_name["zp"]["unit"] == "core" and not by_name["zp"]["asks"]
        assert by_name["coupling"]["shape"] == [BASE_ROWS, 192, 160]


@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("c,launches", [(0, 37), (160, 47)])
def test_recompute_backwards_forward_part_takes_the_forward_plan(c, launches, with_g):
    """Rows 7 and 11 run the forward chain into scratch with the forward's
    plan (so their forward equals rows 6 and 10 bit for bit): its WN
    products TMA-fed, their weights split in the call's one launch beside
    the walk's; the device operations of a call as before."""
    plan = tc_gemm.walk_products(BASE_ROWS, c, 192, 4, 5, 1, SMS, recompute=True, with_g=with_g)
    fwd = [p for p in plan["products"] if p["name"].startswith("fwd ")]
    ref = tc_gemm.forward_products(BASE_ROWS, c, 192, 4, 5, 1, SMS)["products"]
    ref = [p for p in ref if p["name"] != "coupling"]  # a recompute needs no z
    assert [p["name"] for p in fwd] == ["fwd " + p["name"] for p in ref]
    assert [(p["mode"], p["tile_rows"]) for p in fwd] == [(p["mode"], p["tile_rows"]) for p in ref]
    assert plan["counts"]["tma_gemm"] == (8 if tc_gemm.TMA_ONE_TAP else 4)
    assert plan["launches"] == launches + (4 if with_g else 0)


@pytest.mark.parametrize("dilation_rate", [1, 2])
@pytest.mark.parametrize("rows,h", [(BASE_ROWS, 192), (DDI_ROWS, 192), (BASE_ROWS, 256)])
def test_forward_plan_takes_the_tma_ring_and_its_stages_fit(rows, h, dilation_rate):
    """Base width, the DDI batch and large width, dilation 1 and 2 (layers
    at 1, 2, 4, 8): every in-layer conv TMA-fed, its stages (the B ring,
    two A stages of the tile and its halo) within a block's shared memory,
    in 64-row tiles two blocks an SM; the WN call's 10 device operations."""
    plan = tc_gemm.forward_products(rows, 0, h, 4, 5, dilation_rate, SMS)
    assert all(p["mode"] == "TMA ring" for p in plan["products"] if p["name"].startswith("in_"))
    assert plan["launches"] == 10
    for l in range(4):
        conv = tc_gemm.forward_conv_plan(rows, h, 2 * h, 5, dilation_rate ** l, SMS)
        assert conv["mode"] == "tma" and conv["smem"] <= tc_gemm.MAX_BLOCK_SMEM
    for tile_rows in (128, 64):
        assert tc_gemm.tma_smem(tile_rows, 5, 8) <= tc_gemm.MAX_BLOCK_SMEM
    # 64-row tiles: two blocks an SM (the SM's 228 KB, 1 KB a block reserved)
    assert 2 * (tc_gemm.tma_smem(64, 5, 1) + 1024) <= 233472


def test_forward_plan_declines_what_does_not_fit():
    """The TMA-fed mode needs 32-channel slices, 128-column tiles, a halo
    shorter than the tile and blocks for a quarter of the SMs; the narrow
    widths of the tests (h 16, a few hundred rows) decline every product
    to the CUDA cores: no weight-split launch."""
    # h 20: 40 channels, not whole 32-channel slices: tap by tap
    assert tc_gemm.forward_conv_plan(BASE_ROWS, 40, 128, 5, 1, SMS)["mode"] == "tap_by_tap"
    # 320 columns, not whole 128-column tiles (h 160): tap by tap
    assert tc_gemm.forward_conv_plan(BASE_ROWS, 160, 320, 5, 1, SMS)["mode"] == "tap_by_tap"
    # a dilated halo as long as the tile: tap by tap
    tile = tc_gemm.TMA_TILE_ROWS
    edge = -(-tile // 4)  # the least dilation whose halo of 4 taps is a tile
    assert tc_gemm.forward_conv_plan(BASE_ROWS, 192, 384, 5, edge, SMS)["mode"] == "tap_by_tap"
    assert tc_gemm.forward_conv_plan(BASE_ROWS, 192, 384, 5, edge - 1, SMS)["mode"] == "tma"
    # a few rows: 1 row tile of 3 columns for 132 SMs
    assert tc_gemm.forward_conv_plan(100, 192, 384, 5, 1, SMS)["mode"] == "core"
    # 11 row tiles x 3 = 33 blocks: a quarter of the SMs, just
    assert tc_gemm.forward_conv_plan(11 * tile, 192, 384, 5, 1, SMS)["mode"] == "tma"
    assert tc_gemm.forward_conv_plan(10 * tile, 192, 384, 5, 1, SMS)["mode"] != "tma"
    for c in (0, 8):
        plan = tc_gemm.forward_products(3 * 37, c, 16, 2, 5, 1, SMS, save=True)
        assert all(p["unit"] == "core" for p in plan["products"])
        assert plan["splits"] == 0
        assert plan["launches"] == (1 + 4 if c == 0 else 3 + 2 + 4 + 1)
        assert plan["counts"]["declined_gemm"] == (4 if c == 0 else 6)


@pytest.mark.parametrize("k,n", [(960, 384), (1280, 512), (40, 24), (37, 50)])
def test_tile_order_split_is_a_permutation(k, n):
    """The split in tile order (pair n / 2) holds today's split's rows, the
    same bits: tile row i is B's column physical_cols(n, n / 2)[i], so each
    gate pair (j, j + n / 2) sits at rows 2j and 2j + 1."""
    rng = np.random.default_rng(k * n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    natural = tc_gemm.split_weights_plain(w)
    tiled = tc_gemm.split_weights_plain(w, n // 2)
    cols = tc_gemm.physical_cols(n, n // 2)
    assert sorted(cols.tolist()) == list(range(n))
    assert torch.equal(tiled, natural[:, cols])
    j = torch.arange(n // 2)
    assert torch.equal(tiled[:, 2 * j], natural[:, j])
    assert torch.equal(tiled[:, 2 * j + 1], natural[:, j + n // 2])
    # big + small of each row is the weight to 2^-21
    back = (tiled[0] + tiled[1]).T
    assert torch.allclose(back, w[:, cols], rtol=2 ** -20, atol=0)


# ---------------------------------------------------------------------------
# the forward's arithmetic, emulated
# ---------------------------------------------------------------------------


def tap_staged_order(c_in: int, taps: int) -> torch.Tensor:
    """The K order of the TMA-fed (and tap-staged) walk: channel slice
    outer, tap inner, as indices into the tap-major im2col columns."""
    return torch.tensor([tap * c_in + cs * 32 + j for cs in range(c_in // 32)
                         for tap in range(taps) for j in range(32)])


def _mm3(a, b):
    return tc_gemm.matmul_3xtf32_plain(a, b, slice_k=32)


def forward_emulated(folded, g_all, x, x_mask, taps, dilation_rate, p_dropout, seed):
    """The WN stack's forward as csrc/block_train.cu computes it on the
    tensor cores -> (skip sum [b, t, h], saves xs / th / sg [L, b, t, h])."""
    w_in, b_in, w_rs, b_rs = folded
    n_layers = w_in.shape[0]
    b, t, h = x.shape
    rows = b * t
    mask = x_mask.reshape(rows, 1)
    xs, ths, sgs = [], [], []
    skip = torch.zeros(rows, h)
    for l in range(n_layers):
        xs.append(x)
        cols = tc_gemm.im2col_plain(x, taps, dilation_rate ** l).reshape(rows, -1)
        w = w_in[l]
        if h % 32 == 0:  # K walked channel slice outer, tap inner
            order = tap_staged_order(h, taps)
            cols, w = cols[:, order], w[order]
        pre = (_mm3(cols, w) + b_in[l]).reshape(b, t, 2 * h)
        pre = wn_cuda.site_dropout(pre, seed, l, n_layers, p_dropout)
        if g_all is not None:
            pre = pre + g_all[:, l][:, None, :]
        th, sg = torch.tanh(pre[..., :h]), torch.sigmoid(pre[..., h:])
        ths.append(th)
        sgs.append(sg)
        rs = _mm3((th * sg).reshape(rows, h), w_rs[l]) + b_rs[l]
        x = ((x.reshape(rows, h) + rs[:, :h]) * mask).reshape(b, t, h)
        skip = skip + rs[:, h:]
    return skip.reshape(b, t, h), {"xs": torch.stack(xs), "th": torch.stack(ths),
                                   "sg": torch.stack(sgs)}


def _folded(rng, n_layers, h, taps):
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    w_in = r(n_layers, taps * h, 2 * h, scale=(taps * h) ** -0.5)
    b_in = r(n_layers, 2 * h, scale=0.1)
    w_rs = r(n_layers, h, 2 * h, scale=h ** -0.5)
    b_rs = r(n_layers, 2 * h, scale=0.1)
    w_rs[-1, :, :h] = 0.0  # the last layer has no residual half
    b_rs[-1, :h] = 0.0
    return w_in, b_in, w_rs, b_rs


def _jax_fwd_save(folded, x_np, mask_np, g_np, taps, dilation_rate, n_layers, p, seed):
    """The JAX package's forward-save kernel (interpret mode) -> skip,
    xs / th / sg [L, b, t, h]."""
    drop = p > 0.0
    st = {"n_layers": n_layers,
          "offs": tuple(wn_pallas._offsets(taps, dilation_rate ** l) for l in range(n_layers)),
          "drop_threshold": (np.uint32(min(round(p * 2 ** 32), 2 ** 32 - 1)) if drop else None),
          "drop_scale": 1.0 / (1.0 - p) if drop else 1.0, "interpret": True}
    out = wn_pallas._wn_pallas_call(
        *(jnp.asarray(w.numpy()) for w in folded), jnp.asarray(x_np), jnp.asarray(mask_np),
        jnp.asarray(g_np), jnp.asarray(seed, jnp.int32).reshape((1,)), st=st, interpret=True,
        mode="fwd_save")
    skip, xs, th, sg = (np.asarray(o) for o in out)
    return skip, {k: v.transpose(1, 0, 2, 3) for k, v in (("xs", xs), ("th", th), ("sg", sg))}


# name -> (h, n_layers, dilation rate, p_dropout, with_g)
EMULATION_CASES = {
    "h16_plain": (16, 3, 1, 0.0, False),
    "h16_dropout_g": (16, 2, 1, 0.3, True),
    "h32_dilation2": (32, 3, 2, 0.0, False),
    "h32_dilation2_dropout_g": (32, 4, 2, 0.3, True),
    "h32_g": (32, 2, 1, 0.0, True),
    "h64_two_slices_dropout": (64, 2, 1, 0.3, False),
    "h64_two_slices_dilation2_g": (64, 2, 2, 0.0, True),
    "h8_dilation2_dropout": (8, 4, 2, 0.3, False),
}


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_forward_emulation_matches_plain_and_jax(name):
    """The emulated forward's skip sum and saves against ``wn_stack_plain``
    and the JAX package's forward-save kernel, and its skip sum against the
    JAX fused stack's forward, same weights and seed; ragged lengths; at h
    64 the in-layer conv walks two channel slices, so its K order differs
    from the tap-major one."""
    h, n_layers, dilation_rate, p, with_g = EMULATION_CASES[name]
    taps, b, t, seed = 5, 3, 24, 2 ** 31 - 11
    rng = np.random.default_rng(100 + sorted(EMULATION_CASES).index(name))
    folded = _folded(rng, n_layers, h, taps)
    lengths = np.array([t, t - 7, 5])
    mask_np = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    x_np = rng.standard_normal((b, t, h)).astype(np.float32) * mask_np
    g_np = (rng.standard_normal((b, n_layers, 2 * h)).astype(np.float32) if with_g
            else np.zeros((b, n_layers, 2 * h), np.float32))
    x, mask = torch.from_numpy(x_np), torch.from_numpy(mask_np)
    g_all = torch.from_numpy(g_np) if with_g else None

    skip, saves = forward_emulated(folded, g_all, x, mask, taps, dilation_rate, p, seed)
    plain_saves: dict = {}
    plain = wn_cuda.wn_stack_plain(folded, g_all, x, mask, taps, dilation_rate, p, seed,
                                   plain_saves)
    jax_skip, jax_saves = _jax_fwd_save(folded, x_np, mask_np, g_np, taps, dilation_rate,
                                        n_layers, p, seed)
    fused = np.asarray(wn_pallas.wn_stack_fused(
        *(jnp.asarray(w.numpy()) for w in folded), jnp.asarray(x_np), jnp.asarray(mask_np),
        jnp.asarray(g_np), jnp.int32(seed), kernel_size=taps, dilation_rate=dilation_rate,
        n_layers=n_layers, p_dropout=p, deterministic=p == 0.0, interpret=True,
        residuals="store"))
    wants = [("skip", skip, plain.numpy(), "plain"), ("skip", skip, jax_skip, "jax fwd_save"),
             ("skip", skip, fused, "jax fused")]
    for k in ("xs", "th", "sg"):
        wants.append((k, saves[k], torch.stack(plain_saves[k]).numpy(), "plain"))
        wants.append((k, saves[k], jax_saves[k], "jax fwd_save"))
    for what, got, want, ref in wants:
        assert np.abs(want).max() > 0, (what, ref)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max(),
                                   err_msg=f"{name} {what} vs {ref}")


def test_tap_staged_order_visits_every_column_once():
    """Channel slice outer, tap inner visits every im2col column once, in
    32-deep slices that each lie within one tap."""
    order = tap_staged_order(96, 5)
    assert sorted(order.tolist()) == list(range(5 * 96))
    slices = order.reshape(-1, 32)
    assert all(len({int(k) // 96 for k in s}) == 1 for s in slices)
    assert [int(s[0]) for s in slices[:6]] == [0, 96, 192, 288, 384, 32]

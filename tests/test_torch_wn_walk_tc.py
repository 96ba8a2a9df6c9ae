"""The WN reverse walk's redesign for the tensor cores on the CPU: its plan
and the arithmetic its kernels do.

* ``tc_gemm.walk_products``, the plain version of the dispatch of the WN
  stack's and the flow block's backward chains (csrc/block_train.cu):
  every product, the unit and the mode it takes (the transposed conv
  tap-staged, dW_in reading d_xin's K-major split, a bias row on every
  weight gradient), its tiles and row splits, the weight matrices split in
  the call's one launch, and the device operations of a call of
  ``gtt_wn_bwd_store``, ``gtt_wn_bwd``, ``gtt_block_bwd_store`` and
  ``gtt_block_bwd`` (rows 8, 7, 12 and 11 of PERF.md's table), with and
  without the conditioning gradient, at base width [16, 704, 192], at
  large width (h 256), at dilation rate 2 and at narrow widths, where
  every product is declined to the CUDA cores.
* The shared memory of the new kernels' stages within a block's 232,448
  bytes at base and large width.
* An emulation of the walk's arithmetic on the CPU (``walk_emulated``):
  each product by ``tc_gemm.matmul_3xtf32_plain`` per 32-deep slice, the
  transposed conv's K walked channel slice outer and tap inner, W_rs and
  W_in read through the per-tap transpose of the forward's weights, the
  bias gradients as the output row of a column of ones in the weight
  gradients' row slices (split in shares added in order), dW_in's dY read
  as d_xin's K-major split.  Its gradients against autograd of
  ``wn_stack_plain`` and against ``jax.vjp`` of the JAX package's fused WN
  stack (``wn_pallas.wn_stack_fused``, its backward kernel in interpret
  mode, as ``test_torch_decoder_modes.py`` runs it), each within 1e-5 of
  the gradient's max (f32, summation order and the split's 2^-21 only):
  dropout off and on, with and without g, dilation 1 and 2.
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
RTOL = 1e-5

# name -> (c, recompute, with_g, device operations a call) at base width
ROW_CALLS = {
    "row8_wn_bwd_store": (0, False, False, 28),
    "row8_wn_bwd_store_dg": (0, False, True, 32),
    "row7_wn_bwd": (0, True, False, 37),
    "row7_wn_bwd_dg": (0, True, True, 41),
    "row12_block_bwd_store": (160, False, False, 37),
    "row12_block_bwd_store_dg": (160, False, True, 41),
    "row11_block_bwd": (160, True, False, 47),
    "row11_block_bwd_dg": (160, True, True, 51),
}


@pytest.mark.parametrize("name", sorted(ROW_CALLS))
def test_walk_plan_at_base_width(name):
    """At [16, 704, 192], 4 layers, 5 taps, dilation 1: every product on the
    tensor cores; per layer the gate backward (whole K walk, 128-row tiles,
    d_xin also written K-major), dW_rs and
    dW_in with their bias rows in 22 and 5 row splits (each a second pass),
    dW_in from d_xin's K-major split, the transposed conv tap-staged in
    64-row tiles: 6 device operations a layer.  Around them: one weight
    split launch for every conv-GEMM of the call, the walk's two fills (and
    the WN stack's copy of dout), a recompute's forward, the block's six
    products, and dg's per-sample sums (one launch a layer) when asked."""
    c, recompute, with_g, launches = ROW_CALLS[name]
    plan = tc_gemm.walk_products(BASE_ROWS, c, 192, 4, 5, 1, SMS, recompute, with_g)
    products = plan["products"]
    by_name = {p["name"]: p for p in products}
    for l in range(4):
        assert by_name[f"gate_{l}"]["mode"] == "whole K, d_xin K-major"
        assert (by_name[f"gate_{l}"]["unit"], by_name[f"gate_{l}"]["tile_rows"]) == ("tc", 128)
        assert (by_name[f"dW_rs_{l}"]["splits"], by_name[f"dW_rs_{l}"]["launches"]) == (22, 2)
        assert (by_name[f"dW_in_{l}"]["splits"], by_name[f"dW_in_{l}"]["launches"]) == (5, 2)
        assert by_name[f"dW_in_{l}"]["mode"] == "split dY"
        assert by_name[f"transposed_{l}"]["mode"] == "tap staged"
        assert by_name[f"transposed_{l}"]["tile_rows"] == 64
    assert all(p["bias"] for p in products if p["kind"] == "wgrad")
    assert plan["launches"] == launches
    n_convs = 8 + (4 if c else 0) + (8 + (2 if c else 0) if recompute else 0)
    want = {
        "tc_gemm": n_convs - (1 if c and recompute else 0),
        "tc_wgrad": 8 + (3 if c else 0), "core_gemm": 1 if c and recompute else 0,
        "core_wgrad": 0, "declined_gemm": 0, "declined_wgrad": 0,
        "tap_staged_gemm": 4, "bias_wgrad": 8 + (3 if c else 0), "split_dy_wgrad": 4,
    }
    assert plan["counts"] == want
    # the folded A's forward product stays on the CUDA cores and splits nothing
    assert plan["splits"] == want["tc_gemm"] <= 24


@pytest.mark.parametrize("dilation_rate", [1, 2])
@pytest.mark.parametrize("h", [192, 256])
def test_walk_plan_modes_and_stages_fit(h, dilation_rate):
    """Base and large width, dilation 1 and 2 (layers at 1, 2, 4, 8): the
    transposed conv tap-staged in every layer, dW_in from the split, and
    the stages of the tap-staged conv, of the split-dY weight gradient and
    of the gate backward's K-major staging within a block's shared memory."""
    plan = tc_gemm.walk_products(BASE_ROWS, 0, h, 4, 5, dilation_rate, SMS)
    modes = {p["name"]: p["mode"] for p in plan["products"]}
    assert all(modes[f"transposed_{l}"] == "tap staged" for l in range(4))
    assert all(modes[f"dW_in_{l}"] == "split dY" for l in range(4))
    assert plan["launches"] == 28
    bn = 128 if h % 128 == 0 else 64
    for l in range(4):
        t = tc_gemm.walk_transposed_plan(BASE_ROWS, 2 * h, h, 5, dilation_rate ** l, SMS)
        assert t["bn"] == bn and t["smem"] <= tc_gemm.MAX_BLOCK_SMEM
    assert tc_gemm.wgrad_split_smem(128) <= tc_gemm.MAX_BLOCK_SMEM
    # the gate backward [rows, 2h, h] stages d_xin within its own kernel's room
    assert tc_gemm.gate_stash_smem(bn) <= tc_gemm.conv_gemm_tc_smem(bn) <= tc_gemm.MAX_BLOCK_SMEM


def test_walk_plan_declines_what_does_not_fit():
    """The tap-staged mode needs 32-channel slices, a halo shorter than the
    tile and blocks for a quarter of the SMs; the narrow widths of the
    tests (h 16, a few hundred rows) decline every product to the CUDA
    cores: no weight split launch, a bias column sum a weight gradient."""
    # h 20: 40 channels, not whole 32-channel slices: the tap-by-tap walk
    t = tc_gemm.walk_transposed_plan(BASE_ROWS, 40, 64, 5, 1, SMS)
    assert t["mode"] == "tap_by_tap"
    # a dilated halo as long as the tile: tap by tap
    assert tc_gemm.walk_transposed_plan(BASE_ROWS, 384, 192, 5, 16, SMS)["mode"] == "tap_by_tap"
    assert tc_gemm.walk_transposed_plan(BASE_ROWS, 384, 192, 5, 15, SMS)["mode"] == "tap_staged"
    # a few rows: 1 row tile of 3 columns for 132 SMs
    assert tc_gemm.walk_transposed_plan(100, 384, 192, 5, 1, SMS)["mode"] == "core"
    plan = tc_gemm.walk_products(3 * 37, 0, 16, 2, 5, 1, SMS)
    assert all(p["unit"] == "core" for p in plan["products"])
    assert plan["splits"] == 0
    # fills and copy 3, per layer gate 1, dW_rs and dW_in (kernel, bias sum,
    # and the split pass where rows split) , transposed conv 1
    per_wgrad = [p["launches"] for p in plan["products"] if p["kind"] == "wgrad"]
    assert all(n >= 2 for n in per_wgrad)
    assert plan["launches"] == 3 + 2 * 2 + sum(per_wgrad)
    assert plan["counts"]["declined_gemm"] == 4 and plan["counts"]["declined_wgrad"] == 4


# ---------------------------------------------------------------------------
# the walk's arithmetic, emulated
# ---------------------------------------------------------------------------


def _mm3(a, b=None, splits=1, b_split=None):
    return tc_gemm.matmul_3xtf32_plain(a, b, slice_k=32, splits=splits, b_split=b_split)


def tap_staged_order(c_in: int, taps: int) -> torch.Tensor:
    """The K order of the tap-staged walk: channel slice outer, tap inner,
    as indices into the tap-major im2col columns (tap * c_in + channel)."""
    idx = [tap * c_in + cs * 32 + j for cs in range(c_in // 32) for tap in range(taps)
           for j in range(32)]
    return torch.tensor(idx)


def walk_emulated(folded, g_all, x, x_mask, dout, taps, dilation_rate, p_dropout, seed,
                  splits=2):
    """The WN stack's backward as csrc/block_train.cu computes it on the
    tensor cores: -> dx, dW_in, db_in, dW_rs, db_rs, dg (None without g)."""
    w_in, b_in, w_rs, b_rs = folded
    n_layers = w_in.shape[0]
    b, t, h = x.shape
    rows, h2 = b * t, 2 * h
    saves: dict = {}
    wn_cuda.wn_stack_plain(folded, g_all, x, x_mask, taps, dilation_rate, p_dropout, seed, saves)
    mask = x_mask.reshape(rows, 1)
    g_rs = torch.cat([torch.zeros(rows, h), dout.reshape(rows, h)], dim=1)
    gx = torch.zeros(rows, h)
    grads = {"dW_in": torch.empty_like(w_in), "db_in": torch.empty_like(b_in),
             "dW_rs": torch.empty_like(w_rs), "db_rs": torch.empty_like(b_rs)}
    dg = torch.empty(b, n_layers, h2) if g_all is not None else None
    ones = torch.ones(rows, 1)
    for l in reversed(range(n_layers)):
        dil = dilation_rate ** l
        th, sg = (saves[k][l].reshape(rows, h) for k in ("th", "sg"))
        # the gate backward: da = g_rs @ W_rs^T, W_rs read through w_t
        da = _mm3(g_rs, tc_gemm.transposed_weights_plain(w_rs[l], 1))
        dia = torch.cat([da * sg * (1 - th * th), da * th * sg * (1 - sg)], dim=1)
        d_xin = wn_cuda.site_dropout(dia.reshape(b, t, h2), seed, l, n_layers, p_dropout)
        d_xin = d_xin.reshape(rows, h2)
        # dW_rs with its bias row: [acts | 1]^T g_rs, row slices in shares
        out = _mm3(torch.cat([th * sg, ones], 1).T.contiguous(), g_rs, splits)
        grads["dW_rs"][l], grads["db_rs"][l] = out[:h], out[h]
        if dg is not None:
            dg[:, l] = dia.reshape(b, t, h2).sum(1)
        # dW_in with its bias row, dY read as d_xin's K-major split
        cols = tc_gemm.im2col_plain(saves["xs"][l], taps, dil).reshape(rows, -1)
        d_xin_t = torch.stack(tc_gemm.tf32_split(d_xin.T.contiguous()))
        out = _mm3(torch.cat([cols, ones], 1).T.contiguous(), None, splits, b_split=d_xin_t)
        grads["dW_in"][l], grads["db_in"][l] = out[:taps * h], out[taps * h]
        # the transposed conv, K walked channel slice outer, tap inner
        cols = tc_gemm.im2col_plain(d_xin.reshape(b, t, h2), taps, dil, -1).reshape(rows, -1)
        w_t = tc_gemm.transposed_weights_plain(w_in[l], taps)
        if h2 % 32 == 0:
            order = tap_staged_order(h2, taps)
            cols, w_t = cols[:, order], w_t[order]
        gx = gx * mask + _mm3(cols, w_t)
        g_rs = torch.cat([gx * mask, g_rs[:, h:]], dim=1)
    return {"dx": gx.reshape(b, t, h), **grads, "dg": dg}


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


EMULATION_CASES = {
    "h16_plain": (16, 3, 1, 0.0, False),
    "h16_dropout_g": (16, 3, 1, 0.3, True),
    "h32_dilation2": (32, 3, 2, 0.0, False),
    "h32_dilation2_dropout_g": (32, 3, 2, 0.3, True),
    "h32_g": (32, 2, 1, 0.0, True),
    "h16_dilation2_dropout": (16, 4, 2, 0.3, False),
}


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_walk_emulation_matches_autograd_and_jax(name):
    """dx, dW_in, db_in, dW_rs, db_rs and dg of the emulated walk against
    autograd of ``wn_stack_plain`` and ``jax.vjp`` of
    ``wn_pallas.wn_stack_fused`` (store mode, interpret), same weights,
    seed and cotangent; ragged lengths; at h 32 the transposed conv walks
    two channel slices, so its K order differs from the tap-major one."""
    h, n_layers, dilation_rate, p, with_g = EMULATION_CASES[name]
    taps, b, t, seed = 5, 3, 24, 2 ** 31 - 9
    rng = np.random.default_rng(sorted(EMULATION_CASES).index(name))
    folded = _folded(rng, n_layers, h, taps)
    lengths = np.array([t, t - 7, 5])
    mask_np = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    x_np = rng.standard_normal((b, t, h)).astype(np.float32) * mask_np
    g_np = rng.standard_normal((b, n_layers, 2 * h)).astype(np.float32) if with_g else None
    dout_np = rng.standard_normal((b, t, h)).astype(np.float32)
    x, mask, dout = (torch.from_numpy(a) for a in (x_np, mask_np, dout_np))
    g_all = torch.from_numpy(g_np) if with_g else None

    got = walk_emulated(folded, g_all, x, mask, dout, taps, dilation_rate, p, seed)

    leaves = [w.clone().requires_grad_(True) for w in folded]
    xp = x.clone().requires_grad_(True)
    gp = g_all.clone().requires_grad_(True) if with_g else None
    skip = wn_cuda.wn_stack_plain(tuple(leaves), gp, xp, mask, taps, dilation_rate, p, seed)
    inputs = [xp, *leaves] + ([gp] if with_g else [])
    plain = torch.autograd.grad((skip * dout).sum(), inputs)

    def f(w_in, b_in, w_rs, b_rs, xx, gg):
        return wn_pallas.wn_stack_fused(
            w_in, b_in, w_rs, b_rs, xx, jnp.asarray(mask_np), gg, jnp.int32(seed),
            kernel_size=taps, dilation_rate=dilation_rate, n_layers=n_layers, p_dropout=p,
            deterministic=p == 0.0, interpret=True, residuals="store",
        )

    g_j = jnp.asarray(g_np) if with_g else jnp.zeros((b, n_layers, 2 * h), jnp.float32)
    _, vjp = jax.vjp(f, *(jnp.asarray(w.numpy()) for w in folded), jnp.asarray(x_np), g_j)
    dw_in, db_in, dw_rs, db_rs, dx, dg = (np.asarray(r) for r in vjp(jnp.asarray(dout_np)))
    jax_grads = {"dx": dx, "dW_in": dw_in, "db_in": db_in, "dW_rs": dw_rs, "db_rs": db_rs,
                 "dg": dg}
    names = ["dx", "dW_in", "db_in", "dW_rs", "db_rs"] + (["dg"] if with_g else [])
    for n, ref in zip(names, plain):
        ref = ref.numpy()
        assert np.abs(ref).max() > 0, n
        for what, want in (("autograd", ref), ("jax", jax_grads[n])):
            np.testing.assert_allclose(
                got[n].numpy(), want, rtol=0, atol=RTOL * np.abs(want).max(),
                err_msg=f"{name} {n} vs {what}")
    assert (got["dg"] is None) == (not with_g)


def test_tap_staged_order_is_a_permutation_of_the_k_walk():
    """Channel slice outer, tap inner visits every im2col column once, in
    32-deep slices that each lie within one tap."""
    order = tap_staged_order(64, 5)
    assert sorted(order.tolist()) == list(range(5 * 64))
    slices = order.reshape(-1, 32)
    assert all(len({int(k) // 64 for k in s}) == 1 for s in slices)
    assert [int(s[0]) for s in slices[:6]] == [0, 64, 128, 192, 256, 32]

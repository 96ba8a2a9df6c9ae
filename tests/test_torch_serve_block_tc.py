"""The serving flow block's redesign for the tensor cores on the CPU: the
plan of its products and the weights' splits made at load.

* ``tc_gemm.inverse_product_plan`` (the plain version of the serving
  chain's ``conv_gemm_tc_plan``): the tile rows and K shares of each of the
  block's 11 products at base width for a lone 48- and 250-phoneme request
  (160 and 832 rows), b=4 (3,328) and b=8 (4,352), on 132 SMs; a lone
  sentence's choice against a brute force over tiles and share counts; the
  counts ``chip_smoke.py`` expects (``plan_counts``).
* ``block_cuda.split_inverse_weights``: each product's split equals
  ``tc_gemm.split_weights_plain`` of its weights, and a block inverse
  computed through those split layouts as the kernels compute it (the
  3xTF32 emulation ``matmul_3xtf32_plain``, 32-deep slices, the plan's K
  shares added in split order; the CUDA cores' products in f32) equals
  ``block_inverse_plain`` within 1e-5 of the output's max (f32 against an
  f32-accurate emulation: summation order only).  ``block_inverse_plain``
  itself is held against the JAX package's inverse block kernel in
  ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm

SMS = 132
# the products of one block at base width (c 160, h 192, 4 layers, 5 taps)
# -> (tile rows, K shares); 0 rows: the CUDA cores
BASE_PLANS = {
    160: {"start": (64, 2), "in": (64, 8), "res_skip": (64, 3), "end": (64, 3), "fold_a": (64, 3)},
    832: {"start": (64, 2), "in": (128, 6), "res_skip": (64, 3), "end": (64, 3), "fold_a": (64, 3)},
    3328: {"start": (128, 1), "in": (128, 3), "res_skip": (128, 1), "end": (128, 1),
           "fold_a": (128, 1)},
    4352: {"start": (128, 1), "in": (128, 1), "res_skip": (128, 1), "end": (128, 1),
           "fold_a": (128, 1)},
}


@pytest.mark.parametrize("rows", sorted(BASE_PLANS))
def test_serving_block_plan_at_base_width(rows):
    """Every product takes the tensor cores: a lone sentence in shares as
    short as 64 deep and mostly 64-row tiles, b=4 in the chains' shares
    (the in-layer conv in 3), b=8 on the whole K walk; the counts a call
    makes are 11 tensor-core products, none declined."""
    plan = tc_gemm.block_inverse_products(rows, 160, 192, 4, 5, SMS)
    assert [p["name"] for p in plan] == (
        ["start"] + [f"{k}_{l}" for l in range(4) for k in ("in", "res_skip")] + ["end", "fold_a"])
    want = BASE_PLANS[rows]
    for p in plan:
        kind = p["name"].rstrip("0123456789").rstrip("_")  # in_2 -> in
        assert (p["tile_rows"], p["splits"]) == want[kind], p
    assert tc_gemm.plan_counts(plan, chains=12) == {"tc_gemm": 132, "core_gemm": 0,
                                                    "declined_gemm": 0}


def _lone_cost(rows, kdim, n, tile_rows, shares):
    bn = 128 if n % 128 == 0 else 64
    tiles = -(-rows // tile_rows) * -(-n // bn)
    slices = -(-kdim // 32)
    per = -(-slices // shares)
    return -(-tiles * shares // SMS) * per


@pytest.mark.parametrize("rows", [96, 160, 417, 832, 1023])
def test_lone_sentence_plan_is_the_fewest_waves_times_slices(rows):
    """Below 1,024 rows the serving plan takes, for each product shape, the
    tile (128 or 64 rows) and share count (up to 8, at least 2 slices a
    share, at most 3,072 partial sums a row) of the fewest waves times
    slices a block, ties to fewer shares and then to 64 rows; from 1,024
    rows on, the chains' plan (at most 4 shares of 4 slices)."""
    for kdim, n in ((80, 192), (960, 384), (192, 384), (192, 160), (160, 160)):
        slices = -(-kdim // 32)
        best = None
        for shares in range(1, 9):
            per = -(-slices // shares)
            if -(-slices // per) != shares or (shares > 1 and (per < 2 or shares * n > 3072)):
                continue
            for tile_rows in (64, 128):
                key = (_lone_cost(rows, kdim, n, tile_rows, shares), shares, tile_rows)
                best = key if best is None or key < best else best
        assert tc_gemm.inverse_product_plan(rows, kdim, n, SMS) == (best[2], best[1]), (kdim, n)
    tile, shares = tc_gemm.inverse_product_plan(1024, 960, 384, SMS)
    assert (tile, shares) == (128, tc_gemm.text_product_plan(1024, 960, 384, SMS)[1])


def _folded(rng, c=64, h=64, n_layers=2, taps=5):
    """Random inverse-fold weights (``fold_block_params_inverse``'s keys) at
    widths whose products reach the tensor-core plan (N >= 64, K >= 32)."""
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return {
        "A": r(c, c, scale=c ** -0.5), "bA": r(1, c, scale=0.1),
        "W_s": r(c // 2, h, scale=(c // 2) ** -0.5), "b_s": r(1, h, scale=0.1),
        "W_e": r(h, c, scale=0.3 * h ** -0.5), "b_e": r(1, c, scale=0.1),
        "W_in": r(n_layers, taps * h, 2 * h, scale=(taps * h) ** -0.5),
        "b_in": r(n_layers, 2 * h, scale=0.1),
        "W_rs": r(n_layers, h, 2 * h, scale=h ** -0.5), "b_rs": r(n_layers, 2 * h, scale=0.1),
    }


def test_weight_splits_at_load_are_the_plain_split():
    rng = np.random.default_rng(0)
    folded = _folded(rng)
    split = block_cuda.split_inverse_weights(folded)
    assert set(split) == set(folded) | {k + "_split" for k in block_cuda.INVERSE_SPLIT_KEYS}
    for key in block_cuda.INVERSE_SPLIT_KEYS:
        w = folded[key]
        want = (torch.stack([tc_gemm.split_weights_plain(wl) for wl in w]) if w.dim() == 3
                else tc_gemm.split_weights_plain(w))
        assert torch.equal(split[key + "_split"], want), key


def _block_inverse_emulated(f, g_all, x, mask, taps, dilation_rate):
    """The serving block as its kernels compute it: each product through
    its stored split by the 3xTF32 emulation in the plan's K shares (f32 on
    the CUDA cores where the plan declines it)."""
    b, t, c = x.shape
    rows, c2 = b * t, c // 2
    h = f["W_s"].shape[1]

    def product(a, key, layer=None, k_taps=1, dilation=1):
        w, split = f[key], f[key + "_split"]
        if layer is not None:
            w, split = w[layer], split[layer]
        cols = tc_gemm.im2col_plain(a, k_taps, dilation).reshape(rows, -1)
        tile_rows, shares = tc_gemm.inverse_product_plan(rows, cols.shape[1], w.shape[1], SMS)
        out = (tc_gemm.matmul_3xtf32_plain(cols, None, 32, shares, b_split=split)
               if tile_rows else cols @ w)
        return out.reshape(b, t, -1)

    x0, x1 = x[..., :c2], x[..., c2:]
    xcur = (product(x0, "W_s") + f["b_s"]) * mask
    skip = torch.zeros_like(xcur)
    for layer in range(f["W_in"].shape[0]):
        xin = product(xcur, "W_in", layer, taps, dilation_rate ** layer) + f["b_in"][layer]
        if g_all is not None:
            xin = xin + g_all[:, layer][:, None, :]
        rs = product(torch.tanh(xin[..., :h]) * torch.sigmoid(xin[..., h:]), "W_rs", layer)
        rs = rs + f["b_rs"][layer]
        xcur = (xcur + rs[..., :h]) * mask
        skip = skip + rs[..., h:]
    out = product(skip * mask, "W_e") + f["b_e"]
    z1 = (x1 - out[..., :c2]) * torch.exp(-out[..., c2:]) * mask
    return (product(torch.cat([x0, z1], -1), "A") + f["bA"]) * mask


@pytest.mark.parametrize("batch,t,g", [(1, 100, False), (1, 37, True), (2, 600, False)],
                         ids=["lone_100", "lone_37_g", "batch_2x600"])
def test_block_inverse_through_the_split_layouts_equals_plain(batch, t, g):
    rng = np.random.default_rng(1)
    folded = block_cuda.split_inverse_weights(_folded(rng))
    x = torch.from_numpy(rng.standard_normal((batch, t, 64)).astype(np.float32))
    lengths = torch.tensor([t, t // 2 + 1][:batch])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = x * mask
    g_all = (torch.from_numpy(rng.standard_normal((batch, 2, 128)).astype(np.float32))
             if g else None)
    ref = block_cuda.block_inverse_plain(folded, g_all, x, mask, 5, 2)
    got = _block_inverse_emulated(folded, g_all, x, mask, 5, 2)
    scale = ref.abs().max().item()
    assert scale > 0.1
    assert (got - ref).abs().max().item() <= 1e-5 * scale

"""The encoder layer's redesign for the tensor cores on the CPU: the merged
Q/K/V layout against the JAX package's layer kernel, and the plain
emulations of the new arithmetic against float64.

* The kernels' layout (``encoder_cuda.merge_qkv``: one [h, 3h] Q/K/V
  weight) goes through the port's forward and its hand-written backward
  (``EncoderLayerTrain``, whose CPU route is the plain version) and its
  gradients reach the JAX fold's 18 leaves through the concatenation; they
  are held against ``jax.vjp`` of ``encoder_pallas._make_layer_fn`` in
  interpret mode (pack 1), dropout off and on.  Tolerances as in
  ``test_torch_encoder_train.py``: the forward 1e-5 absolute on O(1)
  outputs, every gradient 1e-4 of its own max (f32 on both sides; the key
  bias's gradient, zero but for rounding, at the query bias's scale).
* ``tc_gemm.matmul_3xtf32_plain`` with the kernels' 32-deep slices (each
  summed alone, added in f32 in order: the attention cores' and the tensor
  cores' short chains) and with split-K's shares (added in split order by
  a second pass) against float64 within 5e-6 of the largest output, with a
  lean (the error along the sign of the reference over its mean magnitude)
  under 1e-7.
* The transposed product read from the forward's weights as they lie
  (``w_t``) against the input gradient of the forward conv.
* ``tc_gemm.text_product_plan``, the plain version of the text chains'
  dispatch (which unit, how many split-K shares), at the encoder's shapes
  and against a brute force; and the kernel route's refusal of what the
  attention core cannot take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import encoder_pallas as ep
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu_torch.ops import conv, encoder_cuda, tc_gemm

H, F, HEADS, WINDOW, TAPS = 32, 64, 2, 4, 3
SEED = 2 ** 31 - 13
BK = 4  # index of the key bias's gradient among (dx, *the JAX fold's weights)
SPLIT_RTOL = 5e-6
LEAN_RTOL = 1e-7


def _weights(rng):
    """Random non-zero weights in ``fold_encoder_layer``'s order."""
    d = H // HEADS

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    proj = [a for _ in range(4) for a in (r(H, H, scale=H ** -0.5), r(1, H, scale=0.1))]
    return (
        *proj, r(2 * WINDOW + 1, d, scale=d ** -0.5), r(2 * WINDOW + 1, d, scale=d ** -0.5),
        1.0 + r(1, H, scale=0.1), r(1, H, scale=0.1), 1.0 + r(1, H, scale=0.1), r(1, H, scale=0.1),
        r(TAPS * H, F, scale=(TAPS * H) ** -0.5), r(1, F, scale=0.1),
        r(TAPS * F, H, scale=(TAPS * F) ** -0.5), r(1, H, scale=0.1),
    )


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_merged_qkv_layer_matches_jax_kernel(p):
    """The merged layout's forward (``encoder_layer``, serving) and its
    training layer (``encoder_layer_train`` on ``merge_qkv`` of the leaves)
    against the JAX layer kernel: the output and the gradient of every JAX
    leaf, wq, bq, wk, ... included."""
    t = 19
    rng = np.random.default_rng(7)
    weights = _weights(rng)
    x = rng.standard_normal((3, t, H)).astype(np.float32)
    lengths = np.array([t, 11, 1])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    cot = rng.standard_normal(x.shape).astype(np.float32)
    threshold = np.uint32(min(round(p * 2 ** 32), 2 ** 32 - 1)) if p else None
    st = (HEADS, WINDOW, _offsets(TAPS, 1), threshold, 1.0 / (1.0 - p) if p else 1.0, 1)
    with ep.force_pack(1):
        fn = ep._make_layer_fn(ep._EncKey(st, True))
        seed = jnp.asarray([SEED], jnp.int32)
        out_j, vjp = jax.vjp(
            lambda w, xx: fn(w, xx, jnp.asarray(mask), seed),
            tuple(jnp.asarray(w) for w in weights), jnp.asarray(x),
        )
        dw_j, dx_j = vjp(jnp.asarray(cot))
    leaves = tuple(torch.from_numpy(w).requires_grad_(True) for w in weights)
    tx = torch.from_numpy(x).requires_grad_(True)
    tmask = torch.from_numpy(mask)
    merged = encoder_cuda.merge_qkv(leaves)
    assert len(merged) == 14 and merged[0].shape == (H, 3 * H) and merged[1].shape == (1, 3 * H)
    with torch.no_grad():
        served = encoder_cuda.encoder_layer(
            tuple(m.detach() for m in merged), tx.detach(), tmask, HEADS, WINDOW, p, SEED
        )
    out_t = encoder_cuda.encoder_layer_train(merged, tx, tmask, HEADS, WINDOW, p, SEED)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    assert torch.equal(served, out_t.detach())
    grads_t = torch.autograd.grad(out_t, (tx, *leaves), torch.from_numpy(cot))
    grads_j = [np.asarray(dx_j), *(np.asarray(g) for g in dw_j)]
    assert len(grads_t) == len(grads_j) == 19
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        assert gt.shape == gj.shape, i
        scale = np.abs(grads_j[2] if i == BK else gj).max()
        assert scale > 0, f"gradient {i} is zero"
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-4 * scale, err_msg=str(i))


def test_backward_returns_gradients_in_the_layout_it_was_given():
    """``encoder_layer_bwd`` on the 18-tuple returns dwq, dbq, dwk, ... the
    column blocks of what it returns for the merged 14-tuple."""
    rng = np.random.default_rng(8)
    weights = tuple(torch.from_numpy(w) for w in _weights(rng))
    x = torch.from_numpy(rng.standard_normal((2, 9, H)).astype(np.float32))
    mask = torch.ones(2, 9, 1)
    dout = torch.from_numpy(rng.standard_normal((2, 9, H)).astype(np.float32))
    g18 = encoder_cuda.encoder_layer_bwd(weights, x, mask, dout, HEADS, WINDOW)
    g14 = encoder_cuda.encoder_layer_bwd(encoder_cuda.merge_qkv(weights), x, mask, dout, HEADS, WINDOW)
    assert len(g18) == 19 and len(g14) == 15
    np.testing.assert_allclose(g18[0].numpy(), g14[0].numpy(), rtol=0, atol=1e-6)
    for i in range(3):
        np.testing.assert_allclose(g18[1 + 2 * i].numpy(), g14[1][:, i * H:(i + 1) * H].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(g18[2 + 2 * i].numpy(), g14[2][:, i * H:(i + 1) * H].numpy(),
                                   rtol=0, atol=1e-6)
    for a, b in zip(g18[7:], g14[3:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


# (rows, K, N): the encoder's products at [16, 192, .] cut to 16 x 48 rows,
# and the attention's per-head products ([t, d] x [d, t], [t, t] x [t, d])
EMULATED = {
    "ffn2": (768, 2304, 192), "ffn1": (768, 576, 768), "qkv": (768, 192, 576),
    "scores": (192, 96, 192), "p_dot_v": (192, 192, 96),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_sliced_and_split_k_3xtf32_match_float64(name, splits):
    """The kernels' short chains (32-deep slices summed alone, added in f32
    in order) and split-K's shares (added in split order): within
    SPLIT_RTOL of float64, the lean under LEAN_RTOL, and the same value
    whatever the share count but for f32 rounding of the partial sums."""
    m, k, n = EMULATED[name]
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    got = tc_gemm.matmul_3xtf32_plain(a, b, slice_k=32, splits=splits)
    err = got.double() - ref
    assert err.abs().max().item() <= SPLIT_RTOL * scale
    # the lean: the error along the sign of the reference, over its mean
    # magnitude (rounding to nearest in f32 leans neither way)
    assert abs((err * ref.sign()).mean().item() / ref.abs().mean().item()) <= LEAN_RTOL
    whole = tc_gemm.matmul_3xtf32_plain(a, b)
    assert (got - whole).abs().max().item() <= 2e-6 * scale


def test_split_k_shares_are_added_in_split_order():
    """The emulated split-K sum is the f32 sum of the shares' sums in split
    order, bit for bit: what the kernels' second pass computes."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 320)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((320, 48)).astype(np.float32))
    shares = [tc_gemm.matmul_3xtf32_plain(a[:, s], b[s], slice_k=32)
              for s in (slice(0, 128), slice(128, 256), slice(256, 320))]
    assert torch.equal(tc_gemm.matmul_3xtf32_plain(a, b, slice_k=32, splits=3),
                       shares[0] + shares[1] + shares[2])


@pytest.mark.parametrize("taps,c_in,n", [(3, 8, 12), (1, 20, 6), (5, 4, 4)])
def test_transposed_product_reads_the_forward_weights(taps, c_in, n):
    """The product with ``w_t`` (B the per-tap transpose of the forward
    conv's w [taps * c_in, n], taps at the negated offsets) is the input
    gradient of that conv: autograd of ``conv_taps``."""
    rng = np.random.default_rng(taps * 100 + c_in)
    x = torch.from_numpy(rng.standard_normal((2, 11, c_in)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((taps * c_in, n)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 11, n)).astype(np.float32))
    (dx,) = torch.autograd.grad(conv.conv_taps(x, w, torch.zeros(1, n), taps), x, dy)
    got = tc_gemm.conv_product(dy, w, taps, 1, -1, w_t=True)
    np.testing.assert_allclose(got.numpy(), dx.numpy(), rtol=0, atol=1e-5)
    assert tc_gemm.transposed_weights_plain(w, taps).shape == (taps * n, c_in)


# (rows, K, N) -> (on the tensor cores, K shares) of a text chain's product
# on 132 SMs: the encoder's products at t_x 192 and 64 (16 samples), at
# serving b=4 (1,000 rows) and at b=1 (one sentence of 250 phonemes)
TEXT_PLANS = {
    "ffn2_t192": ((3072, 2304, 192), (True, 3)),
    "ffn1_t192": ((3072, 576, 768), (True, 2)),
    "dx_t192": ((3072, 576, 192), (True, 3)),
    "qkv_t192": ((3072, 192, 576), (True, 1)),
    "out_proj_t192": ((3072, 192, 192), (True, 1)),
    "ffn2_t64": ((1024, 2304, 192), (True, 4)),
    "ffn1_t64": ((1024, 576, 768), (True, 2)),
    "out_proj_t64": ((1024, 192, 192), (False, 1)),
    "ffn2_serve_b4": ((1000, 2304, 192), (True, 4)),
    "qkv_serve_b4": ((1000, 192, 576), (True, 1)),
    "ffn1_serve_b1": ((250, 576, 768), (False, 1)),
    "ffn2_serve_b1": ((250, 2304, 192), (False, 1)),
}


@pytest.mark.parametrize("name", sorted(TEXT_PLANS))
def test_text_product_plan_splits_short_deep_products(name):
    """Split-K's count is the one of fewest waves times slices a block
    (within at most 4 shares of at least 4 slices and 1,536 partial sums a
    row), and a product takes the tensor cores where its blocks (128-row
    tiles times shares) fill a quarter of the SMs: the short, deep products
    of t_x <= 192 and serving b=4 split, the 192-deep ones do not, a lone
    sentence (b=1) is declined as before."""
    (rows, k, n), want = TEXT_PLANS[name]
    assert tc_gemm.text_product_plan(rows, k, n, 132) == want


def test_text_product_plan_takes_the_fewest_waves_times_slices():
    """Against a brute force over every share count of the same limits."""
    sms = 132
    for rows in (512, 1000, 1024, 2048, 2560, 3072):
        for k, n in ((192, 576), (576, 768), (2304, 192), (576, 192), (960, 384)):
            on, splits = tc_gemm.text_product_plan(rows, k, n, sms)
            bn = 128 if n % 128 == 0 else 64
            tiles = -(-rows // 128) * -(-n // bn)
            slices = -(-k // 32)

            def cost(s):
                per = -(-slices // s)
                return -(-tiles * -(-slices // per) // sms) * per

            allowed = [s for s in range(1, 5)
                       if s == 1 or (-(-slices // s) >= 4 and s * n <= 1536)]
            best = min(allowed, key=lambda s: (cost(s), s))
            assert splits == best, (rows, k, n)
            assert on == (4 * tiles * splits >= sms)


@pytest.mark.parametrize("case", ["head_width_12", "head_width_136", "window_17", "rel_k_unaligned"])
def test_encoder_kernel_refuses_what_its_attention_core_cannot_take(case):
    """The kernel route refuses a head width that is not a multiple of 8
    (the tensor cores' k) or above 128, a window above 16, and rel-pos
    tables that are not 16-byte aligned, with a ValueError before any
    launch (checked on CPU tensors: the checks read shapes and addresses
    only)."""
    heads, window, d = 2, WINDOW, 16
    if case.startswith("head_width"):
        d = int(case.rsplit("_", 1)[1])
    if case == "window_17":
        window = 17
    h = heads * d
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    rel_k = z(2 * window + 1, d)
    if case == "rel_k_unaligned":
        rel_k = z((2 * window + 1) * d + 1)[1:].reshape(2 * window + 1, d)
    weights = (z(h, 3 * h), z(1, 3 * h), z(h, h), z(1, h), rel_k, z(2 * window + 1, d),
               z(1, h), z(1, h), z(1, h), z(1, h), z(TAPS * h, F), z(1, F), z(TAPS * F, h), z(1, h))
    with pytest.raises(ValueError):
        encoder_cuda._check_layer(weights, z(2, 8, h), z(2, 8, 1), heads, window)
    if case == "rel_k_unaligned":  # the same tables, aligned, pass
        aligned = (*weights[:4], rel_k.clone(), *weights[5:])
        encoder_cuda._check_layer(aligned, z(2, 8, h), z(2, 8, 1), heads, window)

"""The prenet's redesign for the tensor cores on the CPU: the product plan
of its chains and the pre-masked formulation its kernels compute.

* ``tc_gemm.prenet_products``, the plain version of the prenet chains'
  dispatch: the convs on the tensor cores in 3 K shares at [16, 192, 192]
  and in 4 at serving b=4 (4 x 250 rows), declined to the CUDA cores for a
  lone sentence (b=1), its counts equal to ``text_product_plan`` product by
  product, forward and backward.
* The tensor-core conv-GEMM takes no input mask on a tap gather, so the
  kernels store every conv input masked: x * mask once, then each layer's
  output times the mask; the projection reads the masked last layer.  That
  data flow, written here in plain PyTorch, gives ``prenet_plain``'s
  output and (by autograd) ``prenet_bwd_plain``'s gradients, dropout off
  and on; and ``prenet_plain`` is held against ``jax.vjp`` of the JAX
  package's prenet kernel (``text_pallas._make_prenet_fn``, interpret
  mode) at 2 layers and h 16, dropout off.  Tolerances as in
  ``test_torch_text_train.py``: forward 1e-5 absolute on O(1) outputs,
  every gradient 1e-4 of its own max (f32, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import text_pallas as tp
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu_torch.ops import tc_gemm, text_cuda
from glow_tts_train_tpu_torch.ops.conv import conv_taps
from glow_tts_train_tpu_torch.ops.norms import layer_norm_affine
from glow_tts_train_tpu_torch.ops.wn_cuda import site_dropout

H, LAYERS, TAPS = 16, 2, 5
SEED = 2 ** 31 - 17
SMS = 132

# rows -> (takes the tensor cores, K shares) of the convs [rows, 5 * 192, 192]
PRENET_PLANS = {"train_b16_t192": (3072, (True, 3)), "serve_b4": (1000, (True, 4)),
                "serve_b1": (250, (False, 1))}


@pytest.mark.parametrize("name", sorted(PRENET_PLANS))
def test_prenet_product_plan(name):
    """The chain's convs take the tensor cores with 3 shares at the
    training shape, 4 at serving b=4 and are declined at b=1; the counts of
    a forward and a backward chain are ``text_product_plan``'s, product by
    product (3 convs and the projection; the backward recomputes them and
    adds as many transposed products and 4 weight gradients, on the tensor
    cores from 256 rows)."""
    rows, want = PRENET_PLANS[name]
    h, n_layers, taps = 192, 3, 5
    assert tc_gemm.text_product_plan(rows, taps * h, h, SMS) == want
    plans = [tc_gemm.text_product_plan(rows, k, h, SMS)[0] for k in [taps * h] * n_layers + [h]]
    for forward, backward in ((1, 0), (0, 1), (1, 1)):
        got = tc_gemm.prenet_products(rows, h, n_layers, taps, SMS, forward, backward)
        chains = forward + 2 * backward
        on = sum(plans)
        assert got["tc_gemm"] == chains * on
        assert got["core_gemm"] == got["declined_gemm"] == chains * (len(plans) - on)
        wgrads = (n_layers + 1) * backward  # on the tensor cores from 256 rows
        assert got["tc_wgrad"] == (wgrads if rows >= 256 else 0)
        assert got["core_wgrad"] == got["declined_wgrad"] == (0 if rows >= 256 else wgrads)
    if name == "serve_b4":  # the 192-deep projection: 24 blocks, declined
        assert plans == [True, True, True, False]
    if name == "serve_b1":
        assert tc_gemm.prenet_products(rows, h, n_layers, taps, SMS, 1, 0)["tc_gemm"] == 0


def _weights(rng, n_layers=LAYERS, h=H, taps=TAPS):
    """Random non-zero weights in the fold's layout (the projection too: at
    its zero init every conv gradient would be zero)."""
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return (
        r(n_layers, taps * h, h, scale=(taps * h) ** -0.5), r(n_layers, h, scale=0.1),
        1.0 + r(n_layers, h, scale=0.1), r(n_layers, h, scale=0.1),
        r(h, h, scale=h ** -0.5), r(1, h, scale=0.1),
    )


def _inputs(rng, t, h=H):
    """x [3, t, h] and a ragged 0/1 mask [3, t, 1] (lengths t, t/2 + 1, 1)."""
    x = torch.from_numpy(rng.standard_normal((3, t, h)).astype(np.float32))
    lengths = torch.tensor([t, t // 2 + 1, 1])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    return x, mask


def prenet_premasked(weights, x, mask, p_dropout=0.0, seed=0):
    """The kernels' data flow: x * mask once, each layer's output stored
    times the mask, no mask on the conv's gather, the projection from the
    masked last layer."""
    w, b, gamma, beta, wp, bp = weights
    n_layers, taps = w.shape[0], w.shape[1] // x.shape[-1]
    curm = x * mask
    for l in range(n_layers):
        y = layer_norm_affine(conv_taps(curm, w[l], b[l], taps), gamma[l], beta[l])
        curm = site_dropout(torch.relu(y), seed, l, n_layers, p_dropout) * mask
    return (x + curm @ wp + bp) * mask


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_premasked_prenet_equals_plain(p):
    """Output and every gradient of the pre-masked formulation against
    ``prenet_plain`` and ``prenet_bwd_plain`` with the same keep masks."""
    rng = np.random.default_rng(5)
    weights = _weights(rng, n_layers=3)
    x, mask = _inputs(rng, 23)
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    ref_out = text_cuda.prenet_plain(weights, x, mask, p, seed=SEED)
    out = prenet_premasked(weights, x, mask, p, SEED)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=0, atol=1e-5)
    ref = text_cuda.prenet_bwd_plain(weights, x, mask, dout, p, SEED)
    got = text_cuda.plain_grads(
        lambda w, xx: prenet_premasked(w, xx, mask, p, SEED), weights, x, dout
    )
    assert len(got) == len(ref) == 7
    for i, (g, r) in enumerate(zip(got, ref)):
        assert r.abs().max() > 0, f"gradient {i} is zero: the test would pass on a missing term"
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-4 * r.abs().max().item(), err_msg=str(i))


def test_prenet_plain_and_premasked_match_jax_prenet_vjp():
    """``prenet_plain`` and the pre-masked formulation, output and every
    gradient by autograd, against ``jax.vjp`` of the JAX prenet kernel in
    interpret mode, 2 layers, h 16, dropout off."""
    rng = np.random.default_rng(6)
    weights = _weights(rng)
    x, mask = _inputs(rng, 19)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    fn = tp._make_prenet_fn(tp._TextKey((LAYERS, _offsets(TAPS, 1), None, 1.0), True))
    out_j, vjp = jax.vjp(
        lambda w, xx: fn(w, xx, jnp.asarray(mask.numpy()), jnp.asarray([SEED], jnp.int32)),
        tuple(jnp.asarray(w.numpy()) for w in weights), jnp.asarray(x.numpy()),
    )
    dweights, dx = vjp(jnp.asarray(dout))
    cot = torch.from_numpy(dout)
    for name, apply in (("plain", lambda w, xx: text_cuda.prenet_plain(w, xx, mask)),
                        ("pre-masked", lambda w, xx: prenet_premasked(w, xx, mask))):
        out = apply(weights, x)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=1e-5,
                                   err_msg=name)
        got = text_cuda.plain_grads(apply, weights, x, cot)
        for i, (g, r) in enumerate(zip(got, [dx, *dweights])):
            r = np.asarray(r)
            assert g.shape == r.shape, (name, i)
            assert np.abs(r).max() > 0, f"gradient {i} is zero: the test would pass on a missing term"
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max(),
                                       err_msg=f"{name} {i}")

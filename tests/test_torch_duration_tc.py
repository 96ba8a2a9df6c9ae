"""The duration stack's redesign for the tensor cores on the CPU: the
product plan of its chains and the pre-masked formulation its kernels
compute.

* ``tc_gemm.duration_products``, the plain version of the duration
  chains' dispatch (``text_product_plan``): both convs on the tensor cores
  at the training shape [16, 192] and at serving b=4 (4 x 250 rows),
  declined to the CUDA cores for a lone sentence (b=1); with a speaker
  input (gin 16) the same; counts product by product, forward and
  backward.
* The tensor-core conv-GEMM takes no input mask on a tap gather, so the
  kernels store every conv input masked: x * mask once, then layer 0's
  output (after its dropout) times the mask, which is layer 1's conv
  input; the ReLU gates come from the unmasked ReLU outputs.  That data
  flow, written here in plain PyTorch, gives ``duration_stack_plain``'s
  output and (by autograd) ``duration_stack_bwd_plain``'s gradients,
  dropout off and on; both are held against ``jax.vjp`` of the JAX
  package's duration kernel (``text_pallas._make_dp_fn``, interpret mode)
  at h 16, f 16, gin 0 and 8.  Tolerances as in
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

H, F, TAPS = 16, 16, 3
SEED = 2 ** 31 - 23
SMS = 132

# (rows, gin) -> (layer 0's conv, layer 1's conv, the transposed convs of
# layers 0 and 1) as (takes the tensor cores, K shares), at h 192, f 256
DURATION_PLANS = {
    "train_b16_t192": (3072, 0, [(True, 2), (True, 2), (True, 3), (True, 2)]),
    "train_b16_t192_gin16": (3072, 16, [(True, 2), (True, 2), (True, 4), (True, 2)]),
    "serve_b4": (1000, 0, [(True, 4), (True, 4), (True, 4), (True, 4)]),
    "serve_b1": (250, 0, [(False, 1), (False, 1), (False, 1), (False, 1)]),
    "serve_b1_gin16": (250, 16, [(False, 1), (False, 1), (False, 1), (False, 1)]),
}


@pytest.mark.parametrize("name", sorted(DURATION_PLANS))
def test_duration_product_plan(name):
    """The convs [rows, 3 (192 + gin), 256] and [rows, 768, 256] and the
    backward's transposed convs [rows, 768, 192 + gin] and [rows, 768, 256]
    take the tensor cores in K shares at the training shape and at serving
    b=4, and are declined at b=1; a forward chain makes the two convs, a
    backward chain the two again (its recompute), the two transposed convs
    and two weight gradients (on the tensor cores from 256 rows)."""
    rows, gin, want = DURATION_PLANS[name]
    c, f, taps = 192 + gin, 256, 3
    shapes = [(taps * c, f), (taps * f, f), (taps * f, c), (taps * f, f)]
    plans = [tc_gemm.text_product_plan(rows, k, n, SMS) for k, n in shapes]
    assert plans == want
    on = [p[0] for p in plans]
    for forward, backward in ((1, 0), (0, 1), (1, 1)):
        got = tc_gemm.duration_products(rows, c, f, taps, SMS, forward, backward)
        want_tc = (forward + backward) * sum(on[:2]) + backward * sum(on[2:])
        assert got["tc_gemm"] == want_tc
        assert got["core_gemm"] == got["declined_gemm"] == (
            2 * (forward + backward) + 2 * backward - want_tc)
        assert got["tc_wgrad"] == (2 * backward if rows >= 256 else 0)
        assert got["core_wgrad"] == got["declined_wgrad"] == (0 if rows >= 256 else 2 * backward)


def _weights(rng, c_in):
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return (
        r(TAPS * c_in, F, scale=(TAPS * c_in) ** -0.5), r(1, F, scale=0.1),
        1.0 + r(1, F, scale=0.1), r(1, F, scale=0.1),
        r(TAPS * F, F, scale=(TAPS * F) ** -0.5), r(1, F, scale=0.1),
        1.0 + r(1, F, scale=0.1), r(1, F, scale=0.1),
    )


def _inputs(rng, t, c_in):
    """x [3, t, c_in] and a ragged 0/1 mask [3, t, 1] (lengths t, t/2 + 1, 1)."""
    x = torch.from_numpy(rng.standard_normal((3, t, c_in)).astype(np.float32))
    lengths = torch.tensor([t, t // 2 + 1, 1])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    return x, mask


def duration_premasked(weights, x, mask, p_dropout=0.0, seed=0):
    """The kernels' data flow: x * mask once, no mask on the convs' gather,
    layer 0's output stored times the mask as layer 1's input, layer 1's
    output as it is."""
    w1, b1, g1, be1, w2, b2, g2, be2 = weights
    cur = x * mask
    for l, (w, b, g, be) in enumerate(((w1, b1, g1, be1), (w2, b2, g2, be2))):
        y = layer_norm_affine(torch.relu(conv_taps(cur, w, b, TAPS)), g, be)
        cur = site_dropout(y, seed, l, 2, p_dropout)
        if l == 0:
            cur = cur * mask
    return cur


@pytest.mark.parametrize("gin", [0, 8])
@pytest.mark.parametrize("p", [0.0, 0.4])
def test_premasked_duration_stack_equals_plain_and_jax(p, gin):
    """Output and every gradient of the pre-masked formulation and of
    ``duration_stack_plain`` (autograd: ``duration_stack_bwd_plain``) with
    the same keep masks, each against ``jax.vjp`` of the JAX duration
    kernel in interpret mode."""
    rng = np.random.default_rng(7 + gin)
    weights = _weights(rng, H + gin)
    x, mask = _inputs(rng, 13, H + gin)
    dout = rng.standard_normal((3, 13, F)).astype(np.float32)
    threshold = np.uint32(min(round(p * 2 ** 32), 2 ** 32 - 1)) if p else None
    key = tp._TextKey((2, _offsets(TAPS, 1), threshold, 1.0 / (1.0 - p) if p else 1.0), True)
    fn = tp._make_dp_fn(key)
    out_j, vjp = jax.vjp(
        lambda w, xx: fn(w, xx, jnp.asarray(mask.numpy()), jnp.asarray([SEED], jnp.int32)),
        tuple(jnp.asarray(w.numpy()) for w in weights), jnp.asarray(x.numpy()),
    )
    dweights, dx = vjp(jnp.asarray(dout))
    ref = [np.asarray(g) for g in (dx, *dweights)]
    cot = torch.from_numpy(dout)
    plain_bwd = text_cuda.duration_stack_bwd_plain(weights, x, mask, cot, p, SEED)
    for name, apply in (
        ("plain", lambda w, xx: text_cuda.duration_stack_plain(w, xx, mask, p, seed=SEED)),
        ("pre-masked", lambda w, xx: duration_premasked(w, xx, mask, p, SEED)),
    ):
        out = apply(weights, x)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-5,
                                   err_msg=name)
        got = text_cuda.plain_grads(apply, weights, x, cot)
        assert len(got) == len(ref) == 9
        for i, (g, r, gp) in enumerate(zip(got, ref, plain_bwd)):
            assert g.shape == r.shape, (name, i)
            assert np.abs(r).max() > 0, f"gradient {i} is zero: the test would pass on a missing term"
            atol = 1e-4 * np.abs(r).max()
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol, err_msg=f"{name} {i}")
            np.testing.assert_allclose(g.numpy(), gp.numpy(), rtol=0, atol=atol,
                                       err_msg=f"{name} {i} vs duration_stack_bwd_plain")

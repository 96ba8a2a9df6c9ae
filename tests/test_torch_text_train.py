"""The training prenet and duration stack of glow_tts_train_tpu_torch on
the CPU against the JAX package's Pallas kernels in interpret mode.

The same numpy-seeded weights, inputs and cotangents go through the JAX
custom-VJP kernel functions (``text_pallas._make_prenet_fn`` /
``_make_dp_fn`` with ``interpret=True`` and an explicit seed) and through
the port's ``torch.autograd.Function``s (``PrenetTrain``,
``DurationStackTrain``), whose CPU route is the plain version of each
kernel.  Dropout uses the kernels' portable counter hash, so the keep
masks are equal bit for bit and outputs and gradients compare elementwise.

Tolerances: forward 1e-5 absolute on O(1) outputs, every gradient 1e-4 of
its own max magnitude (f32 on both sides, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import encoder_pallas as ep
from glow_tts_train_tpu.ops import text_pallas as tp
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu_torch.ops import text_cuda, wn_cuda

H, F_DP = 32, 64
SEED = 2 ** 31 - 11  # near the int32 edge: seed + sample wraps as in the kernel


def _threshold(p):
    return np.uint32(min(round(p * 2 ** 32), 2 ** 32 - 1))


def _inputs(t, width, seed=0):
    """x [3, t, width], a ragged 0/1 mask [3, t, 1] (lengths t, about t/2
    and 1) and the mask's lengths."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, t, width)).astype(np.float32)
    lengths = np.array([t, max(1, t // 2 + 1), 1])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x, mask


@pytest.mark.parametrize("shape", [(17, 17), (24, 32), (17, 64)], ids=["t_t", "t_h", "t_f"])
@pytest.mark.parametrize("p", [0.4, 0.5])
def test_site_keep_masks_match_jax_bit_for_bit(shape, p):
    """``regen_keep`` in its site form against ``encoder_pallas._drop_keep``
    in interpret mode, at the three tensor shapes of the text kernels, for
    every site of a 5-site kernel and samples whose seed wraps int32."""
    n_sites = 5
    for sample in range(3):
        for site in range(n_sites):
            st = {"seed": jnp.int32(SEED) + jnp.int32(sample), "n_sites": n_sites,
                  "drop_threshold": _threshold(p), "interpret": True}
            ref = np.asarray(ep._drop_keep(site, shape, st))
            port = wn_cuda.regen_keep(SEED + sample, site, n_sites, shape, p)
            np.testing.assert_array_equal(port.numpy(), ref)
            assert 0.2 < ref.mean() < 0.8
    batched = wn_cuda.regen_keep(SEED + torch.arange(3), 2, n_sites, shape, p)
    np.testing.assert_array_equal(
        batched[1].numpy(), wn_cuda.regen_keep(SEED + 1, 2, n_sites, shape, p).numpy()
    )


def _prenet_weights(rng, n_layers=3, taps=5):
    """Random non-zero kernel weights in the fold's layout (the projection
    too: at its zero init every conv gradient would be zero)."""
    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (
        r(n_layers, taps * H, H, scale=(taps * H) ** -0.5), r(n_layers, H, scale=0.1),
        1.0 + r(n_layers, H, scale=0.1), r(n_layers, H, scale=0.1),
        r(H, H, scale=H ** -0.5), r(1, H, scale=0.1),
    )


def _dp_weights(rng, c_in, taps=3):
    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (
        r(taps * c_in, F_DP, scale=(taps * c_in) ** -0.5), r(1, F_DP, scale=0.1),
        1.0 + r(1, F_DP, scale=0.1), r(1, F_DP, scale=0.1),
        r(taps * F_DP, F_DP, scale=(taps * F_DP) ** -0.5), r(1, F_DP, scale=0.1),
        1.0 + r(1, F_DP, scale=0.1), r(1, F_DP, scale=0.1),
    )


def _jax_vjp(fn, weights, x, mask, seed, cot):
    seed_f = jnp.asarray([seed], jnp.int32)
    out, vjp = jax.vjp(
        lambda w, xx: fn(w, xx, jnp.asarray(mask), seed_f),
        tuple(jnp.asarray(w) for w in weights), jnp.asarray(x),
    )
    dweights, dx = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dx), [np.asarray(g) for g in dweights]


def _torch_vjp(apply, weights, x, mask, cot):
    tw = tuple(torch.from_numpy(w).requires_grad_(True) for w in weights)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = apply(tw, tx, torch.from_numpy(mask))
    grads = torch.autograd.grad(out, (tx, *tw), torch.from_numpy(cot))
    return out.detach().numpy(), grads[0].numpy(), [g.numpy() for g in grads[1:]]


def _compare(jax_result, torch_result):
    out_j, dx_j, dw_j = jax_result
    out_t, dx_t, dw_t = torch_result
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    assert len(dw_j) == len(dw_t)
    for i, (gt, gj) in enumerate(zip([dx_t, *dw_t], [dx_j, *dw_j])):
        assert gt.shape == gj.shape, i
        assert np.abs(gj).max() > 0, f"gradient {i} is zero: the test would pass on a missing term"
        np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * np.abs(gj).max(), err_msg=str(i))


@pytest.mark.parametrize("t", [17, 24])
@pytest.mark.parametrize("p", [0.0, 0.5])
def test_prenet_train_matches_jax_kernel(t, p):
    """Forward, dx and dW, db, dgamma, dbeta, dWp, dbp of ``PrenetTrain``
    against ``jax.vjp`` of the JAX prenet kernel (interpret mode)."""
    rng = np.random.default_rng(1)
    weights = _prenet_weights(rng)
    x, mask = _inputs(t, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    st = (3, _offsets(5, 1), _threshold(p) if p else None, 1.0 / (1.0 - p) if p else 1.0)
    fn = tp._make_prenet_fn(tp._TextKey(st, True))
    _compare(
        _jax_vjp(fn, weights, x, mask, SEED, cot),
        _torch_vjp(lambda w, xx, m: text_cuda.prenet_train(w, xx, m, p, SEED), weights, x, mask, cot),
    )


@pytest.mark.parametrize("t,gin", [(17, 0), (24, 8)])
@pytest.mark.parametrize("p", [0.0, 0.4])
def test_duration_stack_train_matches_jax_kernel(t, gin, p):
    """Forward, dx (the speaker half included) and the 8 weight gradients
    of ``DurationStackTrain`` against ``jax.vjp`` of the JAX kernel."""
    rng = np.random.default_rng(2)
    weights = _dp_weights(rng, H + gin)
    x, mask = _inputs(t, H + gin)
    cot = rng.standard_normal((3, t, F_DP)).astype(np.float32)
    st = (2, _offsets(3, 1), _threshold(p) if p else None, 1.0 / (1.0 - p) if p else 1.0)
    fn = tp._make_dp_fn(tp._TextKey(st, True))
    _compare(
        _jax_vjp(fn, weights, x, mask, SEED, cot),
        _torch_vjp(lambda w, xx, m: text_cuda.duration_stack_train(w, xx, m, p, SEED),
                   weights, x, mask, cot),
    )


def test_bwd_wrappers_match_their_functions():
    """``prenet_bwd`` / ``duration_stack_bwd`` (what the Functions call)
    return (dx, *dweights) shaped as their primals, equal to autograd of
    the plain versions with the same seed; another seed gives other masks."""
    rng = np.random.default_rng(3)
    x, mask = (torch.from_numpy(a) for a in _inputs(17, H))
    for weights, bwd, plain, width in (
        (_prenet_weights(rng), text_cuda.prenet_bwd, text_cuda.prenet_plain, H),
        (_dp_weights(rng, H), text_cuda.duration_stack_bwd, text_cuda.duration_stack_plain, F_DP),
    ):
        tw = tuple(torch.from_numpy(w) for w in weights)
        dout = torch.from_numpy(rng.standard_normal((3, 17, width)).astype(np.float32))
        grads = bwd(tw, x, mask, dout, 0.5, 7)
        assert [g.shape for g in grads] == [x.shape, *(w.shape for w in tw)]
        leaves = [a.clone().requires_grad_(True) for a in (x, *tw)]
        ref = torch.autograd.grad(
            plain(tuple(leaves[1:]), leaves[0], mask, 0.5, seed=7), leaves, dout
        )
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-6)
        other = bwd(tw, x, mask, dout, 0.5, 8)
        assert (other[0] - grads[0]).abs().max() > 0

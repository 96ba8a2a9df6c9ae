"""The training encoder layer of glow_tts_train_tpu_torch on the CPU
against the JAX package's Pallas kernel in interpret mode, and the fused
text side inside the encoder stack and the training graph.

The same numpy-seeded weights, inputs and cotangents go through the JAX
custom-VJP layer function (``encoder_pallas._make_layer_fn`` with
``interpret=True``, an explicit seed and ``force_pack(1)``: the port is the
kernel's one-sample-per-step site numbering) and through the port's
``EncoderLayerTrain``, whose CPU route is the kernel's plain version.
Dropout uses the kernels' portable counter hash at the H + 3 sites, so the
keep masks are equal bit for bit.

Tolerances: forward 1e-5 absolute on O(1) outputs, every gradient 1e-4 of
its own max magnitude (f32 on both sides, summation order only).  The key
bias's gradient is zero but for rounding (a row's scores all shift alike)
and is held to the query bias's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.ops import encoder_pallas as ep
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu_torch import checkpoint
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import attention, encoder_cuda
from glow_tts_train_tpu_torch.tree import tree_index

from helpers import tiny_config

H, F, HEADS, WINDOW, TAPS = 32, 64, 2, 4, 3
SEED = 2 ** 31 - 11
BK = 4  # index of the key bias's gradient among (dx, *dweights)


def _threshold(p):
    return np.uint32(min(round(p * 2 ** 32), 2 ** 32 - 1))


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, t, H)).astype(np.float32)
    lengths = np.array([t, max(1, t // 2 + 1), 1])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x, mask


def _layer_weights(rng):
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


@pytest.mark.parametrize("t", [17, 24])
@pytest.mark.parametrize("p", [0.0, 0.4])
def test_encoder_layer_train_matches_jax_kernel(t, p):
    """Forward, dx and all 18 weight gradients of ``EncoderLayerTrain``
    against ``jax.vjp`` of the JAX layer kernel (interpret mode, pack 1),
    with a fully padded tail (a sample of length 1)."""
    rng = np.random.default_rng(1)
    weights = _layer_weights(rng)
    x, mask = _inputs(t)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    st = (HEADS, WINDOW, _offsets(TAPS, 1), _threshold(p) if p else None,
          1.0 / (1.0 - p) if p else 1.0, 1)
    with ep.force_pack(1):
        fn = ep._make_layer_fn(ep._EncKey(st, True))
        seed_f = jnp.asarray([SEED], jnp.int32)
        out_j, vjp = jax.vjp(
            lambda w, xx: fn(w, xx, jnp.asarray(mask), seed_f),
            tuple(jnp.asarray(w) for w in weights), jnp.asarray(x),
        )
        dw_j, dx_j = vjp(jnp.asarray(cot))
    tw = tuple(torch.from_numpy(w).requires_grad_(True) for w in weights)
    tx = torch.from_numpy(x).requires_grad_(True)
    out_t = encoder_cuda.encoder_layer_train(tw, tx, torch.from_numpy(mask), HEADS, WINDOW, p, SEED)
    grads_t = torch.autograd.grad(out_t, (tx, *tw), torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    grads_j = [np.asarray(dx_j), *(np.asarray(g) for g in dw_j)]
    assert len(grads_t) == len(grads_j) == 19
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        assert gt.shape == gj.shape, i
        scale = np.abs(grads_j[2] if i == BK else gj).max()
        assert scale > 0, f"gradient {i} is zero"
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-4 * scale, err_msg=str(i))


def test_dropout_changes_every_site_and_replays():
    """With p > 0 the output differs from the deterministic one, another
    seed differs again, and the same seed repeats bit for bit; the plain
    version's attention keeps the softmax of the undropped scores (rows of
    the dropped probabilities no longer sum to 1)."""
    rng = np.random.default_rng(2)
    tw = tuple(torch.from_numpy(w) for w in _layer_weights(rng))
    x, mask = (torch.from_numpy(a) for a in _inputs(17))
    run = lambda p, seed: encoder_cuda.encoder_layer_plain(tw, x, mask, HEADS, WINDOW, p, seed)
    base, a, a2, b = run(0.0, 0), run(0.4, 5), run(0.4, 5), run(0.4, 6)
    assert torch.equal(a, a2)
    assert (a - base).abs().max() > 1e-3 and (a - b).abs().max() > 1e-3


def _raw_layers(hp, seed=3):
    params = checkpoint.params_from_numpy(checkpoint.random_params(hp, seed), hp).tree()
    return [tree_index(params["encoder"], i) for i in range(hp.n_layers_enc)]


def test_encoder_apply_fused_matches_op_by_op_and_reaches_raw_params():
    """``encoder_apply(fused=True)`` without dropout equals the op-by-op
    stack, and its gradients reach the raw (unfolded) layer params through
    the folds; a configuration the kernel does not take runs op by op."""
    hp = model.hyper_from_config(tiny_config())
    x, mask = _inputs(13)
    x, mask = torch.from_numpy(x[:, :, : hp.h_enc].copy()), torch.from_numpy(mask)
    results = []
    for fused in (True, False):
        layers = [
            {k: {kk: vv.clone().requires_grad_(True) if not isinstance(vv, dict) else
                 {k3: v3.clone().requires_grad_(True) for k3, v3 in vv.items()}
                 for kk, vv in v.items()} for k, v in layer.items()}
            for layer in _raw_layers(hp)
        ]
        out = attention.encoder_apply(layers, x, mask, hp.n_heads, hp.window_size, fused=fused)
        leaves = [layers[0]["attn"]["q"]["w"], layers[1]["ffn"]["conv_2"]["w"],
                  layers[0]["attn"]["emb_rel_v"], layers[1]["norm_2"]["gamma"]]
        results.append((out, torch.autograd.grad((out * out).sum(), leaves)))
    (out_f, g_f), (out_p, g_p) = results
    np.testing.assert_allclose(out_f.detach().numpy(), out_p.detach().numpy(), rtol=0, atol=1e-5)
    for a, b in zip(g_f, g_p):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4 * b.abs().max().item())
    out_w = attention.encoder_apply(_raw_layers(hp), x, mask, hp.n_heads, hp.window_size,
                                    block_length=3, fused=True)
    out_o = attention.encoder_apply(_raw_layers(hp), x, mask, hp.n_heads, hp.window_size,
                                    block_length=3, fused=False)
    assert torch.equal(out_w, out_o)


def test_fused_seeds_are_drawn_per_stack_and_layer():
    """With dropout on the fused text side draws one seed for the prenet,
    one per encoder layer and one for the duration stack from the CPU seed
    generator, in that order; no generator means no dropout."""
    config = tiny_config(p_dropout=0.3)
    hp = model.hyper_from_config(config)
    assert hp.encoder_fuse
    params = checkpoint.params_from_numpy(checkpoint.random_params(hp, 3), hp).tree()
    x = torch.tensor([[3, 7, 12, 5, 9], [4, 2, 8, 0, 0]])
    xl = torch.tensor([5, 3])
    run = lambda gen: model.encoder_forward_train(params, hp, x, xl, seed_generator=gen)
    a = run(torch.Generator().manual_seed(1))
    a2 = run(torch.Generator().manual_seed(1))
    b = run(torch.Generator().manual_seed(2))
    det = run(None)
    assert torch.equal(a[0], a2[0]) and torch.equal(a[2], a2[2])
    assert (a[0] - b[0]).abs().max() > 1e-4 and (a[0] - det[0]).abs().max() > 1e-4
    gen = torch.Generator().manual_seed(1)
    run(gen)
    used = torch.Generator().manual_seed(1)
    for _ in range(1 + hp.n_layers_enc + 1):
        torch.randint(0, 2 ** 31 - 1, (), generator=used)
    assert torch.equal(gen.get_state(), used.get_state())
    # without the fused kernels the same call draws from `generator` instead
    plain = model.encoder_forward_train(params, hp._replace(encoder_fuse=False), x, xl)
    np.testing.assert_allclose(plain[0].numpy(), det[0].numpy(), rtol=0, atol=1e-5)


def test_forward_train_fused_matches_jax_forward_train():
    """The training graph with ``encoder_fuse`` true against the JAX
    package's (its text kernels in interpret mode), deterministic: the text
    statistics, durations and MAS path."""
    config = tiny_config(p_dropout=0.0, p_dropout_dec=0.0)
    config.encoder_fuse = True
    hp = model.hyper_from_config(config)
    jhp = jax_model.hyper_from_config(config)
    assert hp.encoder_fuse and jhp.encoder_fuse
    flat = checkpoint.random_params(hp, 5)
    tparams = checkpoint.params_from_numpy(flat, hp).tree()
    jparams: dict = {}
    for key, a in flat.items():
        *parents, leaf = key[len("model/"):].split("/")
        node = jparams
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    rng = np.random.default_rng(6)
    x = rng.integers(1, hp.n_vocab, size=(3, 11)).astype(np.int32)
    xl = np.array([11, 6, 9], np.int32)
    x[1, 6:] = 0
    x[2, 9:] = 0
    y = rng.standard_normal((3, 40, hp.out_channels)).astype(np.float32)
    yl = np.array([40, 26, 34], np.int32)
    jout = jax_model.forward_train(jparams, jhp, x, xl, y, yl, mas_impl="scan")
    with torch.no_grad():
        tout = model.forward_train(
            tparams, hp, torch.from_numpy(x).long(), torch.from_numpy(xl).long(),
            torch.from_numpy(y), torch.from_numpy(yl).long(),
        )
    np.testing.assert_array_equal(tout[2][0].numpy(), np.asarray(jout[2][0]))
    np.testing.assert_allclose(tout[1][0].numpy(), np.asarray(jout[1][0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout[2][1].numpy(), np.asarray(jout[2][1]), rtol=0, atol=1e-4)

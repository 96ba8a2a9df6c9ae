"""The serving slice of glow_tts_train_tpu_torch against the JAX package:
the weight bridge, forward_gen end to end, and the op-by-op ops.

Every test checkpoint has random non-zero weights
(checkpoint.random_params) and goes through the JAX package's own
``.npz`` loader on one side and the port's on the other.  The port runs
its plain PyTorch versions (CPU tensors); JAX runs its plain XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.ops import attention as jax_attention
from glow_tts_train_tpu.ops import conv as jax_conv
from glow_tts_train_tpu.ops import flows as jax_flows
from glow_tts_train_tpu.ops import masks as jax_masks
from glow_tts_train_tpu.ops import norms as jax_norms
from glow_tts_train_tpu_torch import checkpoint
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import attention, block_cuda, conv, flows, masks, norms, text_cuda
from glow_tts_train_tpu_torch.tree import tree_index

from helpers import tiny_config

CONFIGS = {
    "base": {},
    "mean_only_false": {"mean_only": False},
    "multispeaker": {"n_speakers": 3, "gin_channels": 8},
    "no_prenet": {"prenet": False},
    "no_window": {"window_size": None},  # op-by-op encoder on the CPU
}


def _checkpoint(tmp_path, over, seed=0):
    """One random checkpoint -> (config, JAX params, port model, hp)."""
    config = tiny_config(**over)
    hp = model.hyper_from_config(config)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, checkpoint.random_params(hp, seed))
    jparams = jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    tmodel, _ = checkpoint.load_checkpoint(path, hp)
    return config, jparams, tmodel, hp


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_shapes_match_jax_init(name):
    config = tiny_config(**CONFIGS[name])
    params = jax_model.init_model(jax.random.PRNGKey(0), jax_model.hyper_from_config(config))
    jax_shapes = {k: v.shape for k, v in jax_checkpoint._flatten(params, "model/").items()}
    assert checkpoint.param_shapes(model.hyper_from_config(config)) == jax_shapes


def test_bridge_copies_key_for_key(tmp_path):
    _, jparams, tmodel, hp = _checkpoint(tmp_path, {})
    flat = jax_checkpoint._flatten(jparams, "model/")
    named = dict(tmodel.named_parameters())
    assert len(named) == len(flat)
    for key, a in flat.items():
        p = named[key[len("model/"):].replace("/", ".")]
        np.testing.assert_array_equal(p.detach().numpy(), a)
    assert named["encoder.attn.q.w"].shape == (hp.n_layers_enc, 1, hp.h_enc, hp.h_enc)


def test_bridge_is_strict():
    hp = model.hyper_from_config(tiny_config())
    flat = checkpoint.random_params(hp, 0)
    checkpoint.params_from_numpy(flat, hp)
    dropped = dict(flat)
    del dropped["model/decoder/blocks/coupling/end/w"]
    with pytest.raises(ValueError, match="missing"):
        checkpoint.params_from_numpy(dropped, hp)
    with pytest.raises(ValueError, match="unexpected"):
        checkpoint.params_from_numpy(dict(flat, **{"model/extra/w": np.zeros(3)}), hp)
    bad = dict(flat, **{"model/emb": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="model/emb"):
        checkpoint.params_from_numpy(bad, hp)


# ---------------------------------------------------------------------------
# forward_gen, the slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_gen_matches_jax(tmp_path, name):
    """Same checkpoint, ids and noise (``eps`` drawn by jax.random and
    handed to the port).  Tolerances: 1e-5 on the encoder outputs, 1e-4 on
    the mel (f32 on the CPU; the inverse flow scales by exp(-logs) per
    block); y_lengths identical."""
    config, jparams, tmodel, hp = _checkpoint(tmp_path, CONFIGS[name])
    jhp = jax_model.hyper_from_config(config)
    weights = model.store_inverse(tmodel, hp)
    rng = np.random.default_rng(1)
    b, t_x, y_max = 3, 11, 72
    x = rng.integers(1, config.model.num_symbols, size=(b, t_x))
    x_lengths = np.array([11, 6, 9])
    for i in range(b):
        x[i, x_lengths[i]:] = 0
    g_ids = np.array([0, 2, 1]) if hp.n_speakers > 1 else None
    noise = jax.random.PRNGKey(7)
    t_y = (y_max // hp.n_sqz) * hp.n_sqz
    eps = jax.random.normal(noise, (b, t_y, hp.out_channels))

    out_j = jax_model.forward_gen(
        jax_model.store_inverse(jparams), jhp, jnp.asarray(x, jnp.int32),
        jnp.asarray(x_lengths, jnp.int32), y_max, noise, noise_scale=0.667,
        length_scale=1.1, g_ids=None if g_ids is None else jnp.asarray(g_ids, jnp.int32),
    )
    out_t = model.forward_gen(
        weights, hp, _t(x), _t(x_lengths), y_max, noise_scale=0.667, length_scale=1.1,
        g_ids=None if g_ids is None else _t(g_ids), eps=_t(eps),
    )
    # a duration within 1e-4 of an integer could ceil differently
    w = np.exp(np.asarray(out_j[2][1]))[:, :, 0] * 1.1
    valid = np.arange(t_x)[None] < x_lengths[:, None]
    frac = np.abs(w - np.round(w))[valid]
    assert frac.min() > 1e-4, "seed puts a duration at an integer; pick another"

    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(out_t[2][0].numpy(), np.asarray(out_j[2][0]))
    for port, ref, atol in (
        (out_t[1][0], out_j[1][0], 1e-5),  # x_m
        (out_t[1][1], out_j[1][1], 1e-5),  # x_logs
        (out_t[2][1], out_j[2][1], 1e-5),  # logw
        (out_t[0][0], out_j[0][0], 1e-4),  # mel
    ):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=atol)
    assert np.abs(out_t[0][0].numpy()).max() > 0.1  # the mel is not trivially small


def test_forward_gen_draws_noise_from_generator(tmp_path):
    _, _, tmodel, hp = _checkpoint(tmp_path, {})
    weights = model.store_inverse(tmodel, hp)
    x = torch.tensor([[3, 7, 12, 5, 9]])
    xl = torch.tensor([5])

    def mel(seed):
        gen = torch.Generator().manual_seed(seed)
        return model.forward_gen(weights, hp, x, xl, 40, noise_scale=0.5, generator=gen)[0][0]

    torch.testing.assert_close(mel(1), mel(1), rtol=0, atol=0)
    assert (mel(1) - mel(2)).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# op-by-op ops
# ---------------------------------------------------------------------------


def test_masks_match_jax():
    lengths = np.array([5, 1, 7])
    np.testing.assert_array_equal(
        masks.time_mask(_t(lengths), 7).numpy(),
        np.asarray(jax_masks.time_mask(jnp.asarray(lengths), 7)),
    )
    dur = np.array([[2.0, 0.0, 3.0, 1.0], [1.0, 4.0, 0.0, 0.0]], np.float32)
    mask = np.ones((2, 4, 9), np.float32)
    mask[1, 2:] = 0.0
    np.testing.assert_array_equal(
        masks.generate_path(_t(dur), _t(mask)).numpy(),
        np.asarray(jax_masks.generate_path(jnp.asarray(dur), jnp.asarray(mask))),
    )


@pytest.mark.parametrize("weight_norm,k,dilation", [(False, 3, 1), (True, 5, 2), (False, 1, 1)])
def test_conv_and_norm_match_jax(weight_norm, k, dilation):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    if weight_norm:
        p = {"v": w, "g": rng.uniform(0.5, 1.5, 4).astype(np.float32), "b": b}
    else:
        p = {"w": w, "b": b}
    ref = jax_conv.conv1d(jnp.asarray(x), {k_: jnp.asarray(v) for k_, v in p.items()}, dilation)
    port = conv.conv1d(_t(x), {k_: _t(v) for k_, v in p.items()}, dilation)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    ln = {"gamma": rng.standard_normal(6).astype(np.float32),
          "beta": rng.standard_normal(6).astype(np.float32)}
    np.testing.assert_allclose(
        norms.layer_norm(_t(x), {k_: _t(v) for k_, v in ln.items()}).numpy(),
        np.asarray(jax_norms.layer_norm(jnp.asarray(x), ln)), rtol=0, atol=1e-5,
    )


@pytest.mark.parametrize(
    "window,block_length", [(4, None), (None, None), (2, 3)],
    ids=["window4", "no_window", "window2_block3"],
)
def test_encoder_apply_matches_jax(tmp_path, window, block_length):
    """The op-by-op encoder stack (mha_apply with rel-pos, the -1e4 fill,
    block_length; ffn_apply; residual LNs) against JAX's XLA path."""
    _, jparams, tmodel, hp = _checkpoint(tmp_path, {"window_size": window})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 10, hp.h_enc)).astype(np.float32)
    mask = (np.arange(10)[None, :, None] < np.array([10, 4, 1])[:, None, None])
    mask = mask.astype(np.float32)
    ref = jax_attention.encoder_apply(
        jparams["encoder"], jnp.asarray(x), jnp.asarray(mask), n_heads=hp.n_heads,
        window_size=window, block_length=block_length,
    )
    enc = tmodel.tree()["encoder"]
    layers = [tree_index(enc, i) for i in range(hp.n_layers_enc)]
    port = attention.encoder_apply(layers, _t(x), _t(mask), hp.n_heads, window, block_length)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_prenet_apply_matches_jax(tmp_path):
    """The prenet kernel's plain version on its packed weights against
    JAX's op-by-op prenet_apply."""
    _, jparams, tmodel, hp = _checkpoint(tmp_path, {})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, hp.h_enc)).astype(np.float32)
    mask = (np.arange(8)[None, :, None] < np.array([8, 5])[:, None, None]).astype(np.float32)
    ref = jax_attention.prenet_apply(jparams["prenet"], jnp.asarray(x), jnp.asarray(mask))
    weights = text_cuda.prenet_weights(tmodel.tree()["prenet"])
    port = text_cuda.prenet_plain(weights, _t(x), _t(mask))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("over", [{}, {"n_speakers": 3, "gin_channels": 8, "sigmoid_scale": True}],
                         ids=["base", "gin_sigmoid"])
def test_inverse_bijectors_match_jax(tmp_path, over):
    """The folded inverse block (the kernel's plain version), block by block
    against JAX's op-by-op coupling^-1 -> invconv^-1 -> actnorm^-1, and the
    whole decoder_inv (squeeze, blocks, unsqueeze) against JAX's."""
    config, jparams, tmodel, hp = _checkpoint(tmp_path, over)
    jhp = jax_model.hyper_from_config(config)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 14, hp.out_channels)).astype(np.float32)
    mask = (np.arange(14)[None, :, None] < np.array([14, 8])[:, None, None]).astype(np.float32)
    z = z * mask
    g = None
    if hp.gin_channels:
        g = rng.standard_normal((2, 1, hp.gin_channels)).astype(np.float32)
    jg = None if g is None else jnp.asarray(g)
    ref, _ = jax_flows.decoder_inv(
        jparams["decoder"], jnp.asarray(z), jnp.asarray(mask), jhp.decoder, g=jg
    )
    blocks = tmodel.tree()["decoder"]["blocks"]
    folded, cond = flows.decoder_store_inverse(blocks, hp.n_block_layers, hp.n_split)
    g_all = None
    if g is not None:
        g_all = [conv.conv1d(_t(g), c).reshape(2, hp.n_block_layers, 2 * hp.h_dec) for c in cond]

    xj, mj = jax_flows.squeeze(jnp.asarray(z), jnp.asarray(mask), hp.n_sqz)
    x, x_mask = flows.squeeze(_t(z), _t(mask), hp.n_sqz)
    for i in reversed(range(hp.n_blocks_dec)):
        bp = jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["decoder"]["blocks"])
        xj, _ = jax_flows.coupling_apply(
            bp["coupling"], xj, mj, jg, hp.h_dec, hp.dilation_rate, hp.n_block_layers,
            sigmoid_scale=hp.sigmoid_scale, reverse=True,
        )
        xj, _ = jax_flows.invconv_apply(bp["invconv"], xj, mj, reverse=True)
        xj = jax_flows.actnorm_inv(bp["actnorm"], xj, mj)
        x = block_cuda.block_inverse_plain(
            folded[i], None if g_all is None else g_all[i], x, x_mask,
            hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale,
        )
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-5)

    port = flows.decoder_inv(
        folded, _t(z), _t(mask), kernel_size=hp.kernel_size_dec,
        dilation_rate=hp.dilation_rate, n_sqz=hp.n_sqz, sigmoid_scale=hp.sigmoid_scale,
        g_all=g_all,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

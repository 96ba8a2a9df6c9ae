"""The four serving kernels of glow_tts_train_tpu_torch against the JAX
package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode.  Same inputs (numpy seed), same
random non-zero weights (checkpoint.random_params: a zero coupling ``end``
or prenet ``proj``, as the JAX init sets them, would hide the WN stack and
the prenet).  Tolerance: 1e-5 max abs error on O(1) outputs — both sides
are f32 on the CPU and differ only in summation order.
The CUDA kernels themselves are held against their plain versions on a
GPU in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import block_pallas, encoder_pallas, text_pallas, wn_pallas
from glow_tts_train_tpu_torch import checkpoint, kernels
from glow_tts_train_tpu_torch.models import hyper_from_config
from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, text_cuda, wn_cuda
from glow_tts_train_tpu_torch.tree import tree_index

from helpers import tiny_config

ATOL = 1e-5  # f32 on the CPU, summation order only


def _trees(seed=0, **over):
    """(hp, JAX param tree, torch param tree) from one random checkpoint."""
    hp = hyper_from_config(tiny_config(**over))
    flat = checkpoint.random_params(hp, seed)
    jt, tt = {}, {}
    for key, a in flat.items():
        *parents, leaf = key[len("model/"):].split("/")
        nj, nt = jt, tt
        for p in parents:
            nj, nt = nj.setdefault(p, {}), nt.setdefault(p, {})
        nj[leaf] = jnp.asarray(a)
        nt[leaf] = torch.from_numpy(a.copy())
    return hp, jt, tt


def _inputs(b, t, c, seed=1, lengths=None):
    """x [b, t, c] and a ragged mask [b, t, 1] (sample 0 full length)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    if lengths is None:
        lengths = np.maximum(1, t - np.arange(b) * 3)
    mask = (np.arange(t)[None, :, None] < np.asarray(lengths)[:, None, None])
    return x, mask.astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# prenet + duration predictor (text_pallas)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [13, 3], ids=["ragged13", "t3"])
def test_prenet_matches_pallas(t):
    hp, jt, tt = _trees()
    x, mask = _inputs(3, t, hp.h_enc)
    ref = text_pallas.prenet_fused(
        jt["prenet"], jnp.asarray(x), jnp.asarray(mask), interpret=True
    )
    port = text_cuda.prenet(text_cuda.prenet_weights(tt["prenet"]), _t(x), _t(mask))
    _close(port, ref)


@pytest.mark.parametrize(
    "over", [{}, {"n_speakers": 3, "gin_channels": 8}], ids=["single", "multispeaker"]
)
def test_duration_predictor_matches_pallas(over):
    hp, jt, tt = _trees(**over)
    x, mask = _inputs(3, 11, hp.h_enc + hp.gin_channels)
    ref = text_pallas.duration_predictor_fused(
        jt["proj_w"], jnp.asarray(x), jnp.asarray(mask), p_dropout=0.0, interpret=True
    )
    port = text_cuda.duration_predictor(
        text_cuda.dp_weights(tt["proj_w"]), tt["proj_w"]["proj"], _t(x), _t(mask)
    )
    _close(port, ref)


def test_text_folds_match_jax():
    _, jt, tt = _trees()
    for port, ref in (
        (text_cuda.prenet_weights(tt["prenet"]),
         text_pallas.prenet_weights(jt["prenet"], jnp.float32)),
        (text_cuda.dp_weights(tt["proj_w"]),
         text_pallas.dp_weights(jt["proj_w"], jnp.float32)),
    ):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert tuple(p.shape) == r.shape
            _close(p, r, atol=0)


# ---------------------------------------------------------------------------
# encoder layer (encoder_pallas)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "t,lengths",
    [(13, None), (3, [3, 2, 1]), (16, [16, 16, 16])],
    ids=["ragged13", "t3_band_edge", "full16"],
)
def test_encoder_layer_matches_pallas(t, lengths):
    """t=3 < window+1 exercises the band edge; 13 is no multiple of 8; a
    length-1 sample has fully masked (-1e4) query rows."""
    hp, jt, tt = _trees()
    x, mask = _inputs(3, t, hp.h_enc, lengths=lengths)
    layer_j = jax.tree_util.tree_map(lambda a: a[1], jt["encoder"])
    ref = encoder_pallas.encoder_layer_fused(
        layer_j, jnp.asarray(x), jnp.asarray(mask), n_heads=hp.n_heads,
        window_size=hp.window_size, kernel_size=hp.kernel_size, interpret=True,
    )
    folded = encoder_cuda.fold_encoder_layer(tree_index(tt["encoder"], 1))
    port = encoder_cuda.encoder_layer(folded, _t(x), _t(mask), hp.n_heads, hp.window_size)
    _close(port, ref)
    assert np.isfinite(port.numpy()).all()


def test_encoder_fold_matches_jax():
    _, jt, tt = _trees()
    ref = encoder_pallas.fold_encoder_layer(
        jax.tree_util.tree_map(lambda a: a[0], jt["encoder"]), jnp.float32
    )
    port = encoder_cuda.fold_encoder_layer(tree_index(tt["encoder"], 0))
    assert len(port) == len(ref) == 18
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r, atol=0)


# ---------------------------------------------------------------------------
# inverse flow block (block_pallas, WN math from wn_pallas)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "over,g",
    [
        ({}, False),
        ({"sigmoid_scale": True, "n_speakers": 3, "gin_channels": 8}, True),
        ({"dilation_rate": 2, "n_block_layers": 3}, False),
    ],
    ids=["base", "sigmoid_gin", "dilation2_L3"],
)
def test_block_inverse_matches_pallas(over, g):
    hp, jt, tt = _trees(**over)
    c, h, L = 2 * hp.out_channels, hp.h_dec, hp.n_block_layers
    x, mask = _inputs(3, 13, c)
    x = x * mask
    g_all = (
        np.random.default_rng(2).standard_normal((3, L, 2 * h)).astype(np.float32)
        if g else None
    )
    bj = jax.tree_util.tree_map(lambda a: a[1], jt["decoder"]["blocks"])
    folded_j = block_pallas.fold_block_params_inverse(bj, L, hp.n_split, jnp.float32)
    ref = block_pallas.flow_block_inv_fused_folded(
        folded_j,
        jnp.asarray(g_all) if g else jnp.zeros((1, L, 2 * h), jnp.float32),
        jnp.asarray(x), jnp.asarray(mask),
        kernel_size=hp.kernel_size_dec, dilation_rate=hp.dilation_rate,
        n_layers=L, sigmoid_scale=hp.sigmoid_scale, interpret=True,
    )
    folded = block_cuda.fold_block_params_inverse(
        tree_index(tt["decoder"]["blocks"], 1), L, hp.n_split
    )
    port = block_cuda.block_inverse(
        folded, None if g_all is None else _t(g_all), _t(x), _t(mask),
        hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale,
    )
    _close(port, ref)


@pytest.mark.parametrize("stored", [False, True], ids=["live_inv", "stored_inv"])
def test_block_fold_matches_jax(stored):
    hp, jt, tt = _trees()
    L = hp.n_block_layers
    bj = jax.tree_util.tree_map(lambda a: a[0], jt["decoder"]["blocks"])
    bt = tree_index(tt["decoder"]["blocks"], 0)
    if stored:
        w = np.linalg.inv(np.asarray(bj["invconv"]["weight"], np.float64)).astype(np.float32)
        bj = dict(bj, invconv=dict(bj["invconv"], weight_inv=jnp.asarray(w)))
        bt = dict(bt, invconv=dict(bt["invconv"], weight_inv=_t(w)))
    ref = block_pallas.fold_block_params_inverse(bj, L, hp.n_split, jnp.float32)
    port = block_cuda.fold_block_params_inverse(bt, L, hp.n_split)
    assert set(port) == set(ref)
    for k in ref:
        assert tuple(port[k].shape) == ref[k].shape, k
        _close(port[k], ref[k], atol=1e-6)


def test_wn_fold_matches_jax():
    hp, jt, tt = _trees(n_block_layers=3)
    wn_j = jax.tree_util.tree_map(lambda a: a[0], jt["decoder"]["blocks"]["coupling"]["wn"])
    ref = wn_pallas.fold_wn_weights(wn_j, 3, jnp.float32)
    port = wn_cuda.fold_wn_weights(tree_index(tt["decoder"]["blocks"]["coupling"]["wn"], 0), 3)
    for p, r in zip(port, ref):
        assert tuple(p.shape) == r.shape
        _close(p, r, atol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel library: the launch counters
    stay where they were."""
    hp, _, tt = _trees()
    before = kernels.launch_counts()
    x, mask = _inputs(2, 7, hp.h_enc)
    text_cuda.prenet(text_cuda.prenet_weights(tt["prenet"]), _t(x), _t(mask))
    assert kernels.route(_t(x)) == "plain"
    assert kernels.launch_counts() == before

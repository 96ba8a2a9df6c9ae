"""The training ops of glow_tts_train_tpu_torch against the JAX package on
the CPU: the dropout bits, the WN forward, the flow block forward and
every raw-parameter gradient with dropout active, MAS, DDI, init, the
losses and the optimizer.

The port runs its plain PyTorch versions (CPU tensors); JAX runs its
Pallas kernels in interpret mode (their CPU path) or its XLA path.  Every
input is made from a numpy seed; every block test uses random non-zero
weights (``checkpoint.random_params``), so no zero-initialised leaf hides
a term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu import optimize as jax_optimize
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.models import losses as jax_losses
from glow_tts_train_tpu.ops import block_pallas, mas, wn_pallas
from glow_tts_train_tpu_torch import checkpoint, optimize
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.models import losses
from glow_tts_train_tpu_torch.ops import block_cuda, conv, mas_cuda, wn_cuda
from glow_tts_train_tpu_torch.tree import flatten, tree_index, unflatten

from helpers import random_batch, tiny_config


def _t(a):
    return torch.from_numpy(np.array(a))


def _checkpoint(tmp_path, config, seed=0):
    """One random checkpoint through both loaders -> (JAX params, port
    model, hp)."""
    hp = model.hyper_from_config(config)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, checkpoint.random_params(hp, seed))
    jparams = jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    tmodel, _ = checkpoint.load_checkpoint(path, hp)
    return jparams, tmodel, hp


def _ragged(rng, b, t, c):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    lengths = np.array([t, t - 7, 3][:b])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x * mask, mask


# ---------------------------------------------------------------------------
# dropout bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 987654, 2 ** 31 - 2, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(7, 32), (13, 6)])
def test_portable_bits_match_jax(seed, shape):
    """The counter hash bit for bit, seeds up to the int32 limit."""
    ref = np.asarray(wn_pallas._portable_bits(jnp.int32(seed), shape))
    port = wn_cuda.portable_bits(seed, shape)
    np.testing.assert_array_equal(port.numpy().astype(np.uint32), ref)


@pytest.mark.parametrize("p", [0.05, 0.3])
@pytest.mark.parametrize("seed", [11, 2 ** 31 - 2])
def test_regen_keep_matches_jax(p, seed):
    """Per (sample, layer) keep masks of the kernels, odd t; seed + sample
    and * n_layers + layer wrap around int32 near 2**31."""
    n_layers, shape = 3, (9, 10)
    thr = np.uint32(min(round(p * 2 ** 32), 2 ** 32 - 1))
    for sample in range(3):
        st = {
            "seed": jnp.int32(seed) + jnp.int32(sample), "n_layers": n_layers,
            "drop_threshold": thr, "interpret": True,
        }
        for l in range(n_layers):
            ref = np.asarray(wn_pallas._regen_keep(l, shape, st))
            port = wn_cuda.regen_keep(seed + sample, l, n_layers, shape, p)
            np.testing.assert_array_equal(port.numpy(), ref)


# ---------------------------------------------------------------------------
# WN forward and the flow block, training direction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [{}, {"n_speakers": 3, "gin_channels": 6, "dilation_rate": 2}],
                         ids=["plain", "gin_dilation2"])
def test_wn_stack_matches_jax_interpret(tmp_path, over):
    """wn_stack (plain) against wn_apply_pallas in interpret mode, no
    dropout; ragged mask.  Tolerance 1e-5 of max |ref| (f32, two
    summation orders)."""
    config = tiny_config(**over)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    L, h = hp.n_block_layers, hp.h_dec
    rng = np.random.default_rng(2)
    x, mask = _ragged(rng, 3, 21, h)
    g = rng.standard_normal((3, 1, hp.gin_channels)).astype(np.float32) if hp.gin_channels else None
    wn_j = jax.tree_util.tree_map(lambda a: a[0], jparams["decoder"]["blocks"]["coupling"]["wn"])
    ref = wn_pallas.wn_apply_pallas(
        wn_j, jnp.asarray(x), jnp.asarray(mask), None if g is None else jnp.asarray(g),
        h, hp.dilation_rate, L,
    )
    wn_t = tree_index(tmodel.tree()["decoder"]["blocks"]["coupling"]["wn"], 0)
    g_all = None
    if g is not None:
        g_all = conv.conv1d(_t(g), wn_t["cond"]).reshape(3, L, 2 * h)
    port = wn_cuda.wn_stack(
        wn_cuda.fold_wn_weights(wn_t, L), g_all, _t(x), _t(mask),
        hp.kernel_size_dec, hp.dilation_rate,
    ) * _t(mask)
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


BLOCK_CASES = {
    "dropout": ({}, 0.3),
    "sigmoid_gin_dilation2_dropout": (
        {"sigmoid_scale": True, "n_speakers": 3, "gin_channels": 6, "dilation_rate": 2}, 0.3
    ),
    "no_dropout": ({"n_speakers": 2, "gin_channels": 4}, 0.0),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_forward_and_grads_match_jax(tmp_path, name):
    """fold_block_params + block_forward_plain + autograd against JAX
    flow_block_fused (interpret mode, residuals="store") + jax.vjp with
    dropout active and the same seed (drawn as flow_block_fused_folded
    draws it): z, ld, and the gradient of every raw block parameter
    (actnorm, invconv weight, weight-norm g/v, biases, cond) and of x and
    g.  Tolerances: outputs 1e-5, gradients 1e-4 of their max magnitude
    (f32 in both, different summation orders and a 4x4 slogdet/inverse)."""
    _block_against_jax(tmp_path, name, "store")


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_recompute_forward_and_grads_match_jax(tmp_path, name):
    """The same with ``residuals="recompute"`` on both sides: JAX runs
    ``_block_fwd_kernel`` forward and ``_block_bwd_kernel`` (forward
    recompute, then the walk) backward; same tolerances."""
    _block_against_jax(tmp_path, name, "recompute")


def _block_against_jax(tmp_path, name, residuals):
    over, p = BLOCK_CASES[name]
    config = tiny_config(**over)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    L, h = hp.n_block_layers, hp.h_dec
    c = hp.out_channels * hp.n_sqz
    rng = np.random.default_rng(5)
    x, mask = _ragged(rng, 3, 20, c)
    g = rng.standard_normal((3, 1, hp.gin_channels)).astype(np.float32) if hp.gin_channels else None
    bp_j = jax.tree_util.tree_map(lambda a: a[1], jparams["decoder"]["blocks"])
    key = jax.random.PRNGKey(7)
    seed = int(jax.random.randint(key, (), minval=0, maxval=np.int32(2 ** 31 - 1), dtype=jnp.int32))

    def f(bp, xx, gg):
        return block_pallas.flow_block_fused(
            bp, xx, jnp.asarray(mask), gg, hidden_channels=h,
            dilation_rate=hp.dilation_rate, n_layers=L, n_split=hp.n_split,
            sigmoid_scale=hp.sigmoid_scale, p_dropout=p, rng=key,
            deterministic=False, interpret=True, residuals=residuals,
        )

    gj = None if g is None else jnp.asarray(g)
    (z_j, ld_j), vjp = jax.vjp(f, bp_j, jnp.asarray(x), gj)
    dz = rng.standard_normal(z_j.shape).astype(np.float32)
    dld = rng.standard_normal(ld_j.shape).astype(np.float32)
    d_bp, d_x, d_g = vjp((jnp.asarray(dz), jnp.asarray(dld)))

    flat_t = {
        path: leaf.clone().requires_grad_(True)
        for path, leaf in flatten(tree_index(tmodel.tree()["decoder"]["blocks"], 1)).items()
    }
    bp_t = unflatten(flat_t)
    xt = _t(x).requires_grad_(True)
    gt = None if g is None else _t(g).requires_grad_(True)
    folded = block_cuda.fold_block_params(bp_t, L, hp.n_split)
    g_all = None
    if gt is not None:
        g_all = conv.conv1d(gt, bp_t["coupling"]["wn"]["cond"]).reshape(3, L, 2 * h)
    z_t, ld_t = block_cuda.block_forward(
        folded, g_all, xt, _t(mask), hp.kernel_size_dec, hp.dilation_rate,
        hp.sigmoid_scale, p, seed, residuals,
    )

    def close(name, port, ref, rtol):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            port.detach().numpy(), ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-6),
            err_msg=name,
        )

    close("z", z_t, z_j, 1e-5)
    close("ld", ld_t, ld_j, 1e-5)
    leaves = list(flat_t.items())
    inputs = [leaf for _, leaf in leaves] + [xt] + ([gt] if gt is not None else [])
    grads = torch.autograd.grad(
        (z_t * _t(dz)).sum() + (ld_t * _t(dld)).sum(), inputs, allow_unused=True
    )
    ref_flat = flatten(jax.tree_util.tree_map(np.asarray, d_bp))
    for (path, _), grad in zip(leaves, grads[: len(leaves)]):
        assert grad is not None, path
        close(path, grad, ref_flat[path], 1e-4)
    close("x", grads[len(leaves)], d_x, 1e-4)
    if gt is not None:
        close("g", grads[len(leaves) + 1], d_g, 1e-4)


def test_fold_blocks_stacked_matches_jax(tmp_path):
    """The per-step fold of all blocks: kernel weights, logs_sum,
    logabsdet and the per-block conditioning, against JAX's vmapped fold."""
    config = tiny_config(n_speakers=3, gin_channels=6)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    L, h = hp.n_block_layers, hp.h_dec
    g = np.random.default_rng(1).standard_normal((2, 1, 6)).astype(np.float32)
    ref = block_pallas.fold_blocks_stacked(
        jparams["decoder"]["blocks"], L, hp.n_split, jnp.float32, jnp.asarray(g), h
    )
    folded, logs_sum, logabsdet, g_all = block_cuda.fold_blocks_stacked(
        tmodel.tree()["decoder"]["blocks"], L, hp.n_split, _t(g), h
    )
    for i in range(hp.n_blocks_dec):
        for k in block_cuda.FOLD_KEYS:
            np.testing.assert_allclose(folded[i][k].numpy(), np.asarray(ref[0][k][i]), rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g_all[i].numpy(), np.asarray(ref[3][i]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logs_sum.numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logabsdet.numpy(), np.asarray(ref[2]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# MAS
# ---------------------------------------------------------------------------


def _mas_case(rng, b, t_x, t_y, kind):
    logp = rng.standard_normal((b, t_x, t_y)).astype(np.float32) * 3.0
    if kind == "ties":
        logp = np.round(logp)
    if kind == "extreme":
        logp = (logp - 2e8).astype(np.float32)
    t_xs = rng.integers(1, t_x + 1, size=b)
    t_ys = np.maximum(rng.integers(1, t_y + 1, size=b), t_xs)
    if kind == "full":
        t_xs[:], t_ys[:] = t_x, t_y
    mask = np.zeros((b, t_x, t_y), np.float32)
    for i in range(b):
        mask[i, : t_xs[i], : t_ys[i]] = 1.0
    return logp, mask


@pytest.mark.parametrize("kind", ["ragged", "ties", "extreme", "full"])
@pytest.mark.parametrize(
    "shape", [(4, 7, 13), (3, 12, 12), (2, 1, 9), (2, 12, 40), (2, 31, 40), (2, 33, 50), (2, 65, 90)]
)
def test_maximum_path_equals_oracle_and_jax_scan(kind, shape):
    """mas_cuda.maximum_path (plain, CPU) is exactly the numpy oracle and
    the JAX column scan: ragged lengths, integer (tied) logp, extreme
    negative scores, t_x == t_y and t_x == 1, and text widths around the
    kernel's 32 lanes a warp (31, 33, 65)."""
    rng = np.random.default_rng(sum(shape))
    logp, mask = _mas_case(rng, *shape, kind)
    port = mas_cuda.maximum_path(_t(logp), _t(mask)).numpy()
    np.testing.assert_array_equal(port, mas.maximum_path_numpy(logp, mask))
    np.testing.assert_array_equal(
        port, np.asarray(mas.maximum_path(jnp.asarray(logp), jnp.asarray(mask), impl="scan"))
    )


# ---------------------------------------------------------------------------
# init, DDI, losses, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "over", [{}, {"mean_only": False, "n_speakers": 3, "gin_channels": 8}, {"prenet": False}],
    ids=["base", "multispeaker", "no_prenet"],
)
def test_init_model_matches_param_shapes_and_jax(over):
    """Keys and shapes equal param_shapes and JAX init_model's; the
    zero-init leaves (coupling end, prenet proj, actnorm, LayerNorm beta)
    are zero in both and no other leaf is; invconv weights orthogonal with
    det +1; weight norm g = ||v||."""
    config = tiny_config(**over)
    hp = model.hyper_from_config(config)
    port = model.init_model(hp, torch.Generator().manual_seed(0))
    shapes = {k[len("model/"):]: v for k, v in checkpoint.param_shapes(hp).items()}
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes
    ref = jax_checkpoint._flatten(jax_model.init_model(jax.random.PRNGKey(0), jax_model.hyper_from_config(config)), "")
    assert {k: tuple(v.shape) for k, v in ref.items()} == shapes
    for k, v in port.items():
        zero = k.endswith(
            ("coupling/end/w", "coupling/end/b", "prenet/proj/w", "prenet/proj/b", "/beta")
        ) or "/actnorm/" in k
        assert bool((v == 0).all()) == zero, k
        assert bool((np.asarray(ref[k]) == 0).all()) == zero, k
    w = port["decoder/blocks/invconv/weight"]
    eye = torch.eye(hp.n_split).expand_as(w)
    torch.testing.assert_close(w @ w.transpose(1, 2), eye, atol=1e-5, rtol=0)
    assert (torch.linalg.det(w) > 0).all()
    v, g = port["decoder/blocks/coupling/start/v"], port["decoder/blocks/coupling/start/g"]
    torch.testing.assert_close(g, torch.sqrt((v * v).sum(dim=(-3, -2))))


@pytest.mark.parametrize("over", [{}, {"n_speakers": 3, "gin_channels": 8, "sigmoid_scale": True}],
                         ids=["base", "multispeaker_sigmoid"])
def test_ddi_init_matches_jax(tmp_path, over):
    """Data-dependent ActNorm init on the same params and batch: every
    block's logs and bias within 1e-5 (f32; the statistics pass through
    the previous blocks' WN stacks)."""
    config = tiny_config(**over)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    ms = hp.n_speakers > 1
    batch = random_batch(config, np.random.default_rng(3), multispeaker=ms)
    g_ids = jnp.asarray(batch["speaker_ids"]) if ms else None
    ref = jax_model.ddi_init(
        jparams, jax_model.hyper_from_config(config), jnp.asarray(batch["x"]),
        jnp.asarray(batch["x_lengths"]), jnp.asarray(batch["y"]),
        jnp.asarray(batch["y_lengths"]), g_ids=g_ids,
    )["decoder"]["blocks"]["actnorm"]
    port = model.ddi_init(
        tmodel.tree(), hp, _t(batch["y"]), _t(batch["y_lengths"]).long(),
        _t(batch["speaker_ids"]).long() if ms else None,
    )
    for k in ("logs", "bias"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5, err_msg=k)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    z, m, logs = (rng.standard_normal((3, 10, 4)).astype(np.float32) for _ in range(3))
    logdet = rng.standard_normal(3).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([10, 6, 2])[:, None]).astype(np.float32)[..., None]
    np.testing.assert_allclose(
        float(losses.mle_loss(*(map(_t, (z, m, logs, logdet, mask))))),
        float(jax_losses.mle_loss(z, m, logs, logdet, mask)), rtol=1e-6,
    )
    lw, lw_ = rng.standard_normal((2, 2, 7, 1)).astype(np.float32)
    lengths = np.array([7, 4], np.int32)
    np.testing.assert_allclose(
        float(losses.duration_loss(_t(lw), _t(lw_), _t(lengths))),
        float(jax_losses.duration_loss(lw, lw_, lengths)), rtol=1e-6,
    )


@pytest.mark.parametrize("scheduler", ["noam", "constant"])
def test_adam_matches_optax(scheduler):
    """Five clip + Adam + schedule updates of random gradients (some past
    the clip) against the JAX package's optax chain: params and both
    moments within 1e-6 relative; current_lr equal."""
    config = tiny_config()
    config.scheduler = scheduler
    config.warmup_steps = 3
    config.learning_rate = 1.0 if scheduler == "noam" else 1e-3
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    tx = jax_optimize.make_optimizer(config)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    ts = optimize.adam_init(tp)
    for _ in range(5):
        grads = {k: (rng.standard_normal(v.shape) * 4).astype(np.float32) for k, v in params.items()}
        updates, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        ts = optimize.adam_update(tp, {k: _t(v) for k, v in grads.items()}, ts, config)
    adam = js[1]
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-7)
    assert ts.count == int(adam.count) == 5
    for step in (1, 2, 7):
        assert optimize.current_lr(config, step) == pytest.approx(jax_optimize.current_lr(config, step), rel=1e-7)

"""bf16 training (``fp16_run: true``) of glow_tts_train_tpu_torch on the CPU
against the JAX package's bf16 compute.

The JAX package computes in bf16 under ``fp16_run`` (``training.py``:
``compute_dtype = bfloat16``): bf16 activations and product operands, f32
accumulation, f32 params, losses and Adam state.  The port's bf16 plain
versions (what its wrappers run on CPU tensors) round where the JAX
kernels round.  Each test runs the same numpy-seeded inputs through the
JAX function twice, in bf16 and in f32 (its Pallas kernels in interpret
mode, as the JAX package's tests run them), and through the port in
bf16, with dropout off, and holds every output and gradient of the port
within half of JAX's own bf16-vs-f32 gap of JAX bf16:

    |port - jax_bf16| <= 0.5 * |jax_bf16 - jax_f32|

per tensor, in the 2-norm over its elements (:func:`held_to_gap`).  A
port that computed in f32 would sit at the full gap (or, rounding
elsewhere, about as far), and fail.

Measured here (the largest ratio err / gap of a tensor, in the norm): the
prenet 0.15 (dWp: its f32 sum, in another order than JAX's per-sample
sums, rounds to the neighbouring bf16 value at a few elements), the
duration stack 0.00, the encoder layer 0.25 (rel_v's gradient: JAX's
backward reads the rounded band probabilities, the port's autograd the
unrounded ones), the flow block's z, ld and dx 0.00; forward_train: z and
the loss 0.00, the parameter gradients at most 0.24 (rel_v again); the
3-step trajectory: the losses and grad norm at most 0.16, the params 0.03,
Adam's moments 0.28.  All gradients together in the norm 0.03.  Three
gradients are held in that norm only: the biases of the 1x1 projections
outside the kernels (``proj_m``, ``proj_s``, the duration predictor's
``proj``), whose bf16 cotangent XLA on the CPU sums in bf16, one row
after another, where the port sums in f32, so they sit about one gap from
JAX bf16 (:data:`CPU_BF16_SUMS`).  JAX's own gap (max over max |f32|): z
4.8e-3 and 6.3e-3, the loss 4.8e-4; the trajectory's losses at most
1.2e-3 and the grad norm 4.5e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu import training as jax_training
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.models.losses import duration_loss as jax_duration_loss
from glow_tts_train_tpu.models.losses import mle_loss as jax_mle_loss
from glow_tts_train_tpu.ops import block_pallas
from glow_tts_train_tpu.ops import encoder_pallas as ep
from glow_tts_train_tpu.ops import text_pallas as tp
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu.optimize import make_optimizer
from glow_tts_train_tpu_torch import checkpoint, training
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.models.losses import duration_loss, mle_loss
from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, text_cuda
from glow_tts_train_tpu_torch.tree import flatten, tree_index, unflatten

from helpers import random_batch, tiny_config

BF16 = torch.bfloat16
H, F_DP, HEADS, WINDOW, F_ENC, TAPS = 32, 64, 2, 4, 64, 3
SEED = 5
# the 1x1 projections' biases, whose bf16 cotangent XLA on the CPU sums in
# bf16 (module docstring): held in the norm of all gradients only
CPU_BF16_SUMS = ("proj_m/b", "proj_s/b", "proj_w/proj/b")
# ... and, in the op-by-op decoder, the leaves whose gradient is such a sum
# of the bijectors' bf16 cotangents outside the kernels (the transpose of a
# broadcast, which XLA on the CPU reduces in bf16: of 16 sums of 104
# N(0, 1) bf16 values the worst 0.30 from its exact value, where a jnp.sum
# of the same values, rounded once, is 0.048 from it): ActNorm's bias and
# logs, the coupling's start and end conv biases
CPU_BF16_SUMS_UNFUSED = ("decoder/blocks/actnorm/bias", "decoder/blocks/actnorm/logs",
                         "decoder/blocks/coupling/start/b", "decoder/blocks/coupling/end/b")


def _cpu_bf16_sums(mode):
    return CPU_BF16_SUMS + (CPU_BF16_SUMS_UNFUSED if mode.startswith("unfused") else ())


def held_to_gap(name, port, jax_bf16, jax_f32, ratio=0.5):
    """|port - jax_bf16| within ``ratio`` of |jax_bf16 - jax_f32|, in the
    2-norm over the tensor's elements; -> that fraction.  (The norm, not the
    max: a bf16 result whose f32 sum was added in another order rounds to
    the neighbouring bf16 value at a few elements, one bf16 step, which can
    be all of the max gap of a tensor of bf16 values; JAX's bf16 and f32
    differ at nearly every element.)"""
    port, jb, jf = (np.asarray(a, np.float64) for a in (port, jax_bf16, jax_f32))
    assert port.shape == jb.shape == jf.shape, name
    gap = np.linalg.norm((jb - jf).ravel())
    err = np.linalg.norm((port - jb).ravel())
    assert np.isfinite(err), name
    assert gap > 0 or err == 0, f"{name}: JAX bf16 equals f32 and the port differs by {err}"
    assert err <= ratio * gap, f"{name}: port - JAX bf16 {err:.3e} > {ratio} x gap {gap:.3e}"
    return err / gap if gap else 0.0


def held_in_norm(name, port: dict, jax_bf16: dict, jax_f32: dict, ratio=0.5):
    """The same over all tensors of a dict together, in the 2-norm."""
    keys = sorted(jax_bf16)
    cat = [np.concatenate([np.asarray(d[k], np.float64).ravel() for k in keys])
           for d in (port, jax_bf16, jax_f32)]
    err = np.linalg.norm(cat[0] - cat[1])
    gap = np.linalg.norm(cat[1] - cat[2])
    assert err <= ratio * gap, f"{name}: |port - JAX bf16| {err:.3e} > {ratio} x gap {gap:.3e}"
    return err / gap


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _inputs(t, width, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, t, width)).astype(np.float32)
    lengths = np.array([t, max(1, t // 2 + 1), 3])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x * mask, mask


def _jax_vjp(fn, weights, x, mask, cot, bf16_idx):
    """(out, dx, dweights) of ``fn(weights, x, mask, seed)`` in JAX, once in
    bf16 (x, the mask and the weights at ``bf16_idx`` bf16, as the JAX
    folds cast them) and once in f32."""
    seed_f = jnp.asarray([SEED], jnp.int32)
    res = {}
    for dt in (jnp.bfloat16, jnp.float32):
        w = tuple(jnp.asarray(a, dt if i in bf16_idx else jnp.float32) for i, a in enumerate(weights))
        out, vjp = jax.vjp(lambda ww, xx: fn(ww, xx, jnp.asarray(mask, dt), seed_f), w,
                           jnp.asarray(x, dt))
        dw, dx = vjp(jnp.asarray(cot, out.dtype))
        res[dt] = [out, dx, *dw]
    return res[jnp.bfloat16], res[jnp.float32]


def _port_vjp(apply, weights, x, mask, cot, bf16_idx):
    """The same through the port in bf16 (its CPU route: the plain bf16
    versions)."""
    tw = tuple(torch.from_numpy(a).to(BF16 if i in bf16_idx else torch.float32)
               .requires_grad_(True) for i, a in enumerate(weights))
    tx = torch.from_numpy(x).to(BF16).requires_grad_(True)
    out = apply(tw, tx, torch.from_numpy(mask))
    assert out.dtype == BF16
    grads = torch.autograd.grad(out, (tx, *tw), torch.from_numpy(cot).to(BF16))
    for g, a in zip(grads, (tx, *tw)):
        assert g.dtype == a.dtype  # bf16 gradients of bf16 operands, as JAX returns them
    return [out, *grads]


def _held_all(name, port, jax_b, jax_f):
    return max(held_to_gap(f"{name} [{i}]", _np(p), b, f)
               for i, (p, b, f) in enumerate(zip(port, jax_b, jax_f)))


def _weights(rng, shapes):
    return tuple((rng.standard_normal(s) * sc).astype(np.float32) + off for s, sc, off in shapes)


def test_prenet_bf16_within_half_of_jax_gap():
    """The prenet's bf16 plain version (``PrenetTrain`` on CPU tensors):
    output, dx and the six weight gradients against ``jax.vjp`` of the JAX
    prenet kernel in bf16 (interpret mode); conv and projection weights
    bf16, the rest f32."""
    rng = np.random.default_rng(1)
    weights = _weights(rng, [((3, 5 * H, H), (5 * H) ** -0.5, 0.0), ((3, H), 0.1, 0.0),
                             ((3, H), 0.1, 1.0), ((3, H), 0.1, 0.0), ((H, H), H ** -0.5, 0.0),
                             ((1, H), 0.1, 0.0)])
    x, mask = _inputs(17, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    fn = tp._make_prenet_fn(tp._TextKey((3, _offsets(5, 1), None, 1.0), True))
    jb, jf = _jax_vjp(fn, weights, x, mask, cot, (0, 4))
    port = _port_vjp(lambda w, xx, m: text_cuda.prenet_train(w, xx, m), weights, x, mask, cot,
                     (0, 4))
    assert _held_all("prenet", port, jb, jf) < 0.5


@pytest.mark.parametrize("gin", [0, 8])
def test_duration_stack_bf16_within_half_of_jax_gap(gin):
    """The duration stack's bf16 plain version, with and without the
    speaker channels: output, dx and the eight weight gradients."""
    rng = np.random.default_rng(2)
    c = H + gin
    weights = _weights(rng, [((3 * c, F_DP), (3 * c) ** -0.5, 0.0), ((1, F_DP), 0.1, 0.0),
                             ((1, F_DP), 0.1, 1.0), ((1, F_DP), 0.1, 0.0),
                             ((3 * F_DP, F_DP), (3 * F_DP) ** -0.5, 0.0), ((1, F_DP), 0.1, 0.0),
                             ((1, F_DP), 0.1, 1.0), ((1, F_DP), 0.1, 0.0)])
    x, mask = _inputs(24, c)
    cot = rng.standard_normal((3, 24, F_DP)).astype(np.float32)
    fn = tp._make_dp_fn(tp._TextKey((2, _offsets(3, 1), None, 1.0), True))
    jb, jf = _jax_vjp(fn, weights, x, mask, cot, (0, 4))
    port = _port_vjp(lambda w, xx, m: text_cuda.duration_stack_train(w, xx, m), weights, x,
                     mask, cot, (0, 4))
    assert _held_all("duration_stack", port, jb, jf) < 0.5


def test_encoder_layer_bf16_within_half_of_jax_gap():
    """One encoder layer's bf16 plain version (rel-pos attention, window
    4, 2 heads): output, dx and all 18 weight gradients against the JAX
    layer kernel in bf16 (interpret mode, pack 1); the 1x1 and FFN weights
    and the rel-pos tables bf16, as ``encoder_pallas.fold_encoder_layer``
    casts them."""
    rng = np.random.default_rng(3)
    d = H // HEADS
    proj = [s for _ in range(4) for s in (((H, H), H ** -0.5, 0.0), ((1, H), 0.1, 0.0))]
    weights = _weights(rng, proj + [
        ((2 * WINDOW + 1, d), d ** -0.5, 0.0), ((2 * WINDOW + 1, d), d ** -0.5, 0.0),
        ((1, H), 0.1, 1.0), ((1, H), 0.1, 0.0), ((1, H), 0.1, 1.0), ((1, H), 0.1, 0.0),
        ((TAPS * H, F_ENC), (TAPS * H) ** -0.5, 0.0), ((1, F_ENC), 0.1, 0.0),
        ((TAPS * F_ENC, H), (TAPS * F_ENC) ** -0.5, 0.0), ((1, H), 0.1, 0.0)])
    bf16_idx = (0, 2, 4, 6, 8, 9, 14, 16)
    x, mask = _inputs(20, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    st = (HEADS, WINDOW, _offsets(TAPS, 1), None, 1.0, 1)
    with ep.force_pack(1):
        fn = ep._make_layer_fn(ep._EncKey(st, True))
        jb, jf = _jax_vjp(fn, weights, x, mask, cot, bf16_idx)
    port = _port_vjp(
        lambda w, xx, m: encoder_cuda.encoder_layer_train(w, xx, m, HEADS, WINDOW), weights, x,
        mask, cot, bf16_idx,
    )
    # the key bias's gradient (index 5 of [out, dx, dwq, dbq, dwk, dbk, ...])
    # is zero up to round-off (softmax over keys is invariant to q . b_k):
    # both frameworks' values are noise around 0
    port, jb, jf = ([a for i, a in enumerate(r) if i != 5] for r in (port, jb, jf))
    assert _held_all("encoder_layer", port, jb, jf) < 0.5


def _checkpoint(tmp_path, config, seed=0):
    hp = model.hyper_from_config(config)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, checkpoint.random_params(hp, seed))
    jparams = jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    tmodel, _ = checkpoint.load_checkpoint(path, hp)
    return jparams, tmodel, hp


def test_flow_block_bf16_within_half_of_jax_gap(tmp_path):
    """One flow block in bf16 (``fold_block_params`` to bf16 weights, the
    store-mode block on CPU tensors: its plain forward and backward)
    against JAX ``flow_block_fused`` with x bf16 (interpret mode, store
    residuals): z, ld and the gradients of x and of every raw block
    parameter."""
    config = tiny_config()
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    L, h = hp.n_block_layers, hp.h_dec
    c = hp.out_channels * hp.n_sqz
    x, mask = _inputs(20, c, seed=5)
    rng = np.random.default_rng(6)
    bp_j = jax.tree_util.tree_map(lambda a: a[1], jparams["decoder"]["blocks"])
    res = {}
    for dt in (jnp.bfloat16, jnp.float32):
        def f(bp, xx):
            return block_pallas.flow_block_fused(
                bp, xx, jnp.asarray(mask, dt), None, hidden_channels=h,
                dilation_rate=hp.dilation_rate, n_layers=L, n_split=hp.n_split,
                sigmoid_scale=hp.sigmoid_scale, interpret=True, residuals="store",
            )

        (z, ld), vjp = jax.vjp(f, bp_j, jnp.asarray(x, dt))
        if dt == jnp.bfloat16:
            dz = rng.standard_normal(z.shape).astype(np.float32)
            dld = rng.standard_normal(ld.shape).astype(np.float32)
        d_bp, d_x = vjp((jnp.asarray(dz, z.dtype), jnp.asarray(dld, ld.dtype)))
        res[dt] = {"z": z, "ld": ld, "x": d_x, **flatten(jax.tree_util.tree_map(np.asarray, d_bp))}

    flat_t = {k: v.clone().requires_grad_(True)
              for k, v in flatten(tree_index(tmodel.tree()["decoder"]["blocks"], 1)).items()}
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    folded = block_cuda.fold_block_params(unflatten(flat_t), L, hp.n_split, BF16)
    z_t, ld_t = block_cuda.block_forward(
        folded, None, xt, torch.from_numpy(mask), hp.kernel_size_dec, hp.dilation_rate,
        hp.sigmoid_scale,
    )
    assert z_t.dtype == BF16 and ld_t.dtype == torch.float32
    grads = torch.autograd.grad((z_t, ld_t), [*flat_t.values(), xt],
                                (torch.from_numpy(dz).to(BF16), torch.from_numpy(dld)))
    port = {"z": z_t, "ld": ld_t, "x": grads[-1], **dict(zip(flat_t, grads))}
    assert max(held_to_gap(k, _np(port[k]), res[jnp.bfloat16][k], res[jnp.float32][k])
               for k in port) < 0.5


# ---------------------------------------------------------------------------
# the model and the train step
# ---------------------------------------------------------------------------


# the decoder's four training modes: (flow_block_fuse, wn_residuals)
DECODER_MODES = {
    "fused_store": (True, "store"), "fused_recompute": (True, "recompute"),
    "unfused_store": (False, "store"), "unfused_recompute": (False, "recompute"),
}


def _bf16_config(mode="fused_store", **over):
    """tiny_config in a bf16 mode the port trains: fp16_run, the text
    kernels (JAX: interpret mode), the decoder in ``mode`` (the fused flow
    block or the bijectors op by op around the WN stack's kernels, store or
    recompute residuals; JAX: its Pallas kernels, spelled out: its "auto"
    is XLA on the CPU), dropout off."""
    config = tiny_config(**over)
    config.model.p_dropout = 0.0
    config.model.p_dropout_dec = 0.0
    config.encoder_fuse = True
    config.wn_impl = "pallas"
    config.flow_block_fuse, config.wn_residuals = DECODER_MODES[mode]
    config.fp16_run = True
    return config


@pytest.mark.parametrize("mode", sorted(DECODER_MODES))
def test_forward_train_and_gradients_bf16_within_half_of_jax_gap(tmp_path, mode):
    """``forward_train`` in bf16 plus the gradient of the loss, in each of
    the decoder's four modes (JAX in the same mode, its f32 reference
    too): the loss and z within half of JAX's gap, the MAS path of JAX
    bf16 exactly, every parameter gradient but the three of CPU_BF16_SUMS
    (op by op, and the four of CPU_BF16_SUMS_UNFUSED) within half of the
    gap, and all of them together in the norm."""
    config = _bf16_config(mode)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    jhp = jax_model.hyper_from_config(config)
    batch = random_batch(config, np.random.default_rng(4))

    def jloss(p, cd):
        (z, zm, zl, ld, zmask), _, (attn, logw, logw_) = jax_model.forward_train(
            p, jhp, batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
            compute_dtype=cd,
        )
        loss = jax_mle_loss(z, zm, zl, ld, zmask) + jax_duration_loss(logw, logw_, batch["x_lengths"])
        return loss, (z, attn)

    res = {}
    for cd in (jnp.bfloat16, jnp.float32):
        (loss, (z, attn)), g = jax.value_and_grad(jloss, has_aux=True)(jparams, cd)
        res[cd] = (loss, z, attn, jax_checkpoint._flatten(g, ""))
    tb = training.batch_to(batch, "cpu")
    state = training.trainable_model({k: v.detach() for k, v in tmodel.flat().items()}, hp, "cpu")
    params = state.flat()
    (z, zm, zl, ld, zmask), _, (attn, logw, logw_) = model.forward_train(
        unflatten(params), hp, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"],
        compute_dtype=BF16,
    )
    assert z.dtype == BF16 and ld.dtype == torch.float32
    loss = mle_loss(z, zm, zl, ld, zmask) + duration_loss(logw, logw_, tb["x_lengths"])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jb, jf = res[jnp.bfloat16], res[jnp.float32]
    held_to_gap("loss", _np(loss), jb[0], jf[0])
    held_to_gap("z", _np(z), jb[1], jf[1])
    np.testing.assert_array_equal(attn.numpy(), np.asarray(jb[2]))
    port = {k: _np(g) for k, g in grads.items()}
    worst = max(held_to_gap(k, port[k], jb[3][k], jf[3][k])
                for k in port if k not in _cpu_bf16_sums(mode) and k != "encoder/attn/k/b")
    assert worst < 0.5
    held_in_norm("all gradients", port, jb[3], jf[3])


@pytest.mark.parametrize("mode", sorted(DECODER_MODES))
def test_train_step_trajectory_bf16_within_half_of_jax_gap(tmp_path, monkeypatch, mode):
    """Three bf16 train steps from one checkpoint on the same batches and
    the same alignment, in each of the decoder's four modes, the port's
    ``make_train_step`` against JAX's (both ``fp16_run: true``, the same
    mode), beside JAX's f32 steps: per step the losses and
    the grad norm, after the steps the params and both Adam moments of
    every leaf within half of JAX's bf16-vs-f32 gap (those of the leaves of
    CPU_BF16_SUMS and, op by op, CPU_BF16_SUMS_UNFUSED, and every leaf
    together, in the norm); the
    MAS paths equal JAX bf16's at every step."""
    orig_prenet = jax_model.prenet_apply
    monkeypatch.setattr(
        jax_model, "prenet_apply", lambda *a, **k: orig_prenet(*a, **dict(k, p_dropout=0.0))
    )
    config = _bf16_config(mode)
    config.learning_rate = 1e3
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    jhp = jax_model.hyper_from_config(config)
    configs = {True: config, False: _bf16_config(mode)}
    configs[False].learning_rate = 1e3
    configs[False].fp16_run = False
    tx = make_optimizer(config)
    jstates = {fp16: jax_training.TrainState(jparams, tx.init(jparams), jnp.int32(1))
               for fp16 in (True, False)}
    jsteps = {fp16: jax_training.make_train_step(c, mas_impl="scan", donate=False)
              for fp16, c in configs.items()}
    state = training.TrainState(training.trainable_model(
        {k: v.detach() for k, v in tmodel.flat().items()}, hp, "cpu"))
    step = training.make_train_step(config)
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = random_batch(config, rng)
        tb = training.batch_to(batch, "cpu")
        jout = jax_model.forward_train(
            jstates[True].params, jhp, batch["x"], batch["x_lengths"], batch["y"],
            batch["y_lengths"], mas_impl="scan", compute_dtype=jnp.bfloat16,
        )
        with torch.no_grad():
            tout = model.forward_train(
                state.model.tree(), hp, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"],
                compute_dtype=BF16,
            )
        np.testing.assert_array_equal(tout[2][0].numpy(), np.asarray(jout[2][0]))
        metrics = {}
        for fp16 in (True, False):
            jstates[fp16], metrics[fp16] = jsteps[fp16](
                jstates[fp16], {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(i))
        port = step(state, tb)
        for k in ("loss", "mle_loss", "duration_loss", "grad_norm"):
            held_to_gap(f"step {i} {k}", _np(port[k]), metrics[True][k], metrics[False][k])
    assert state.step == int(jstates[True].step) == 4

    def leaves(s):
        adam = s.opt_state[1]
        return [jax_checkpoint._flatten(t, "") for t in (s.params, adam.mu, adam.nu)]

    jb, jf = leaves(jstates[True]), leaves(jstates[False])
    port = [{k: _np(v) for k, v in state.model.flat().items()},
            {k: _np(v) for k, v in state.opt.mu.items()},
            {k: _np(v) for k, v in state.opt.nu.items()}]
    for what, p, b, f in zip(("params", "mu", "nu"), port, jb, jf):
        for k in p:
            if k in _cpu_bf16_sums(mode) or k == "encoder/attn/k/b":
                continue
            held_to_gap(f"{what} {k}", p[k], b[k], f[k])
        held_in_norm(what, p, b, f)

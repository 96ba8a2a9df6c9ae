"""The op-by-op text side of glow_tts_train_tpu_torch in bf16 (``fp16_run``
with ``encoder_fuse: false``, ``window_size: null`` or ``block_length``
set) on the CPU against the JAX package's XLA path in bf16, and the bf16
text chains' plans at the widths of ``configs/large.json`` and
``configs/multispeaker.json``.

Under ``fp16_run`` the JAX package computes the text side op by op where
its text kernels do not run: every conv's output and bias bf16, LayerNorm
in f32 rounded back, attention scores and the probabilities' products
accumulated in f32, the softmax f32 and its probabilities bf16.  Each test
runs the same numpy-seeded inputs through the JAX function in bf16 and in
f32 and through the port in bf16, dropout off, and holds every output and
gradient of the port within half of JAX's own bf16-vs-f32 gap of JAX bf16
(``test_torch_bf16.held_to_gap``: per tensor, in the 2-norm over its
elements), the rule ``tests/test_torch_bf16.py`` holds the kernels' bf16
plain versions to.

The JAX reference is compiled with ``xla_allow_excess_precision`` off
(:data:`EXACT`): with it on, XLA's CPU fusions keep some bf16
intermediates in f32 (inside ``encoder_apply``'s scanned layer body or a
jitted train step, not between eagerly dispatched ops), so where the
program rounds would depend on the fusion; off, every op rounds to the
dtype the program gives it, as the port does.

The JAX text side's conv biases are added through :func:`_bias_add`
(the autouse fixture :func:`f32_bias_sums`): the same forward, and the
bias's gradient summed over the rows in f32 and rounded to bf16 once, as
XLA reduces a bf16 cotangent on an accelerator and as the port's autograd
does.  XLA on the CPU reduces it in bf16 one row after another, which
puts every conv bias's gradient about one gap from the port's (the 1x1
projections' biases in ``tests/test_torch_bf16.py``, which runs the JAX
package unpatched, are held in the norm of all gradients for it).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import training as jax_training
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.models.losses import duration_loss as jax_duration_loss
from glow_tts_train_tpu.models.losses import mle_loss as jax_mle_loss
from glow_tts_train_tpu.ops import attention as jax_attention
from glow_tts_train_tpu.optimize import make_optimizer
from glow_tts_train_tpu_torch import training
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.models.losses import duration_loss, mle_loss
from glow_tts_train_tpu_torch.ops import attention, tc_gemm
from glow_tts_train_tpu_torch.tree import flatten, unflatten

from helpers import random_batch
from test_torch_bf16 import (CPU_BF16_SUMS, _bf16_config, _checkpoint, _np, held_in_norm,
                             held_to_gap)
from test_torch_bf16_encoder_tc import MAX_BLOCK_SMEM, SMS, _brute_plan
from test_torch_bf16_text_tc import TMA_COUNTS

BF16 = torch.bfloat16
H, F, F_DP, HEADS, TAPS, T = 32, 64, 48, 2, 3, 19
SEED = 7
# the JAX reference's compile options: each op rounds where the program does
EXACT = {"xla_allow_excess_precision": False}
# the leaf whose gradient is zero up to round-off (softmax over keys is
# invariant to q . b_k): both frameworks' values are noise around 0, and
# Adam's step on it noise of either sign
ZERO_GRADIENT_LEAF = "attn/k/b"




@jax.custom_vjp
def _bias_add(out, b):
    return out + b.astype(out.dtype)


def _bias_add_fwd(out, b):
    return _bias_add(out, b), b


def _bias_add_bwd(b, ct):
    db = jnp.sum(ct.astype(jnp.float32), axis=tuple(range(ct.ndim - 1)))
    return ct, db.astype(ct.dtype).astype(b.dtype)


_bias_add.defvjp(_bias_add_fwd, _bias_add_bwd)


@pytest.fixture(autouse=True)
def f32_bias_sums(monkeypatch):
    """The JAX text side's ``conv1d`` with its bias added by
    :func:`_bias_add` (module docstring): the conv with a zero bias, which
    adds nothing, then the bias."""
    orig = jax_attention.conv1d

    def conv1d(x, params, *args, **kwargs):
        out = orig(x, {**params, "b": jnp.zeros_like(params["b"])}, *args, **kwargs)
        return _bias_add(out, params["b"])

    monkeypatch.setattr(jax_attention, "conv1d", conv1d)
    monkeypatch.setattr(jax_model, "conv1d", conv1d)


def _inputs(rng, t, width):
    x = rng.standard_normal((3, t, width)).astype(np.float32)
    lengths = np.array([t, t // 2 + 1, 3])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x * mask, mask


def _perturbed(params, rng):
    """JAX init params as numpy, every leaf moved off its init (the
    prenet's zero projection, LayerNorm's ones and zeros) by a seeded
    N(0, 0.1) so that no gradient is zero by construction."""
    return {k: (np.asarray(v, np.float32)
                + 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32))
            for k, v in flatten(jax.tree_util.tree_map(np.asarray, params)).items()}


def _held_module(name, jax_fn, port_fn, params, x, mask, cot):
    """``jax_fn(params, x, mask)`` in JAX bf16 and f32 (compiled with
    EXACT) and ``port_fn`` in the port's bf16 (f32 params, bf16 x, the f32
    mask as the port's training graph passes it): the output, dx and every
    parameter gradient within half of JAX's gap -> the largest ratio."""

    def fwd_bwd(p, xx, m, c):
        out, vjp = jax.vjp(lambda pp, x2: jax_fn(pp, x2, m), p, xx)
        dp, dx = vjp(c.astype(out.dtype))
        return out, dx, dp

    res = {}
    for dt in (jnp.bfloat16, jnp.float32):
        jp = unflatten({k: jnp.asarray(v) for k, v in params.items()})
        out, dx, dp = jax.jit(fwd_bwd, compiler_options=EXACT)(
            jp, jnp.asarray(x, dt), jnp.asarray(mask, dt), jnp.asarray(cot))
        assert out.dtype == dt
        res[dt] = {"out": np.asarray(out, np.float32), "x": np.asarray(dx, np.float32),
                   **{k: np.asarray(v) for k, v in flatten(dp).items()}}
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).to(BF16).requires_grad_(True)
    out = port_fn(unflatten(tp), tx, torch.from_numpy(mask))
    assert out.dtype == BF16
    grads = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(cot).to(BF16))
    assert grads[0].dtype == BF16 and all(g.dtype == torch.float32 for g in grads[1:])
    port = {"out": _np(out), "x": _np(grads[0]), **{k: _np(g) for k, g in zip(tp, grads[1:])}}
    jb, jf = res[jnp.bfloat16], res[jnp.float32]
    return max(held_to_gap(f"{name} {k}", port[k], jb[k], jf[k])
               for k in port if not k.endswith(ZERO_GRADIENT_LEAF))


def _mask2(mask):
    m = mask[:, :, 0]
    return m[:, None, :] * m[:, :, None]


def test_prenet_op_by_op_bf16_within_half_of_jax_gap():
    """The prenet op by op (3 layers of conv5 -> LN -> ReLU, the residual
    projection) against JAX ``prenet_apply`` unfused."""
    rng = np.random.default_rng(SEED)
    params = _perturbed(jax_attention.prenet_init(jax.random.PRNGKey(1), H, H, H), rng)
    x, mask = _inputs(rng, T, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    worst = _held_module(
        "prenet",
        lambda p, xx, m: jax_attention.prenet_apply(p, xx, m, p_dropout=0.0),
        lambda p, xx, m: attention.prenet_apply(p, xx, m, 0.0),
        params, x, mask, cot)
    assert worst < 0.5


@pytest.mark.parametrize("window,block_length", [(4, None), (None, None), (None, 2), (4, 2)],
                         ids=["window4", "window_null", "block_length2", "window4_block2"])
def test_mha_op_by_op_bf16_within_half_of_jax_gap(window, block_length):
    """Self-attention with its projections against JAX ``mha_apply``: the
    rel-pos window of 4 (the kernel's configuration, here op by op), none,
    a band of 2, and both."""
    rng = np.random.default_rng(SEED + 1)
    params = _perturbed(jax_attention.mha_init(jax.random.PRNGKey(2), H, H, HEADS, window), rng)
    x, mask = _inputs(rng, T, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    worst = _held_module(
        "mha",
        lambda p, xx, m: jax_attention.mha_apply(p, xx, xx, _mask2(m), HEADS, window,
                                                 block_length),
        lambda p, xx, m: attention.mha_apply(p, xx, torch.from_numpy(_mask2(mask)), HEADS,
                                             window, block_length),
        params, x, mask, cot)
    assert worst < 0.5


def test_ffn_op_by_op_bf16_within_half_of_jax_gap():
    """The conv FFN (conv3 -> ReLU -> conv3, masked) against JAX
    ``ffn_apply``."""
    rng = np.random.default_rng(SEED + 2)
    params = _perturbed(jax_attention.ffn_init(jax.random.PRNGKey(3), H, H, F, TAPS), rng)
    x, mask = _inputs(rng, T, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    worst = _held_module(
        "ffn", jax_attention.ffn_apply, attention.ffn_apply, params, x, mask, cot)
    assert worst < 0.5


@pytest.mark.parametrize("window,block_length", [(4, None), (None, None), (None, 3)],
                         ids=["window4", "window_null", "block_length3"])
def test_encoder_stack_op_by_op_bf16_within_half_of_jax_gap(window, block_length):
    """Two encoder layers op by op against JAX ``encoder_apply`` unfused
    (its layers stacked, the port's per layer)."""
    rng = np.random.default_rng(SEED + 3)
    params = _perturbed(jax_attention.encoder_init(
        jax.random.PRNGKey(4), H, F, HEADS, 2, TAPS, window), rng)
    x, mask = _inputs(rng, T, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def port_fn(p, xx, m):
        layers = [{k: v[i] for k, v in flatten(p).items()} for i in range(2)]
        return attention.encoder_apply([unflatten(layer) for layer in layers], xx, m, HEADS,
                                       window, block_length)

    worst = _held_module(
        "encoder",
        lambda p, xx, m: jax_attention.encoder_apply(p, xx, m, HEADS, window, block_length),
        port_fn, params, x, mask, cot)
    assert worst < 0.5


@pytest.mark.parametrize("gin", [0, 12])
def test_duration_predictor_op_by_op_bf16_within_half_of_jax_gap(gin):
    """The duration predictor (2 x conv3 -> ReLU -> LN, the projection)
    against JAX ``duration_predictor_apply`` unfused, on the encoder's
    channels alone and with the speaker vector's appended."""
    rng = np.random.default_rng(SEED + 4)
    params = _perturbed(jax_model.duration_predictor_init(
        jax.random.PRNGKey(5), H + gin, F_DP, TAPS), rng)
    x, mask = _inputs(rng, T, H + gin)
    cot = rng.standard_normal((3, T, 1)).astype(np.float32)
    worst = _held_module(
        "duration_predictor",
        lambda p, xx, m: jax_model.duration_predictor_apply(p, xx, m, 0.0),
        lambda p, xx, m: attention.duration_predictor_apply(p, xx, m, 0.0),
        params, x, mask, cot)
    assert worst < 0.5


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# the op-by-op configurations: (config overrides, encoder_fuse); the last
# sets encoder_fuse true with a band the encoder kernel does not take, so
# the prenet and duration kernels run and the encoder layers op by op (JAX
# ``encoder_apply``'s own fallback)
OP_BY_OP = {
    "encoder_fuse_false": ({}, False),
    "window_null": ({"window_size": None}, "auto"),
    "block_length3": ({"block_length": 3}, True),
}


def _op_config(case, fp16=True):
    over, encoder_fuse = OP_BY_OP[case]
    config = _bf16_config("fused_store", **over)
    config.encoder_fuse = encoder_fuse
    config.fp16_run = fp16
    return config


@pytest.mark.parametrize("case", sorted(OP_BY_OP))
def test_train_step_trajectory_op_by_op_bf16_within_half_of_jax_gap(tmp_path, monkeypatch,
                                                                      case):
    """Three bf16 train steps from one checkpoint on the same batches, the
    port's ``make_train_step`` against JAX's (``fp16_run``, the text side op
    by op as the configuration resolves it, the fused decoder; JAX compiled
    with EXACT), beside JAX's f32 steps.  The first step's MAS path equals
    JAX bf16's bit for bit (the forward is exact there); every step then
    trains on JAX bf16's path, whose near-ties at init a later step's
    rounding can move in either framework.  Per step the losses and the
    grad norm within half of JAX's gap; after the steps both Adam moments
    of every leaf (but ZERO_GRADIENT_LEAF and, where the duration stack
    runs its kernel, CPU_BF16_SUMS) and the params of all leaves together
    in the norm: Adam's first update is lr * sign(g), so a gradient element
    within rounding of zero takes the other sign in either framework and a
    leaf's params differ by whole steps at a few elements."""
    orig_prenet = jax_model.prenet_apply
    monkeypatch.setattr(
        jax_model, "prenet_apply", lambda *a, **k: orig_prenet(*a, **dict(k, p_dropout=0.0))
    )
    configs = {fp16: _op_config(case, fp16) for fp16 in (True, False)}
    config = configs[True]
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    jhp = jax_model.hyper_from_config(config)
    assert hp.encoder_fuse == jhp.encoder_fuse == (case == "block_length3")
    assert not hp.encoder_kernel_fits or case == "encoder_fuse_false"
    tx = make_optimizer(config)
    jstates = {fp16: jax_training.TrainState(jparams, tx.init(jparams), jnp.int32(1))
               for fp16 in (True, False)}
    jsteps = {fp16: jax.jit(jax_training.make_train_step(c, mas_impl="scan", donate=False,
                                                         jit=False), compiler_options=EXACT)
              for fp16, c in configs.items()}
    jpath = jax.jit(lambda p, b: jax_model.forward_train(
        p, jhp, b["x"], b["x_lengths"], b["y"], b["y_lengths"], mas_impl="scan",
        compute_dtype=jnp.bfloat16)[2][0], compiler_options=EXACT)
    state = training.TrainState(training.trainable_model(
        {k: v.detach() for k, v in tmodel.flat().items()}, hp, "cpu"))
    step = training.make_train_step(config)
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = random_batch(config, rng)
        tb = training.batch_to(batch, "cpu")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with torch.no_grad():
            tout = model.forward_train(
                state.model.tree(), hp, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"],
                compute_dtype=BF16,
            )
        path = np.asarray(jpath(jstates[True].params, jb), np.float32)
        if i == 0:
            np.testing.assert_array_equal(tout[2][0].numpy(), path)
        metrics = {}
        for fp16 in (True, False):
            jstates[fp16], metrics[fp16] = jsteps[fp16](jstates[fp16], jb, jax.random.PRNGKey(i))
        with monkeypatch.context() as m:  # JAX bf16's alignment (module docstring)
            m.setattr(model.mas_cuda, "maximum_path",
                      lambda logp, mask: torch.from_numpy(path).to(logp.dtype))
            port = step(state, tb)
        for k in ("loss", "mle_loss", "duration_loss", "grad_norm"):
            held_to_gap(f"step {i} {k}", _np(port[k]), metrics[True][k], metrics[False][k])
    assert state.step == int(jstates[True].step) == 4

    def leaves(s):
        adam = s.opt_state[1]
        return [flatten(jax.tree_util.tree_map(np.asarray, t)) for t in (s.params, adam.mu, adam.nu)]

    jb, jf = leaves(jstates[True]), leaves(jstates[False])
    port = [{k: _np(v) for k, v in state.model.flat().items()},
            {k: _np(v) for k, v in state.opt.mu.items()},
            {k: _np(v) for k, v in state.opt.nu.items()}]
    skip = (ZERO_GRADIENT_LEAF,) + (CPU_BF16_SUMS if hp.encoder_fuse else ())
    for what, p, b, f in zip(("params", "mu", "nu"), port, jb, jf):
        held_in_norm(what, p, b, f)
        if what != "params":
            assert max(held_to_gap(f"{what} {k}", p[k], b[k], f[k])
                       for k in p if not k.endswith(skip)) < 0.5


def test_multispeaker_bf16_step_within_half_of_jax_gap(tmp_path):
    """``forward_train`` in bf16 plus the gradient of the loss with 3
    speakers and gin 12 in the default mode (the text kernels' plain bf16
    versions, the fused decoder with g; JAX its Pallas kernels in
    interpret mode, unpatched but for :func:`f32_bias_sums`, which none of
    these convs reaches but the 1x1 projections): the loss and z within
    half of JAX's gap, the MAS path JAX bf16's, every parameter gradient
    (the speaker embedding's among them) but ZERO_GRADIENT_LEAF's within
    half of the gap, and all together in the norm."""
    config = _bf16_config("fused_store", n_speakers=3, gin_channels=12)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    jhp = jax_model.hyper_from_config(config)
    assert hp.encoder_fuse and hp.gin_channels == 12
    batch = random_batch(config, np.random.default_rng(6), multispeaker=True)
    assert len(set(batch["speaker_ids"].tolist())) > 1

    def jloss(p, cd):
        (z, zm, zl, ld, zmask), _, (attn, logw, logw_) = jax_model.forward_train(
            p, jhp, batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
            g_ids=batch["speaker_ids"], compute_dtype=cd,
        )
        loss = jax_mle_loss(z, zm, zl, ld, zmask) + jax_duration_loss(logw, logw_,
                                                                       batch["x_lengths"])
        return loss, (z, attn)

    res = {}
    for cd in (jnp.bfloat16, jnp.float32):
        (loss, (z, attn)), g = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                                       static_argnums=1)(jparams, cd)
        res[cd] = (loss, z, attn, flatten(jax.tree_util.tree_map(np.asarray, g)))
    tb = training.batch_to(batch, "cpu")
    state = training.trainable_model({k: v.detach() for k, v in tmodel.flat().items()}, hp, "cpu")
    params = state.flat()
    (z, zm, zl, ld, zmask), _, (attn, logw, logw_) = model.forward_train(
        unflatten(params), hp, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"],
        g_ids=tb["speaker_ids"], compute_dtype=BF16,
    )
    loss = mle_loss(z, zm, zl, ld, zmask) + duration_loss(logw, logw_, tb["x_lengths"])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jb, jf = res[jnp.bfloat16], res[jnp.float32]
    held_to_gap("loss", _np(loss), jb[0], jf[0])
    held_to_gap("z", _np(z), jb[1], jf[1])
    np.testing.assert_array_equal(attn.numpy(), np.asarray(jb[2]))
    port = {k: _np(g) for k, g in grads.items()}
    assert np.abs(port["emb_g"]).sum() > 0
    worst = max(held_to_gap(k, port[k], jb[3][k], jf[3][k])
                for k in port if not k.endswith(ZERO_GRADIENT_LEAF))
    assert worst < 0.5
    held_in_norm("all gradients", port, jb[3], jf[3])


# ---------------------------------------------------------------------------
# the bf16 text chains' plans at the shipped widths
# ---------------------------------------------------------------------------

# (batch, the encoder's h and f, the duration stack's input channels and
# filters) of configs/large.json and configs/multispeaker.json
WIDTHS = {"large": (16, 256, 1024, 256, 256), "multispeaker": (32, 192, 768, 448, 256)}
TEXT_BUCKETS = (64, 128, 192)


def _width_plans(width, t):
    batch, h, f, c_dp, f_dp = WIDTHS[width]
    return {
        "encoder": [tc_gemm.bf16_encoder_products(batch, t, h, f, TAPS, SMS, bw)
                    for bw in (False, True)],
        "prenet": [tc_gemm.bf16_prenet_products(batch, t, h, 3, 5, SMS, bw)
                   for bw in (False, True)],
        "duration": [tc_gemm.bf16_duration_products(batch, t, c_dp, f_dp, TAPS, SMS, bw)
                     for bw in (False, True)],
    }


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("t", TEXT_BUCKETS)
def test_text_plans_at_the_shipped_widths(width, t):
    """The bf16 text chains at large's [16, t] (h 256, f 1024: the FFN's
    second conv-GEMM and the transposed one K 3,072) and multispeaker's
    [32, t] (the duration stack on 192 + 256 = 448 channels), at each text
    bucket: every product on the TMA-fed kernels (the encoder layer's 4 + 8
    conv-GEMMs and 4 weight gradients, the prenet's 4 + 8 and 4, the
    duration stack's 2 + 4 and 2), each conv-GEMM's chunks and split-K
    shares the brute force's, a weight gradient's tiles one wave at most,
    every ring within a block, and the backward's first products the
    forward's."""
    counts = dict(TMA_COUNTS, encoder=(
        {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 4, "bf16_tma_wgrad": 0},
        {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 8, "bf16_tma_wgrad": 4}))
    batch = WIDTHS[width][0]
    for stack, (fwd, bwd) in _width_plans(width, t).items():
        assert (fwd["counts"], bwd["counts"]) == counts[stack], stack
        n_fwd = len(fwd["products"])
        assert [p["name"] for p in bwd["products"][:n_fwd]] == [p["name"] for p in fwd["products"]]
        for p in bwd["products"]:
            assert p["unit"] == "tma" and p["smem"] <= MAX_BLOCK_SMEM, (stack, p)
            if p["kind"] == "conv_gemm":
                _, kdim, n = p["shape"]
                taps = 1 if p["name"] in ("qkv", "out_proj", "datt", "dx", "proj", "dproj") else (
                    5 if stack == "prenet" else TAPS)
                assert (p["chunks"], p["shares"]) == _brute_plan(batch, t, kdim // taps, taps, n,
                                                                 SMS), (stack, p)
            else:
                assert 1 <= p["tiles"] <= SMS, (stack, p)


def test_text_plans_at_the_longest_bucket():
    """At the corpus's longest text bucket (192): large's FFN conv-GEMMs in
    two-chunk tiles, their K walks (3 x 256 and 3 x 1,024 = 3,072) split in
    two, multispeaker's in three-chunk tiles; the duration stack's first
    conv on 448 channels unsplit; the device operations of a call (forward,
    backward): the encoder layer's 10 and 33 and the prenet's 12 and 37 at
    both widths, as at base width, the duration stack's 7 and 19 at large
    and 5 and 15 at multispeaker; the widths phase of ``chip_smoke.py``
    holds each call's device operations on the card to these plans."""
    plans = {w: _width_plans(w, 192) for w in WIDTHS}
    shares = {w: {p["name"]: (p["chunks"], p["shares"]) for p in plan["encoder"][1]["products"]
                  if p["kind"] == "conv_gemm"} for w, plan in plans.items()}
    assert shares == {
        "large": {"qkv": (3, 1), "out_proj": (2, 2), "ffn1": (2, 1), "ffn2": (2, 2),
                  "dffn": (2, 1), "dx1": (2, 2), "datt": (2, 2), "dx": (2, 2)},
        "multispeaker": {"qkv": (3, 1), "out_proj": (3, 2), "ffn1": (3, 1), "ffn2": (3, 2),
                         "dffn": (3, 1), "dx1": (3, 2), "datt": (3, 2), "dx": (3, 2)},
    }
    ffn2 = next(p for p in plans["large"]["encoder"][0]["products"] if p["name"] == "ffn2")
    assert ffn2["shape"][1] == 3 * 1024
    dp0 = next(p for p in plans["multispeaker"]["duration"][0]["products"])
    assert dp0["shape"][1] == TAPS * 448 and dp0["shares"] == 1
    launches = {w: {stack: [fb["launches"] for fb in plan[stack]] for stack in plan}
                for w, plan in plans.items()}
    assert launches == {
        "large": {"encoder": [10, 33], "prenet": [12, 37], "duration": [7, 19]},
        "multispeaker": {"encoder": [10, 33], "prenet": [12, 37], "duration": [5, 15]},
    }


def test_text_op_by_op_against_fused_bf16_as_jax(tmp_path):
    """The bf16 losses of ``forward_train`` with the text side op by op
    against the text kernels', at the text side's width of
    ``configs/base.json`` (the decoder cut to 2 blocks: it runs the same
    fused blocks both ways), dropout off, from a DDI'd init with the
    zero-initialised end convs and prenet projection moved, on four
    batches of two corpus utterances; JAX as its trainer compiles it.  The
    kernels round once where XLA rounds each op, and the alignment's
    near-ties move the duration loss with x_m.  JAX's relative difference
    is at most 3.2e-3 of the loss and 7.4e-5 of the MLE loss; the port's
    of the MLE loss, on the batch where it is largest, within half of
    JAX's largest (8.4e-5).  The port's of the loss is not held: at one of
    the four batches its kernel path's alignment takes other near-ties
    than JAX's kernels' (3.8e-2 there; its op-by-op losses are JAX's op by
    op within 1.5e-3 on every batch), which at two utterances a batch is
    a few percent of the duration loss.  Three times JAX's largest bound
    the first steps' losses of the smoke's op-by-op text side on the card
    at 32 utterances a batch (``chip_smoke.TEXT_OPS_LOSS_RTOL_BF16`` 1e-2,
    ``TEXT_OPS_MLE_RTOL_BF16`` 2.5e-4)."""
    from glow_tts_train_tpu import checkpoint as jax_checkpoint
    from glow_tts_train_tpu.config import TrainingConfig
    from glow_tts_train_tpu_torch import checkpoint
    from glow_tts_train_tpu_torch.config import load_config

    from test_torch_bf16_modes import REPO, _corpus_batches

    base = REPO / "configs" / "base.json"
    batches = _corpus_batches(tmp_path)

    def configs(fuse):
        out = (load_config([base]), TrainingConfig.load_and_merge(TrainingConfig(), [base]))
        for c in out:
            c.model.p_dropout = c.model.p_dropout_dec = 0.0
            c.model.n_blocks_dec = 2
            c.encoder_fuse, c.wn_impl, c.wn_residuals, c.flow_block_fuse = (
                fuse, "pallas", "store", True)
        return out

    def port_batch(batch):
        return training.batch_to({k: v.astype(np.int64) if v.dtype == np.int32 else v
                                  for k, v in batch.items()}, "cpu")

    flat = {k: v.detach() for k, v in training.initialize_model(
        configs(True)[0], port_batch(batches[0]), "cpu").flat().items()}
    g = torch.Generator().manual_seed(0)
    for k in flat:
        if "coupling/end" in k or "prenet/proj" in k:
            flat[k] = flat[k] + 0.02 * torch.randn(flat[k].shape, generator=g)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, {checkpoint.PREFIX + k: v.numpy() for k, v in flat.items()})
    jparams = jax_checkpoint.load_checkpoint(path, configs(True)[1], load_optimizer=False).params
    hyper = {fuse: (model.hyper_from_config(configs(fuse)[0]),
                    jax_model.hyper_from_config(configs(fuse)[1])) for fuse in (True, False)}

    def jax_losses(jhp):
        def fn(p, b):
            (z, zm, zl, ld, zmask), _, (_, logw, logw_) = jax_model.forward_train(
                p, jhp, b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                compute_dtype=jnp.bfloat16,
            )
            return (jax_mle_loss(z, zm, zl, ld, zmask),
                    jax_duration_loss(logw, logw_, b["x_lengths"]))
        return jax.jit(fn)

    jfns = {fuse: jax_losses(jhp) for fuse, (_, jhp) in hyper.items()}
    gaps = {"jax": [], "port": []}
    for batch in batches:
        tb = port_batch(batch)
        losses = {}
        for fuse, (hp, _) in hyper.items():
            losses["jax", fuse] = tuple(float(v) for v in jfns[fuse](jparams, batch))
            with torch.no_grad():
                (z, zm, zl, ld, zmask), _, (_, logw, logw_) = model.forward_train(
                    unflatten(flat), hp, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"],
                    compute_dtype=BF16,
                )
            losses["port", fuse] = (float(mle_loss(z, zm, zl, ld, zmask)),
                                    float(duration_loss(logw, logw_, tb["x_lengths"])))
        for who in gaps:
            (mf, df), (mu, du) = losses[who, True], losses[who, False]
            gaps[who].append((abs(mu + du - mf - df) / abs(mf + df), abs(mu - mf) / abs(mf)))
    worst = {who: [max(g[i] for g in gaps[who]) for i in (0, 1)] for who in gaps}
    assert abs(worst["port"][1] - worst["jax"][1]) <= 0.5 * worst["jax"][1], worst
    sys.path.insert(0, str(REPO))
    import chip_smoke

    for i, chip_rtol in ((0, chip_smoke.TEXT_OPS_LOSS_RTOL_BF16),
                         (1, chip_smoke.TEXT_OPS_MLE_RTOL_BF16)):
        assert 0.0 < 3 * worst["jax"][i] <= chip_rtol, worst

"""The decoder's training and serving modes of glow_tts_train_tpu_torch
against the JAX package on the CPU: the differentiable WN stack in both
residual modes, the op-by-op decoder forward against the fused one and
the fused inverse, the resolution of the config keys that pick the mode
(``wn_residuals``, ``flow_block_fuse``; ``wn_impl`` and
``flow_block_fuse_reverse`` have one value each) and what the CLIs do with
them.

The port runs its plain PyTorch versions (CPU tensors); JAX runs its
Pallas kernels in interpret mode, dropout on through the portable bits,
with the same seed.  Inputs and weights come from a numpy seed
(``checkpoint.random_params``: no zero-initialised leaf hides a term).
The fused block with ``residuals="recompute"`` is held in
``test_torch_train_ops.py``, the 3-step training trajectory of each mode in
``test_torch_train.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.ops import flows as jax_flows
from glow_tts_train_tpu.ops import wn_pallas
from glow_tts_train_tpu_torch import checkpoint, training
from glow_tts_train_tpu_torch.config import TrainingConfig, load_config
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import block_cuda, conv, flows, wn_cuda
from glow_tts_train_tpu_torch.tree import flatten, tree_index, unflatten

from helpers import random_batch, tiny_config

CASES = {
    "plain": {},
    "gin_dilation2_sigmoid": {
        "n_speakers": 3, "gin_channels": 6, "dilation_rate": 2, "sigmoid_scale": True,
        "hidden_channels_dec": 32,
    },
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _checkpoint(tmp_path, config, seed=0):
    hp = model.hyper_from_config(config)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, checkpoint.random_params(hp, seed))
    jparams = jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    tmodel, _ = checkpoint.load_checkpoint(path, hp)
    return jparams, tmodel, hp


def _ragged(rng, b, t, c):
    """x [b, t, c] and its mask, lengths t, t - 8 and 4 (even for even t, so
    the squeeze by 2 drops no valid frame)."""
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    lengths = np.array([t, t - 8, 4][:b])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)[..., None]
    return x * mask, mask


def _close(name, port, ref, rtol):
    """max abs err within ``rtol`` of max |ref|."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        port.detach().numpy(), ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-6), err_msg=name
    )


# ---------------------------------------------------------------------------
# the WN stack with its own backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("p_dropout", [0.0, 0.05])
@pytest.mark.parametrize("residuals", ["recompute", "store"])
def test_wn_stack_train_matches_jax(tmp_path, residuals, p_dropout, case):
    """wn_stack_train + autograd against wn_pallas.wn_stack_fused +
    jax.vjp (interpret mode: the forward, forward-save, backward and
    backward-store kernels) on the same folded weights, seed and
    cotangent: the skip sum and dx, dW_in, db_in, dW_rs, db_rs, dg, each
    within 1e-5 of its own max (f32 on both sides, two summation orders)."""
    config = tiny_config(**CASES[case])
    _, tmodel, hp = _checkpoint(tmp_path, config)
    L, h, K = hp.n_block_layers, hp.h_dec, hp.kernel_size_dec
    rng = np.random.default_rng(11)
    x, mask = _ragged(rng, 3, 24, h)
    conditioned = hp.gin_channels > 0
    g_all = rng.standard_normal((3, L, 2 * h)).astype(np.float32) if conditioned else None
    dout = rng.standard_normal(x.shape).astype(np.float32)
    seed = 2 ** 31 - 9
    wn_t = tree_index(tmodel.tree()["decoder"]["blocks"]["coupling"]["wn"], 1)
    folded = [w.detach().clone().requires_grad_(True) for w in wn_cuda.fold_wn_weights(wn_t, L)]
    xt = _t(x).requires_grad_(True)
    gt = _t(g_all).requires_grad_(True) if conditioned else None

    def f(W_in, b_in, W_rs, b_rs, xx, gg):
        return wn_pallas.wn_stack_fused(
            W_in, b_in, W_rs, b_rs, xx, jnp.asarray(mask), gg, jnp.int32(seed),
            kernel_size=K, dilation_rate=hp.dilation_rate, n_layers=L,
            p_dropout=p_dropout, deterministic=p_dropout == 0.0,
            interpret=True, residuals=residuals,
        )

    g_j = jnp.asarray(g_all) if conditioned else jnp.zeros((3, L, 2 * h), jnp.float32)
    skip_j, vjp = jax.vjp(f, *(jnp.asarray(w.detach().numpy()) for w in folded), jnp.asarray(x), g_j)
    ref = vjp(jnp.asarray(dout))

    skip_t = wn_cuda.wn_stack_train(
        tuple(folded), gt, xt, _t(mask), K, hp.dilation_rate, p_dropout, seed, residuals
    )
    _close("skip", skip_t, skip_j, 1e-5)
    inputs = folded + [xt] + ([gt] if conditioned else [])
    grads = torch.autograd.grad((skip_t * _t(dout)).sum(), inputs)
    for name, grad, r in zip(("dW_in", "db_in", "dW_rs", "db_rs", "dx", "dg"), grads, ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        _close(name, grad, r, 1e-5)


def test_wn_stack_train_refuses_an_unknown_residuals_mode():
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="residuals"):
        wn_cuda.wn_stack_train((None,) * 4, None, x, x[..., :1], 3, 1, residuals="none")
    with pytest.raises(ValueError, match="residuals"):
        block_cuda.block_forward({}, None, x, x[..., :1], 3, 1, residuals="none")


# ---------------------------------------------------------------------------
# the decoder, op by op
# ---------------------------------------------------------------------------


def _decoder_case(tmp_path, case, **over):
    config = tiny_config(**CASES[case], **over)
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    rng = np.random.default_rng(6)
    y, mask = _ragged(rng, 3, 26, hp.out_channels)
    g = None
    if hp.gin_channels:
        g = rng.standard_normal((3, 1, hp.gin_channels)).astype(np.float32)
    return jparams, tmodel, hp, y, mask, g


def _jax_decoder_hyper(hp, **over):
    jhp = jax_model.GlowTTSHyper(
        n_vocab=hp.n_vocab, hidden_channels=hp.hidden_channels, filter_channels=hp.filter_channels,
        filter_channels_dp=hp.filter_channels_dp, out_channels=hp.out_channels,
        n_blocks_dec=hp.n_blocks_dec, kernel_size_dec=hp.kernel_size_dec,
        dilation_rate=hp.dilation_rate, n_block_layers=hp.n_block_layers,
        p_dropout_dec=0.0, gin_channels=hp.gin_channels, n_split=hp.n_split, n_sqz=hp.n_sqz,
        sigmoid_scale=hp.sigmoid_scale, hidden_channels_dec=hp.hidden_channels_dec,
        unroll=True, remat=False, **over,
    )
    return jhp.decoder


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jax_wn_impl", ["pallas", "xla"])
def test_decoder_fwd_op_by_op_matches_fused_and_jax(tmp_path, jax_wn_impl, case):
    """decoder_fwd with ``block_fuse=False`` (dropout off) against the
    port's fused decoder_fwd, z, logdet (1e-5 of max) and the gradient of
    every raw block parameter and of the input (1e-4 of its max: the fused
    form differentiates through the folds), and against JAX decoder_fwd
    with ``block_fuse=False`` under either of JAX's WN implementations
    (1e-5)."""
    jparams, tmodel, hp, y, mask, g = _decoder_case(tmp_path, case)
    kwargs = dict(model._decoder_kwargs(hp), n_split=hp.n_split)
    dz = _t(np.random.default_rng(8).standard_normal(y.shape).astype(np.float32))
    outs = []
    for fuse in (False, True):
        flat = {
            k: v.clone().requires_grad_(True)
            for k, v in flatten(tmodel.tree()["decoder"]["blocks"]).items()
        }
        yt = _t(y).requires_grad_(True)
        z, logdet = flows.decoder_fwd(
            unflatten(flat), yt, _t(mask), g=None if g is None else _t(g), block_fuse=fuse, **kwargs
        )
        grads = torch.autograd.grad((z * dz).sum() + logdet.sum(), [yt, *flat.values()])
        outs.append((z, logdet, dict(zip(["y", *flat], grads))))
    (z_u, ld_u, grads_u), (z_f, ld_f, grads_f) = outs
    _close("z vs fused", z_u, z_f.detach().numpy(), 1e-5)
    _close("logdet vs fused", ld_u, ld_f.detach().numpy(), 1e-5)
    for k, grad in grads_u.items():
        _close(f"d {k} vs fused", grad, grads_f[k].numpy(), 1e-4)

    jhp = _jax_decoder_hyper(hp, block_fuse=False, wn_impl=jax_wn_impl, wn_residuals="store")
    z_j, ld_j = jax_flows.decoder_fwd(
        jparams["decoder"], jnp.asarray(y), jnp.asarray(mask), jhp,
        g=None if g is None else jnp.asarray(g),
    )
    _close("z vs jax", z_u, z_j, 1e-5)
    _close("logdet vs jax", ld_u, ld_j, 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jax_wn_impl", ["pallas", "xla"])
def test_decoder_inv_inverts_the_op_by_op_forward_and_matches_jax_op_by_op(
    tmp_path, jax_wn_impl, case
):
    """The (fused) decoder_inv of the op-by-op decoder_fwd's z gives back
    y (1e-4: two passes of the blocks, each scaling by exp(+-logs)), and
    matches JAX decoder_inv run op by op (``block_fuse_reverse=False``,
    either of JAX's WN implementations; 1e-5 of max |mel|)."""
    jparams, tmodel, hp, y, mask, g = _decoder_case(tmp_path, case)
    gt = None if g is None else _t(g)
    blocks = tmodel.tree()["decoder"]["blocks"]
    with torch.no_grad():
        z, _ = flows.decoder_fwd(blocks, _t(y), _t(mask), g=gt, n_split=hp.n_split,
                                 block_fuse=False, **model._decoder_kwargs(hp))
        folded, cond = flows.decoder_store_inverse(blocks, hp.n_block_layers, hp.n_split)
        g_all = None
        if gt is not None:
            g_all = [conv.conv1d(gt, c).reshape(3, hp.n_block_layers, 2 * hp.h_dec) for c in cond]
        y_f = flows.decoder_inv(
            folded, z, _t(mask), kernel_size=hp.kernel_size_dec, dilation_rate=hp.dilation_rate,
            n_sqz=hp.n_sqz, sigmoid_scale=hp.sigmoid_scale, g_all=g_all,
        )
    _close("inverse of forward", y_f, y, 1e-4)
    jhp = _jax_decoder_hyper(hp, block_fuse_reverse=False, wn_impl=jax_wn_impl)
    y_j, _ = jax_flows.decoder_inv(
        jax_flows.decoder_store_inverse(jparams["decoder"]), jnp.asarray(z.numpy()),
        jnp.asarray(mask), jhp, g=None if g is None else jnp.asarray(g),
    )
    _close("vs jax", y_f, y_j, 1e-5)


# ---------------------------------------------------------------------------
# the config keys
# ---------------------------------------------------------------------------

RESOLUTION = [
    # (config overrides, expected (wn_residuals, block_fuse))
    ({}, ("store", True)),
    ({"wn_residuals": "recompute"}, ("recompute", True)),
    ({"wn_residuals": "store"}, ("store", True)),
    ({"flow_block_fuse": False}, ("store", False)),
    ({"flow_block_fuse": False, "wn_residuals": "recompute"}, ("recompute", False)),
    ({"flow_block_fuse": True, "wn_residuals": "recompute"}, ("recompute", True)),
    ({"wn_impl": "pallas", "flow_block_fuse_reverse": True}, ("store", True)),
    ({"wn_impl": "pallas", "flow_block_fuse": False, "flow_block_fuse_reverse": True,
      "wn_residuals": "recompute"}, ("recompute", False)),
    ({"wn_impl": "auto", "flow_block_fuse": "auto", "flow_block_fuse_reverse": "auto",
      "wn_residuals": "auto"}, ("store", True)),
]


@pytest.mark.parametrize("over,expected", RESOLUTION, ids=[json.dumps(o) for o, _ in RESOLUTION])
def test_hyper_from_config_resolves_the_decoder_mode(over, expected):
    """"auto" resolves to the fused block with stored residuals; an
    explicit value wins; check_trainable accepts every such value."""
    config = TrainingConfig.from_dict(over)
    hp = model.hyper_from_config(config)
    assert (hp.wn_residuals, hp.block_fuse) == expected
    training.check_trainable(config)


@pytest.mark.parametrize(
    "key,value",
    [("wn_residuals", "none"), ("wn_residuals", True), ("wn_impl", "cuda"),
     ("flow_block_fuse", "yes"), ("flow_block_fuse", 1), ("flow_block_fuse_reverse", "no"),
     # values the JAX package takes and the port has no second path for
     ("wn_impl", "xla"), ("flow_block_fuse_reverse", False)],
)
def test_hyper_from_config_refuses_values_it_cannot_honour(key, value):
    config = TrainingConfig.from_dict({key: value})
    with pytest.raises(ValueError, match=key):
        model.hyper_from_config(config)
    with pytest.raises(ValueError, match=key):
        training.check_trainable(config)


@pytest.mark.parametrize(
    "over,calls",
    [
        ({}, {"block_forward": ["store"] * 2}),
        ({"wn_residuals": "recompute"}, {"block_forward": ["recompute"] * 2}),
        ({"flow_block_fuse": False}, {"wn_stack_train": ["store"] * 2}),
        ({"flow_block_fuse": False, "wn_residuals": "recompute"},
         {"wn_stack_train": ["recompute"] * 2}),
    ],
    ids=["auto", "recompute", "unfused", "unfused_recompute"],
)
def test_the_decoder_mode_keys_change_what_a_train_step_runs(monkeypatch, over, calls):
    """One train step under each mode calls the decoder entry point the mode
    names, once per block, with the configured ``residuals`` (before the
    keys were read, every mode ran ``block_forward`` in store mode)."""
    config = tiny_config()
    for key, value in over.items():
        setattr(config, key, value)
    seen: dict = {}

    def spy(module, name, residuals_at):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen.setdefault(name, []).append(
                args[residuals_at] if len(args) > residuals_at else kwargs.get("residuals", "store")
            )
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(block_cuda, "block_forward", 9)
    spy(wn_cuda, "wn_stack_train", 8)
    hp = model.hyper_from_config(config)
    flat = {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, 0).items()}
    state = training.TrainState(training.trainable_model(flat, hp, "cpu"))
    batch = training.batch_to(random_batch(config, np.random.default_rng(0)), "cpu")
    metrics = training.make_train_step(config)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert seen == calls


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 utterances of numpy mels, the tiny config without dropout, and an
    init checkpoint (global step 1) written by the port."""
    tmp = tmp_path_factory.mktemp("decoder_modes_cli")
    rng = np.random.default_rng(0)
    mels_dir = tmp / "mels"
    mels_dir.mkdir()
    with open(tmp / "phonemes.csv", "w") as f:
        for i in range(16):
            n = int(rng.integers(4, 10))
            f.write(f"u{i:02d}|{' '.join(map(str, rng.integers(1, 20, n)))}\n")
            mel = rng.standard_normal((8, int(rng.integers(2 * n + 2, 40))))
            np.save(mels_dir / f"u{i:02d}.npy", mel.astype(np.float32))
    config = {
        "epochs": 1, "batch_size": 8, "warmup_steps": 10, "bucket_size_text": 8,
        "bucket_size_mel": 16, "encoder_fuse": False, "fp16_run": False, "prefetch_batches": 0,
        "audio": {"mel_channels": 8},
        "model": {
            "num_symbols": 20, "hidden_channels": 16, "filter_channels": 32,
            "filter_channels_dp": 16, "n_blocks_dec": 2, "n_layers_enc": 2,
            "n_block_layers": 2, "hidden_channels_enc": 16, "hidden_channels_dec": 16,
            "p_dropout": 0.0, "p_dropout_dec": 0.0, "prenet": False,
        },
    }
    (tmp / "config.json").write_text(json.dumps(config))
    hp = model.hyper_from_config(load_config([tmp / "config.json"]))
    checkpoint.save_npz(tmp / "init.npz", checkpoint.random_params(hp, 3))
    return tmp


def _train_cli(corpus, out, over, checkpoint_path):
    override = corpus / f"{out}.json"
    override.write_text(json.dumps(over))
    return subprocess.run(
        [sys.executable, "-m", "glow_tts_train_tpu_torch", "--output", str(corpus / out),
         "--dataset", "0", str(corpus / "phonemes.csv"), str(corpus / "mels"), "--mels-dir",
         "--config", str(corpus / "config.json"), "--config", str(override),
         "--metrics-file", str(corpus / f"{out}.jsonl"), "--checkpoint", str(checkpoint_path),
         "--platform", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=600,
    )


def test_train_cli_trains_in_every_decoder_mode_from_one_checkpoint(corpus):
    """The train CLI from one checkpoint under the default mode and the
    three others, dropout off: the epoch's avg_loss agrees within 1e-4
    relative (the modes compute one function); a checkpoint written under
    one mode then trains under another and serves through the infer CLI."""
    modes = {
        "auto": {},
        "fused_recompute": {"wn_residuals": "recompute"},
        "unfused_store": {"flow_block_fuse": False},
        "unfused_recompute": {"flow_block_fuse": False, "wn_residuals": "recompute"},
    }
    losses = {}
    for name, over in modes.items():
        proc = _train_cli(corpus, name, over, corpus / "init.npz")
        assert proc.returncode == 0, proc.stderr[-3000:]
        (line,) = [json.loads(l) for l in open(corpus / f"{name}.jsonl")]
        losses[name] = line["avg_loss"]
    for name, loss in losses.items():
        assert loss == pytest.approx(losses["auto"], rel=1e-4), losses
    written = corpus / "unfused_recompute" / "checkpoint_3.npz"
    proc = _train_cli(corpus, "again", {"wn_residuals": "store"}, written)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [json.loads(l) for l in open(corpus / "again.jsonl")]
    assert line["global_step"] == 5 and np.isfinite(line["avg_loss"])

    proc = subprocess.run(
        [sys.executable, "-m", "glow_tts_train_tpu_torch.infer", str(written),
         "--config", str(corpus / "config.json"), "--noise-scale", "0", "--platform", "cpu"],
        input="3 7 12 5 9 14\n", env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    mel = np.asarray(json.loads(proc.stdout.splitlines()[0])["mel"], np.float32)
    assert mel.shape[0] == 8 and mel.shape[1] > 0 and np.isfinite(mel).all()


@pytest.mark.parametrize(
    "cli,key,value",
    [("train", "wn_residuals", "sometimes"), ("train", "flow_block_fuse", "no"),
     ("train", "wn_impl", "triton"), ("train", "flow_block_fuse_reverse", 2),
     ("infer", "flow_block_fuse_reverse", "no"),
     ("train", "wn_impl", "xla"), ("train", "flow_block_fuse_reverse", False),
     ("infer", "wn_impl", "xla"), ("infer", "flow_block_fuse_reverse", False)],
)
def test_clis_refuse_a_decoder_mode_they_cannot_honour(corpus, cli, key, value):
    """Exit 2 with the key named, before anything loads or trains."""
    if cli == "train":
        out = f"refuse_{key}_{value}"
        proc = _train_cli(corpus, out, {key: value}, corpus / "init.npz")
        assert not (corpus / f"{out}.jsonl").exists()
    else:
        override = corpus / "refuse_infer.json"
        override.write_text(json.dumps({key: value}))
        proc = subprocess.run(
            [sys.executable, "-m", "glow_tts_train_tpu_torch.infer", str(corpus / "init.npz"),
             "--config", str(corpus / "config.json"), "--config", str(override), "--platform", "cpu"],
            input="3 7 12\n", env=_env(), capture_output=True, text=True, timeout=300,
        )
        assert proc.stdout == ""
    assert proc.returncode == 2 and key in proc.stderr, proc.stderr[-2000:]


def test_train_cli_refuses_a_checkpoint_format_it_cannot_write(corpus):
    """``checkpoint_format`` is read: any value but "npz" (the only format
    this trainer writes) exits 2 with the key named, before the corpus
    loads or a step trains."""
    proc = _train_cli(corpus, "refuse_orbax", {"checkpoint_format": "orbax"}, corpus / "init.npz")
    assert proc.returncode == 2 and "checkpoint_format" in proc.stderr, proc.stderr[-2000:]
    assert not (corpus / "refuse_orbax.jsonl").exists()
    assert not (corpus / "refuse_orbax").exists() or not list((corpus / "refuse_orbax").iterdir())

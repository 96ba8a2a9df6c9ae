"""Training with glow_tts_train_tpu_torch against the JAX package on the
CPU: a 3-step train-step trajectory (losses, grad norm, MAS paths, params
and both Adam moments), and the two train CLIs on one corpus from one
checkpoint.

Dropout is off on both sides so that the two frameworks' different
random streams do not enter: p_dropout = p_dropout_dec = 0, and the
JAX prenet's fixed p = 0.5 is patched to 0 at run time for the
trajectory (the port's step takes no generator, hence no dropout), the
CLI runs use ``prenet: false``.  Both sides run once with ``encoder_fuse:
false`` (op-by-op text side) and once with ``encoder_fuse: true`` (the
text kernels: JAX in Pallas interpret mode, the port through its
``autograd.Function``s on their plain versions), in f32 (``fp16_run:
false``); JAX runs its XLA decoder and scan MAS.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu import training as jax_training
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.optimize import make_optimizer
from glow_tts_train_tpu_torch import checkpoint, training
from glow_tts_train_tpu_torch.config import load_config
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.optimize import current_lr

from helpers import random_batch, tiny_config

# base lr of the trajectory: Noam at hidden 16, warmup 4000 gives about
# 1e-3, 2e-3, 3e-3 at steps 1-3
LR_TRAJECTORY = 1e3

TRAJECTORY = {
    "base": {},
    "mean_only_false": {"mean_only": False},
    "multispeaker": {"n_speakers": 3, "gin_channels": 8, "sigmoid_scale": True},
}


# the decoder's other training configurations: the fused block with
# recomputed residuals, and the op-by-op decoder around the WN kernels in
# both residual modes.  wn_impl is spelled out for JAX, whose "auto" is
# "xla" on the CPU; "pallas" runs its kernels in interpret mode.
DECODER_MODES = {
    "fused_recompute": {"wn_impl": "pallas", "flow_block_fuse": True, "wn_residuals": "recompute"},
    "unfused_store": {"wn_impl": "pallas", "flow_block_fuse": False, "wn_residuals": "store"},
    "unfused_recompute": {"wn_impl": "pallas", "flow_block_fuse": False, "wn_residuals": "recompute"},
}


def _train_config(over, encoder_fuse=False, decoder_mode=None):
    config = tiny_config(**over)
    config.model.p_dropout = 0.0
    config.model.p_dropout_dec = 0.0
    config.encoder_fuse = encoder_fuse
    for key, value in (decoder_mode or {}).items():
        setattr(config, key, value)
    return config


@pytest.mark.parametrize("name", sorted(TRAJECTORY))
def test_train_step_trajectory_matches_jax(tmp_path, monkeypatch, name):
    """The 3-step trajectory (:func:`_trajectory`) with the op-by-op text
    side."""
    _trajectory(tmp_path, monkeypatch, name, encoder_fuse=False)


@pytest.mark.parametrize("name", sorted(TRAJECTORY))
def test_train_step_trajectory_matches_jax_with_encoder_fuse(tmp_path, monkeypatch, name):
    """The 3-step trajectory with ``encoder_fuse: true`` on both sides: the
    prenet, every encoder layer and the duration stack through the text
    kernels' custom backward (JAX: Pallas interpret mode)."""
    _trajectory(tmp_path, monkeypatch, name, encoder_fuse=True)


@pytest.mark.parametrize("name", ["base", "multispeaker"])
@pytest.mark.parametrize("mode", sorted(DECODER_MODES))
def test_train_step_trajectory_matches_jax_in_decoder_mode(tmp_path, monkeypatch, mode, name):
    """The 3-step trajectory in each of :data:`DECODER_MODES` on both sides
    (JAX: the block or WN Pallas kernels in interpret mode with that
    backward; the port: the same graph over the plain versions), op-by-op
    text side, same tolerances."""
    _trajectory(tmp_path, monkeypatch, name, encoder_fuse=False, decoder_mode=DECODER_MODES[mode])


def _trajectory(tmp_path, monkeypatch, name, encoder_fuse, decoder_mode=None):
    """Three steps from the same params on the same batches: per step
    loss, mle and duration loss and grad_norm within 1e-5 relative and
    the MAS path identical; after the steps both Adam moments within atol
    1e-5, and each leaf's change of params within 1e-3 of that leaf's
    largest change in JAX.  The lr is raised so that an update shows: each
    Adam step moves an element by up to lr (about 1e-3, 2e-3, 3e-3 here),
    and the two frameworks' changes differ by at most 2e-4 of their size
    (f32 round-off through 3 steps), so a missing or wrong update fails by
    orders of magnitude."""
    orig_prenet = jax_model.prenet_apply
    monkeypatch.setattr(
        jax_model, "prenet_apply", lambda *a, **k: orig_prenet(*a, **dict(k, p_dropout=0.0))
    )
    config = _train_config(TRAJECTORY[name], encoder_fuse, decoder_mode)
    config.learning_rate = LR_TRAJECTORY
    hp = model.hyper_from_config(config)
    assert hp.encoder_fuse == encoder_fuse
    ms = hp.n_speakers > 1
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, checkpoint.random_params(hp, 1))
    jparams = jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    flat, _ = checkpoint.read_npz(path)
    state = training.TrainState(training.trainable_model(
        {k[len("model/"):]: v for k, v in flat.items()}, hp, "cpu"
    ))
    before = {k: p.detach().clone().numpy() for k, p in state.model.flat().items()}
    tx = make_optimizer(config)
    jstate = jax_training.TrainState(jparams, tx.init(jparams), jnp.int32(1))
    jstep = jax_training.make_train_step(config, mas_impl="scan", donate=False)
    step = training.make_train_step(config)
    jhp = jax_model.hyper_from_config(config)
    assert jhp.encoder_fuse == encoder_fuse
    for key in ("wn_residuals", "block_fuse"):
        if decoder_mode is not None:  # both packages resolved the keys alike
            assert getattr(hp, key) == getattr(jhp, key), key
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = random_batch(config, rng, multispeaker=ms)
        tb = training.batch_to(batch, "cpu")
        # MAS paths on this step's params
        jout = jax_model.forward_train(
            jstate.params, jhp, batch["x"], batch["x_lengths"], batch["y"],
            batch["y_lengths"], g_ids=batch.get("speaker_ids"), mas_impl="scan",
        )
        with torch.no_grad():
            tout = model.forward_train(
                state.model.tree(), hp, tb["x"], tb["x_lengths"], tb["y"],
                tb["y_lengths"], g_ids=tb.get("speaker_ids"),
            )
        np.testing.assert_array_equal(tout[2][0].numpy(), np.asarray(jout[2][0]))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(i))
        metrics = step(state, tb)
        for k in ("loss", "mle_loss", "duration_loss", "grad_norm"):
            assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5), (i, k)
    assert state.step == int(jstate.step) == 4
    jflat = jax_checkpoint._flatten(jstate.params, "")
    adam = jstate.opt_state[1]
    jmu, jnu = jax_checkpoint._flatten(adam.mu, ""), jax_checkpoint._flatten(adam.nu, "")
    assert state.opt.count == int(adam.count) == 3
    lr_sum = sum(current_lr(config, s) for s in (1, 2, 3))
    for k, p in state.model.flat().items():
        delta, jdelta = p.detach().numpy() - before[k], np.asarray(jflat[k]) - before[k]
        if k == "encoder/attn/k/b":
            # softmax over keys is invariant to q . b_k, so this gradient
            # is 0 up to round-off and Adam's sign on it is arbitrary: both
            # steps are bounded by lr (1 - b1 = 0.1 <= sqrt(1 - b2) = 0.14)
            assert np.abs(delta).max() <= lr_sum and np.abs(jdelta).max() <= lr_sum, k
        else:
            np.testing.assert_allclose(
                delta, jdelta, rtol=0, atol=1e-3 * np.abs(jdelta).max(), err_msg=k
            )
        np.testing.assert_allclose(state.opt.mu[k].numpy(), np.asarray(jmu[k]), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(state.opt.nu[k].numpy(), np.asarray(jnu[k]), rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the train CLIs
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # --platform cpu does the forcing
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    return env


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 utterances of numpy mels and the tiny config without dropout."""
    tmp = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    mels_dir = tmp / "mels"
    mels_dir.mkdir()
    with open(tmp / "phonemes.csv", "w") as f:
        for i in range(24):
            n = int(rng.integers(4, 10))
            f.write(f"u{i:02d}|{' '.join(map(str, rng.integers(1, 20, n)))}\n")
            mel = rng.standard_normal((8, int(rng.integers(2 * n + 2, 40))))
            np.save(mels_dir / f"u{i:02d}.npy", mel.astype(np.float32))
    config = {
        "epochs": 2, "batch_size": 8, "warmup_steps": 10, "bucket_size_text": 8,
        "bucket_size_mel": 16, "encoder_fuse": False, "fp16_run": False,
        "prefetch_batches": 0,
        "audio": {"mel_channels": 8},
        "model": {
            "num_symbols": 20, "hidden_channels": 16, "filter_channels": 32,
            "filter_channels_dp": 16, "n_blocks_dec": 2, "n_layers_enc": 2,
            "n_block_layers": 2, "hidden_channels_enc": 16, "hidden_channels_dec": 16,
            "p_dropout": 0.0, "p_dropout_dec": 0.0, "prenet": False,
        },
    }
    with open(tmp / "config.json", "w") as f:
        json.dump(config, f)
    return tmp


def _train(module, corpus, out, *extra):
    return subprocess.run(
        [sys.executable, "-m", module, "--output", str(corpus / out),
         "--dataset", "0", str(corpus / "phonemes.csv"), str(corpus / "mels"), "--mels-dir",
         "--config", str(corpus / "config.json"), "--metrics-file", str(corpus / f"{out}.jsonl"),
         *extra],
        env=_env(), capture_output=True, text=True, timeout=600,
    )


def _both_clis(corpus, tag, *extra):
    """Both train CLIs from the same JAX-initialised checkpoint (so neither
    does DDI), 2 epochs of 3 steps: the per-epoch avg_loss lines agree
    within 1e-4 relative.  -> (the config, the port's output directory)."""
    from glow_tts_train_tpu.config import TrainingConfig

    configs = [corpus / "config.json", *(Path(e) for e in extra[1::2])]
    config = TrainingConfig.load_and_merge(TrainingConfig(), configs)
    params = jax_model.init_model(jax.random.PRNGKey(3), jax_model.hyper_from_config(config))
    init = corpus / f"init_{tag}.npz"
    jax_checkpoint.save_checkpoint(
        jax_checkpoint.Checkpoint(params=params, learning_rate=1.0, global_step=1, version=1), init
    )
    jproc = _train("glow_tts_train_tpu", corpus, f"jax_{tag}", "--checkpoint", str(init),
                   "--platform", "cpu", "--no-mesh", "--mas-impl", "scan", *extra)
    assert jproc.returncode == 0, jproc.stderr[-3000:]
    tproc = _train("glow_tts_train_tpu_torch", corpus, f"port_{tag}", "--checkpoint", str(init),
                   "--platform", "cpu", *extra)
    assert tproc.returncode == 0, tproc.stderr[-3000:]
    jlines = [json.loads(l) for l in open(corpus / f"jax_{tag}.jsonl")]
    tlines = [json.loads(l) for l in open(corpus / f"port_{tag}.jsonl")]
    assert [l["global_step"] for l in tlines] == [l["global_step"] for l in jlines] == [4, 7]
    for t, j in zip(tlines, jlines):
        assert t["avg_loss"] == pytest.approx(j["avg_loss"], rel=1e-4)
        assert t["learning_rate"] == pytest.approx(j["learning_rate"], rel=1e-6)
    return config, corpus / f"port_{tag}"


def test_train_clis_match_from_one_checkpoint_with_encoder_fuse(corpus, tmp_path):
    """Both CLIs with ``encoder_fuse: true`` (the encoder layers and the
    duration stack through the text kernels on both sides; no prenet, whose
    fixed p = 0.5 dropout the two frameworks draw from different streams):
    the epoch lines agree."""
    override = tmp_path / "fuse.json"
    override.write_text(json.dumps({"encoder_fuse": True}))
    config, _ = _both_clis(corpus, "fuse", "--config", str(override))
    assert config.encoder_fuse is True


def test_train_clis_match_from_one_checkpoint(corpus):
    """Both CLIs from the same JAX-initialised checkpoint (so neither does
    DDI), 2 epochs of 3 steps: the per-epoch avg_loss lines agree within
    1e-4 relative; the port's checkpoint loads in JAX's loader and serves
    through the port's infer CLI."""
    config, out = _both_clis(corpus, "plain")
    ckpt = out / "checkpoint_7.npz"
    loaded = jax_checkpoint.load_checkpoint(ckpt, config, load_optimizer=False)
    assert loaded.global_step == 7
    saved, _ = checkpoint.read_npz(ckpt)
    loaded_flat = jax_checkpoint._flatten(loaded.params, "model/")
    assert set(loaded_flat) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(loaded_flat[k]), v)
    assert (out / "config_7.json").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "glow_tts_train_tpu_torch.infer", str(ckpt),
         "--config", str(out / "config_7.json"), "--platform", "cpu"],
        input="3 7 12 5 9\n", env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    mel = np.asarray(json.loads(proc.stdout.splitlines()[0])["mel"])
    assert mel.shape[0] == 8 and np.isfinite(mel).all()


def test_train_cli_fresh_init_with_ddi(corpus):
    """Without --checkpoint the port initialises fresh, runs DDI on the
    first batch and trains to finite losses."""
    proc = _train("glow_tts_train_tpu_torch", corpus, "fresh", "--platform", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "data-dependent initialization" in proc.stderr
    lines = [json.loads(l) for l in open(corpus / "fresh.jsonl")]
    assert len(lines) == 2 and all(np.isfinite(l["avg_loss"]) for l in lines)


def test_train_cli_cuda_without_gpu_and_unported_options_exit_non_zero(corpus, tmp_path):
    """--platform cuda (the default) never drops to the CPU; fp16_run
    (refused until bf16 training was ported) trains in bf16 with the text
    kernels and writes checkpoints the JAX loader reads; fp16_run with the
    text side op by op (``encoder_fuse: false``, the corpus config's;
    refused until its bf16 version was ported) trains; grad_accum_steps >
    1, refused until it was ported, trains."""
    probe = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
        capture_output=True, text=True, env=_env(), timeout=120,
    )
    if probe.stdout.strip() != "True":
        proc = _train("glow_tts_train_tpu_torch", corpus, "nogpu")
        assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    cases = (
        ("fp16_run", {"fp16_run": True, "encoder_fuse": "auto"}),
        ("fp16_run_op_by_op", {"fp16_run": True}),
        ("grad_accum_steps", {"grad_accum_steps": 2}),
    )
    for tag, over in cases:
        override = tmp_path / f"{tag}.json"
        override.write_text(json.dumps(over))
        proc = _train("glow_tts_train_tpu_torch", corpus, tag, "--platform", "cpu",
                      "--config", str(override))
        assert proc.returncode == 0 and "ROADMAP" not in proc.stderr, proc.stderr[-2000:]
        lines = [json.loads(l) for l in open(corpus / f"{tag}.jsonl")]
        assert len(lines) == 2 and all(np.isfinite(l["avg_loss"]) for l in lines)
    # the bf16 run's last checkpoint through the JAX package's loader
    ckpt = max((corpus / "fp16_run").glob("checkpoint_*.npz"),
               key=lambda p: int(p.stem.split("_")[1]))
    from glow_tts_train_tpu.config import TrainingConfig

    config = TrainingConfig.load_and_merge(
        TrainingConfig(), [corpus / "config.json", tmp_path / "fp16_run.json"])
    assert config.fp16_run
    loaded = jax_checkpoint.load_checkpoint(ckpt, config, load_optimizer=False)
    flat = jax_checkpoint._flatten(loaded.params, "")
    assert flat and all(np.isfinite(np.asarray(v)).all() for v in flat.values())


@pytest.mark.parametrize("encoder_fuse", [True, "auto"])
def test_train_cli_refuses_encoder_fuse_on_cuda(corpus, tmp_path, encoder_fuse):
    """encoder_fuse true ("auto" resolves to true for this rel-pos config)
    trains through the text kernels on --platform cuda, so on a machine
    without a GPU the CLI refuses the platform (exit 2, "no CUDA device")
    and never runs on the CPU instead; nothing about encoder_fuse itself
    is refused any more, on either platform."""
    override = tmp_path / "encoder_fuse.json"
    override.write_text(json.dumps({"encoder_fuse": encoder_fuse}))
    config = load_config([corpus / "config.json", override])
    assert model.hyper_from_config(config).encoder_fuse
    training.check_trainable(config)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --platform cuda would train")
    proc = _train("glow_tts_train_tpu_torch", corpus, "fuse", "--platform", "cuda",
                  "--config", str(override))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert "ROADMAP" not in proc.stderr
    assert not (corpus / "fuse.jsonl").exists() and not list((corpus / "fuse").glob("*.npz"))


# ---------------------------------------------------------------------------
# resuming through the train CLI: what is written, what is drawn
# ---------------------------------------------------------------------------


def test_train_cli_warns_of_dropped_optimizer_state_and_writes_the_applied_lr(corpus):
    """A --checkpoint that holds optimizer state (``opt/`` keys, as the JAX
    trainer writes them) warns with the number of keys it drops, and Adam
    starts at count 0: the metrics lines and the checkpoint meta write the
    learning rate of the next update, lr(count), not lr(global step - 1)."""
    config = load_config([corpus / "config.json"])
    hp = model.hyper_from_config(config)
    flat = checkpoint.random_params(hp, 4)
    opt = {"opt/1/count": np.array(40, np.int32), "opt/2/count": np.array(40, np.int32),
           "opt/1/mu/emb": np.zeros_like(flat["model/emb"])}
    init = corpus / "with_opt.npz"
    checkpoint.save_npz(init, {**flat, **opt}, {"global_step": 41})
    proc = _train("glow_tts_train_tpu_torch", corpus, "with_opt", "--checkpoint", str(init),
                  "--platform", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"dropped {len(opt)} optimizer-state (opt/) keys" in proc.stderr, proc.stderr[-3000:]
    lr = training.learning_rate_fn(config)
    lines = [json.loads(l) for l in open(corpus / "with_opt.jsonl")]
    counts = [line["global_step"] - 41 for line in lines]
    assert counts == [3, 6]
    for line, count in zip(lines, counts):
        assert line["learning_rate"] == lr(count)
        assert line["learning_rate"] != current_lr(config, line["global_step"])
    _, meta = checkpoint.read_npz(corpus / "with_opt" / "checkpoint_47.npz")
    assert meta["global_step"] == 47 and meta["learning_rate"] == lr(6)


def test_train_cli_resumed_run_draws_the_dropout_seeds_of_an_uninterrupted_run(
    corpus, tmp_path, monkeypatch
):
    """Two epochs in one run against one epoch, a checkpoint, and a second
    epoch resumed from it: both dropout generators (the device's and the
    host's) hold the same state at every step of the second epoch, and
    differ from step to step."""
    from glow_tts_train_tpu_torch import __main__ as train_cli

    override = tmp_path / "dropout.json"
    override.write_text(json.dumps({"encoder_fuse": True, "model": {"p_dropout": 0.1}}))
    make_step = training.make_train_step
    drawn: dict = {}

    def recording_make_train_step(config):
        step_fn = make_step(config)

        def step(state, batch, generator=None, seed_generator=None):
            drawn[state.step] = (generator.get_state().clone(), seed_generator.get_state().clone())
            return step_fn(state, batch, generator, seed_generator)

        return step

    monkeypatch.setattr(training, "make_train_step", recording_make_train_step)

    def run(out, epochs, *extra):
        epochs_over = tmp_path / f"{out}_epochs.json"
        epochs_over.write_text(json.dumps({"epochs": epochs}))
        drawn.clear()
        train_cli.main([
            "--output", str(tmp_path / out), "--dataset", "0", str(corpus / "phonemes.csv"),
            str(corpus / "mels"), "--mels-dir", "--config", str(corpus / "config.json"),
            "--config", str(override), "--config", str(epochs_over), "--platform", "cpu", *extra,
        ])
        return dict(drawn)

    whole = run("whole", 2)
    first = run("first", 1)
    (ckpt,) = (tmp_path / "first").glob("checkpoint_*.npz")
    resumed = run("resumed", 1, "--checkpoint", str(ckpt))
    assert sorted(whole) == sorted({**first, **resumed}) and set(first).isdisjoint(resumed)
    assert len(resumed) >= 2
    for step, (device_state, host_state) in resumed.items():
        assert torch.equal(device_state, whole[step][0]), step
        assert torch.equal(host_state, whole[step][1]), step
    states = [host for _, host in whole.values()]
    assert all(not torch.equal(a, b) for a, b in zip(states, states[1:]))

"""Checkpoints with Adam state and an exact resume in
glow_tts_train_tpu_torch, on the CPU: the optimizer fingerprint against
the JAX package's, Adam state carried port -> JAX and JAX -> port, a
resumed run against an uninterrupted one (the port's own, bit for bit, and
the JAX CLI's), the train CLI's tolerant ``--checkpoint`` merge,
``--profile-dir``, and ``fp16_run`` accepted in every training mode.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu import training as jax_training
from glow_tts_train_tpu.config import TrainingConfig
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.optimize import current_lr as jax_current_lr
from glow_tts_train_tpu.optimize import make_optimizer
from glow_tts_train_tpu_torch import __main__ as train_cli
from glow_tts_train_tpu_torch import checkpoint, training
from glow_tts_train_tpu_torch.config import load_config
from glow_tts_train_tpu_torch.models import glow_tts as model

from helpers import random_batch, tiny_config
from test_torch_train import _train, corpus  # noqa: F401  (corpus: a fixture)

CONFIGS = {"base": {}, "multispeaker": {"n_speakers": 3, "gin_channels": 8}}


def _config(scheduler="noam", **over):
    config = tiny_config(p_dropout=0.0, p_dropout_dec=0.0, **over)
    config.scheduler = scheduler
    return config


def _port_state(config, steps: int, seed: int = 1):
    """A port train state after ``steps`` steps on random batches."""
    hp = model.hyper_from_config(config)
    flat = checkpoint.random_params(hp, seed)
    state = training.TrainState(training.trainable_model(
        {k[len("model/"):]: v for k, v in flat.items()}, hp, "cpu"
    ))
    step = training.make_train_step(config)
    rng = np.random.default_rng(seed)
    ms = config.model.n_speakers > 1
    for _ in range(steps):
        step(state, training.batch_to(random_batch(config, rng, b=2, multispeaker=ms), "cpu"))
    return state


@pytest.mark.parametrize("scheduler", ["noam", "constant"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_opt_treedef_matches_jax_fingerprint(name, scheduler):
    """The port's ``opt_treedef``, built from its param paths, is the
    string the JAX package's ``_opt_fingerprint`` gives for its optimizer
    over the same param tree."""
    config = _config(scheduler, **CONFIGS[name])
    params = jax_model.init_model(jax.random.PRNGKey(0), jax_model.hyper_from_config(config))
    want = jax_checkpoint._opt_fingerprint(make_optimizer(config).init(params))
    paths = [k[len("model/"):] for k in checkpoint.param_shapes(model.hyper_from_config(config))]
    assert checkpoint.opt_treedef(paths, scheduler) == want


@pytest.mark.parametrize("scheduler", ["noam", "constant"])
def test_port_checkpoint_carries_adam_into_jax(tmp_path, caplog, scheduler):
    """A port checkpoint after 2 steps loads in the JAX ``load_checkpoint``
    with its optimizer state (no "discarding saved optimizer state"): the
    moments equal the port's, every count is 2, and the keys are the JAX
    chain's (``opt/2/count`` for Noam only)."""
    config = _config(scheduler)
    state = _port_state(config, 2)
    path = tmp_path / "port.npz"
    checkpoint.save_checkpoint(state.model.flat(), path, state.step, 1.0, 1, state.opt, scheduler)
    saved: dict = {}
    checkpoint.read_npz(path, saved)
    assert ("2/count" in saved) == (scheduler == "noam")
    assert all(saved[k].dtype == np.int32 for k in saved if k.endswith("count"))
    with caplog.at_level(logging.WARNING):
        loaded = jax_checkpoint.load_checkpoint(path, config)
    assert "discarding saved optimizer state" not in caplog.text
    assert loaded.global_step == 3
    adam = loaded.opt_state[1]
    assert int(adam.count) == 2
    if scheduler == "noam":
        assert int(loaded.opt_state[2].count) == 2
    for moment, port in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        jflat = jax_checkpoint._flatten(getattr(adam, moment), "")
        assert set(jflat) == set(port)
        for k, v in port.items():
            np.testing.assert_array_equal(np.asarray(jflat[k]), v.numpy(), err_msg=k)


@pytest.mark.parametrize("scheduler", ["noam", "constant"])
def test_jax_checkpoint_carries_adam_into_port(tmp_path, scheduler):
    """A JAX checkpoint after 2 steps restores in the port all at once:
    moments equal the JAX state's, the count is 2, and the learning rate
    the port applies next is the JAX schedule's at count 2."""
    config = _config(scheduler)
    jstate = jax_training.create_state(config, jax.random.PRNGKey(0))
    jstep = jax_training.make_train_step(config, mas_impl="scan", donate=False)
    rng = np.random.default_rng(2)
    for i in range(2):
        jstate, _ = jstep(jstate, random_batch(config, rng, b=2), jax.random.PRNGKey(i))
    path = tmp_path / "jax.npz"
    jax_checkpoint.save_checkpoint(jax_checkpoint.Checkpoint(
        params=jstate.params, opt_state=jstate.opt_state, learning_rate=1.0,
        global_step=int(jstate.step), version=1,
    ), path)
    saved: dict = {}
    flat, meta = checkpoint.read_npz(path, saved)
    hp = model.hyper_from_config(config)
    params = training.trainable_model({k[len("model/"):]: v for k, v in flat.items()}, hp, "cpu").flat()
    opt, why = checkpoint.restore_opt_state(saved, meta["opt_treedef"], params, scheduler)
    assert opt is not None, why
    assert opt.count == 2
    adam = jstate.opt_state[1]
    for moment, port in (("mu", opt.mu), ("nu", opt.nu)):
        jflat = jax_checkpoint._flatten(getattr(adam, moment), "")
        assert set(jflat) == set(port) == set(params)
        for k, v in port.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]), err_msg=k)
    assert training.learning_rate_fn(config)(opt.count) == pytest.approx(
        jax_current_lr(config, 3), rel=1e-6
    )


@pytest.mark.parametrize("change", ["fingerprint", "missing", "shape", "scheduler"])
def test_restore_is_all_or_nothing(change):
    """Optimizer state whose fingerprint, keys or shapes disagree with the
    model, or that was written for the other schedule, is not taken."""
    config = _config()
    state = _port_state(config, 1)
    params = state.model.flat()
    saved = {k[len("opt/"):]: v for k, v in checkpoint.opt_state_arrays(state.opt, "noam").items()}
    fingerprint = checkpoint.opt_treedef(params, "noam")
    scheduler = "noam"
    assert checkpoint.restore_opt_state(saved, fingerprint, params, scheduler)[0] is not None
    if change == "fingerprint":
        fingerprint = fingerprint.replace("ScaleByAdamState", "ScaleByBeliefState")
    elif change == "missing":
        del saved["1/nu/emb"]
    elif change == "shape":
        saved["1/mu/emb"] = saved["1/mu/emb"][:-1]
    else:
        scheduler = "constant"
    opt, why = checkpoint.restore_opt_state(saved, fingerprint, params, scheduler)
    assert opt is None and why


def _run_cli(tmp_path, corpus, out, over: dict, *extra):  # noqa: F811
    over_path = tmp_path / f"{out}_over.json"
    over_path.write_text(json.dumps(over))
    train_cli.main([
        "--output", str(tmp_path / out), "--dataset", "0", str(corpus / "phonemes.csv"),
        str(corpus / "mels"), "--mels-dir", "--config", str(corpus / "config.json"),
        "--config", str(over_path), "--metrics-file", str(tmp_path / f"{out}.jsonl"),
        "--platform", "cpu", *extra,
    ])
    return [json.loads(line) for line in open(tmp_path / f"{out}.jsonl")]


RESUMED_KEYS = ("global_step", "avg_loss", "learning_rate")


def test_port_resume_equals_uninterrupted_run(corpus, tmp_path):  # noqa: F811
    """2 epochs in one run against 1 epoch, its checkpoint, and 1 epoch
    resumed from it (dropout on, the text side through its kernels'
    Functions, fresh init with DDI): the resumed run's metrics line, the
    final params, both moments, the count and the meta equal the
    uninterrupted run's bit for bit."""
    over = {"encoder_fuse": True, "model": {"p_dropout": 0.1, "p_dropout_dec": 0.05}}
    whole = _run_cli(tmp_path, corpus, "whole", dict(over, epochs=2))
    first = _run_cli(tmp_path, corpus, "first", dict(over, epochs=1))
    assert [line["global_step"] for line in first] == [4]
    resumed = _run_cli(tmp_path, corpus, "resumed", dict(over, epochs=1),
                       "--checkpoint", str(tmp_path / "first" / "checkpoint_4.npz"))
    assert [{k: line[k] for k in RESUMED_KEYS} for line in first + resumed] == [
        {k: line[k] for k in RESUMED_KEYS} for line in whole
    ]
    with np.load(tmp_path / "whole" / "checkpoint_7.npz") as a, \
            np.load(tmp_path / "resumed" / "checkpoint_7.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("opt/1/mu/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    saved: dict = {}
    _, meta = checkpoint.read_npz(tmp_path / "resumed" / "checkpoint_7.npz", saved)
    assert int(saved["1/count"]) == int(saved["2/count"]) == 6 and meta["global_step"] == 7


def test_jax_checkpoint_resumes_in_the_port_cli(corpus, tmp_path):  # noqa: F811
    """The JAX CLI trains 1 epoch from a JAX-initialised checkpoint; the
    port's CLI resumes 1 epoch from the JAX checkpoint (Adam and the Noam
    count carried over: no optimizer key is dropped); its metrics line
    equals the JAX CLI's second line of 2 uninterrupted epochs within 1e-4."""
    config = TrainingConfig.load_and_merge(TrainingConfig(), [corpus / "config.json"])
    params = jax_model.init_model(jax.random.PRNGKey(5), jax_model.hyper_from_config(config))
    init = tmp_path / "init.npz"
    jax_checkpoint.save_checkpoint(
        jax_checkpoint.Checkpoint(params=params, learning_rate=1.0, global_step=1, version=1), init
    )
    one = tmp_path / "one.json"
    one.write_text(json.dumps({"epochs": 1}))
    jax_flags = ["--platform", "cpu", "--no-mesh", "--mas-impl", "scan"]
    first = corpus / "jax_first"
    runs = {
        "jax_whole": _train("glow_tts_train_tpu", corpus, "jax_whole", *jax_flags,
                            "--checkpoint", str(init)),
        "jax_first": _train("glow_tts_train_tpu", corpus, "jax_first", *jax_flags,
                            "--checkpoint", str(init), "--config", str(one)),
    }
    runs["port_resumed"] = _train(
        "glow_tts_train_tpu_torch", corpus, "port_resumed", "--platform", "cpu",
        "--checkpoint", str(first / "checkpoint_4.npz"), "--config", str(one),
    )
    for tag, proc in runs.items():
        assert proc.returncode == 0, (tag, proc.stderr[-3000:])
    assert "dropped" not in runs["port_resumed"].stderr, runs["port_resumed"].stderr[-3000:]
    assert "Restored Adam state (count=3)" in runs["port_resumed"].stderr
    jlines = [json.loads(line) for line in open(corpus / "jax_whole.jsonl")]
    (tline,) = [json.loads(line) for line in open(corpus / "port_resumed.jsonl")]
    assert tline["global_step"] == jlines[1]["global_step"] == 7
    assert tline["avg_loss"] == pytest.approx(jlines[1]["avg_loss"], rel=1e-4)
    assert tline["learning_rate"] == pytest.approx(jlines[1]["learning_rate"], rel=1e-6)


def _edited_checkpoint(corpus, tmp_path, kind):  # noqa: F811
    """A port checkpoint of the corpus config with one key mis-shaped,
    missing or extra."""
    config = load_config([corpus / "config.json"])
    flat = checkpoint.random_params(model.hyper_from_config(config), 6)
    key = "model/decoder/blocks/coupling/end/w"
    if kind == "shape":
        flat[key] = flat[key][..., :-1]
    elif kind == "missing":
        del flat[key]
    else:
        flat["model/decoder/blocks/coupling/unknown"] = np.zeros(3, np.float32)
    path = tmp_path / f"{kind}.npz"
    checkpoint.save_npz(path, flat)
    return path, key


@pytest.mark.parametrize("kind,message", [
    ("shape", "has shape"), ("missing", "is not in the checkpoint"),
    ("extra", "not used by the model"),
])
def test_tolerant_checkpoint_load_warns_and_trains(corpus, tmp_path, caplog, kind, message):  # noqa: F811
    """The train CLI's --checkpoint keeps the fresh init for a mis-shaped
    or missing key and leaves an extra one out, each with a warning, and
    trains to finite losses; the infer path's loader stays strict."""
    path, key = _edited_checkpoint(corpus, tmp_path, kind)
    with caplog.at_level(logging.WARNING):
        lines = _run_cli(tmp_path, corpus, kind, {"epochs": 1}, "--checkpoint", str(path))
    assert message in caplog.text
    assert len(lines) == 1 and np.isfinite(lines[0]["avg_loss"])
    hp = model.hyper_from_config(load_config([corpus / "config.json"]))
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(path, hp)


def test_tolerant_merge_keeps_fresh_values():
    """``merge_into``: saved values of the right shape win, the rest keep
    the fresh tensors, and the unused saved key is left out."""
    fresh = {"a/w": torch.zeros(2, 3), "a/b": torch.ones(3), "c": torch.full((4,), 2.0)}
    saved = {"model/a/w": np.full((2, 3), 5.0, np.float32), "model/a/b": np.zeros(2, np.float32),
             "model/x": np.zeros(1, np.float32)}
    merged = checkpoint.merge_into(fresh, saved)
    assert sorted(merged) == sorted(fresh)
    assert torch.equal(merged["a/w"], torch.full((2, 3), 5.0))
    assert merged["a/b"] is fresh["a/b"] and merged["c"] is fresh["c"]


def test_profile_dir_writes_a_trace(corpus, tmp_path):  # noqa: F811
    """--profile-dir writes a torch.profiler Chrome trace of the run's 6th
    to 15th steps (18 steps: 3 epochs of 6 at batch 4), one ``train_step``
    range each; without it nothing is written."""
    trace_dir = tmp_path / "trace"
    _run_cli(tmp_path, corpus, "profiled", {"epochs": 3, "batch_size": 4},
             "--profile-dir", str(trace_dir))
    (trace,) = trace_dir.glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 10
    _run_cli(tmp_path, corpus, "unprofiled", {"epochs": 1, "batch_size": 4})
    assert list(tmp_path.rglob("*.trace.json")) == [trace]


@pytest.mark.parametrize("mode", [
    {}, {"encoder_fuse": False}, {"flow_block_fuse": False}, {"wn_residuals": "recompute"},
], ids=["default", "encoder_fuse_false", "flow_block_fuse_false", "recompute"])
def test_fp16_run_trainable_in_every_mode(mode):
    """``fp16_run`` trains in bf16 in each of the decoder's modes (the fused
    block or op by op, store or recompute) and with the text side through
    its kernels or op by op (``encoder_fuse: false``, as XLA rounds it):
    ``check_trainable`` accepts them all."""
    config = tiny_config()
    config.fp16_run = True
    config.encoder_fuse = "auto"
    for key, value in mode.items():
        setattr(config, key, value)
    training.check_trainable(config)

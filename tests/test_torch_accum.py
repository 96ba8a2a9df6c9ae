"""Exact gradient accumulation (``grad_accum_steps``) in
glow_tts_train_tpu_torch, on the CPU: the accumulated step against the
port's own full-batch step, a 3-step trajectory against the JAX package's
accumulated step, the refusal of a batch the count does not divide, and
both train CLIs from one checkpoint at ``grad_accum_steps: 2``.

Dropout is off (the two frameworks draw different streams) but in the
test of an accumulated step's dropout, batches are ragged (the slices'
denominators differ, so averaging the slices' losses would not be exact)
and made from a numpy seed.
"""

import copy
import json

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
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.optimize import current_lr

from helpers import random_batch, tiny_config
from test_torch_train import _both_clis, corpus  # noqa: F401  (corpus: a fixture)

# the JAX package's tolerances for an accumulated step against the full
# batch (tests/test_grad_accum.py): the f32 sums go in another order
PARAM_RTOL, PARAM_ATOL = 3e-4, 2e-6
METRIC_RTOL, METRIC_ATOL = 3e-4, 1e-6
# base lr of the trajectory: Noam at hidden 16 and warmup 4000 gives about
# 1e-3, 2e-3, 3e-3 at steps 1-3, so that an update shows
LR_TRAJECTORY = 1e3


def _config(accum=1, encoder_fuse=False):
    config = tiny_config(p_dropout=0.0, p_dropout_dec=0.0)
    config.encoder_fuse = encoder_fuse
    config.grad_accum_steps = accum
    return config


def _state(hp, seed=1):
    flat = checkpoint.random_params(hp, seed)
    return training.TrainState(training.trainable_model(
        {k[len("model/"):]: v for k, v in flat.items()}, hp, "cpu"
    ))


@pytest.mark.parametrize("encoder_fuse", [False, True])
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_full_batch(accum, encoder_fuse):
    """One step at ``grad_accum_steps`` 2 and 4 on a ragged batch of 8
    against the full-batch step from the same params: loss, mle_loss,
    duration_loss and grad_norm within 3e-4, every param within 3e-4
    relative and 2e-6 absolute, the Adam count alike; with the text side
    op by op and through its autograd Functions."""
    full_config = _config(1, encoder_fuse)
    hp = model.hyper_from_config(full_config)
    batch = training.batch_to(random_batch(full_config, np.random.default_rng(1), b=8), "cpu")
    assert len(set(batch["y_lengths"].tolist())) > 1
    runs = []
    for config in (full_config, _config(accum, encoder_fuse)):
        state = _state(hp)
        metrics = training.make_train_step(config)(state, batch)
        runs.append((state, metrics))
    (full, full_metrics), (acc, acc_metrics) = runs
    for key in ("loss", "mle_loss", "duration_loss", "grad_norm"):
        np.testing.assert_allclose(float(acc_metrics[key]), float(full_metrics[key]),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=key)
    assert acc.step == full.step == 2 and acc.opt.count == full.opt.count == 1
    full_params = full.model.flat()
    for key, value in acc.model.flat().items():
        np.testing.assert_allclose(value.detach().numpy(), full_params[key].detach().numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


def test_accumulated_trajectory_matches_jax(monkeypatch):
    """Three steps at ``grad_accum_steps: 2`` from the same params on the
    same ragged batches of 8, the port against the JAX package's
    accumulated step: per step loss, mle and duration loss and grad_norm
    within 1e-5 relative; after the steps both Adam moments within atol
    1e-5 and each leaf's change of params within 1e-3 of that leaf's
    largest change in JAX (the tolerances of the full-batch trajectory in
    ``test_torch_train.py``)."""
    orig_prenet = jax_model.prenet_apply
    monkeypatch.setattr(
        jax_model, "prenet_apply", lambda *a, **k: orig_prenet(*a, **dict(k, p_dropout=0.0))
    )
    config = _config(2)
    config.learning_rate = LR_TRAJECTORY
    hp = model.hyper_from_config(config)
    flat = checkpoint.random_params(hp, 1)
    state = training.TrainState(training.trainable_model(
        {k[len("model/"):]: v for k, v in flat.items()}, hp, "cpu"
    ))
    jparams = jax_checkpoint._merge_into(
        jax_model.init_model(jax.random.PRNGKey(0), jax_model.hyper_from_config(config)), flat
    )
    before = {k: p.detach().clone().numpy() for k, p in state.model.flat().items()}
    tx = make_optimizer(config)
    jstate = jax_training.TrainState(jparams, tx.init(jparams), jnp.int32(1))
    jstep = jax_training.make_train_step(config, mas_impl="scan", donate=False)
    step = training.make_train_step(config)
    rng = np.random.default_rng(4)
    for i in range(3):
        batch = random_batch(config, rng, b=8)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(i))
        metrics = step(state, training.batch_to(batch, "cpu"))
        for k in ("loss", "mle_loss", "duration_loss", "grad_norm"):
            assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5), (i, k)
    assert state.step == int(jstate.step) == 4
    adam = jstate.opt_state[1]
    assert state.opt.count == int(adam.count) == 3
    jflat = jax_checkpoint._flatten(jstate.params, "")
    jmu, jnu = jax_checkpoint._flatten(adam.mu, ""), jax_checkpoint._flatten(adam.nu, "")
    lr_sum = sum(current_lr(config, s) for s in (1, 2, 3))
    for k, p in state.model.flat().items():
        delta, jdelta = p.detach().numpy() - before[k], np.asarray(jflat[k]) - before[k]
        if k == "encoder/attn/k/b":  # a zero gradient up to round-off: Adam's sign is arbitrary
            assert np.abs(delta).max() <= lr_sum and np.abs(jdelta).max() <= lr_sum, k
        else:
            np.testing.assert_allclose(
                delta, jdelta, rtol=0, atol=1e-3 * np.abs(jdelta).max(), err_msg=k
            )
        np.testing.assert_allclose(state.opt.mu[k].numpy(), np.asarray(jmu[k]), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(state.opt.nu[k].numpy(), np.asarray(jnu[k]), rtol=0, atol=1e-5, err_msg=k)


def test_indivisible_batch_refused():
    """A batch that ``grad_accum_steps`` does not divide raises, naming
    the key, and leaves the state as it was."""
    config = _config(3)
    hp = model.hyper_from_config(config)
    batch = training.batch_to(random_batch(config, np.random.default_rng(2), b=8), "cpu")
    state = _state(hp)
    before = {k: p.detach().clone() for k, p in state.model.flat().items()}
    with pytest.raises(ValueError, match="grad_accum_steps"):
        training.make_train_step(config)(state, batch)
    assert state.step == 1 and state.opt.count == 0
    assert all(torch.equal(p, before[k]) for k, p in state.model.flat().items())


def test_accumulation_draws_dropout_per_step():
    """With dropout on, an accumulated step is a function of (seed, step)
    alone: two states stepped with generators seeded alike end equal, and
    another seed moves the result.  Each slice draws its rows' masks of
    the whole batch (``attention.rows_of``), so the step's four metrics
    are the full-batch step's with the same seed within 3e-4."""
    config = tiny_config()
    config.grad_accum_steps = 2
    config.encoder_fuse = True
    hp = model.hyper_from_config(config)
    batch = training.batch_to(random_batch(config, np.random.default_rng(5), b=4), "cpu")
    results = []
    for accum, seed in ((2, 7), (2, 7), (2, 8), (1, 7)):
        config.grad_accum_steps = accum
        state = _state(hp)
        gen, seed_gen = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        metrics = training.make_train_step(config)(state, batch, gen, seed_gen)
        assert np.isfinite(float(metrics["loss"]))
        results.append({k: float(v) for k, v in metrics.items()})
    assert results[0] == results[1] and results[0]["loss"] != results[2]["loss"]
    for key, full in results[3].items():
        np.testing.assert_allclose(results[0][key], full, rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)


def test_train_clis_match_at_grad_accum_steps_2(corpus, tmp_path):  # noqa: F811
    """Both train CLIs from one JAX-initialised checkpoint with
    ``grad_accum_steps: 2`` (batches of 8 in slices of 4), 2 epochs of 3
    steps: the port no longer refuses the key, and the epoch lines agree
    within 1e-4 (``_both_clis``)."""
    override = tmp_path / "accum.json"
    override.write_text(json.dumps({"grad_accum_steps": 2}))
    config, out = _both_clis(corpus, "accum", "--config", str(override))
    assert config.grad_accum_steps == 2
    assert (out / "checkpoint_7.npz").exists()


def test_full_batch_step_unchanged_by_the_accumulation_path():
    """``grad_accum_steps`` 1 (and a missing or zero value) is the
    full-batch step: equal bits whatever spelling of 1."""
    runs = []
    for accum in (1, 0, None):
        config = _config()
        config.grad_accum_steps = accum
        hp = model.hyper_from_config(config)
        batch = training.batch_to(random_batch(config, np.random.default_rng(3), b=4), "cpu")
        state = _state(hp)
        metrics = training.make_train_step(copy.deepcopy(config))(state, batch)
        runs.append((float(metrics["loss"]), {k: p.detach().clone() for k, p in state.model.flat().items()}))
    for loss, params in runs[1:]:
        assert loss == runs[0][0]
        assert all(torch.equal(p, runs[0][1][k]) for k, p in params.items())

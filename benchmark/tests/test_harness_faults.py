"""The rest of a run with the timed path broken underneath (on the CPU, at a
tiny width, the chip's look skipped): each fault a cell can have makes
``correct`` false by the cell's own limits, and the sound program does not.
"""

import pytest
import torch

import harness_tiny

from glow_tts_train_tpu_torch import infer, training

TRAIN_CELLS = ["base.train_b384", "multispeaker.train_b384"]


def _train_ctx(tmp_path, workload):
    name = workload.split(".")[0]
    traffic = dict(harness_tiny.TRAIN_TRAFFIC, speakers=5 if name == "multispeaker" else 1)
    return harness_tiny.context(harness_tiny.tiny_config(tmp_path, name), traffic, window=False)


def _broken_step(monkeypatch, wrap):
    make = training.make_train_step

    def make_broken(config):
        return wrap(make(config))

    monkeypatch.setattr(training, "make_train_step", make_broken)


def _unchanged(step):
    """A step that returns its state as it found it."""

    def step_fn(state, batch, *args):
        params = {k: p.detach().clone() for k, p in state.model.flat().items()}
        mu = {k: v.clone() for k, v in state.opt.mu.items()}
        nu = {k: v.clone() for k, v in state.opt.nu.items()}
        count, step_no = state.opt.count, state.step
        metrics = step(state, batch, *args)
        with torch.no_grad():
            for k, p in state.model.flat().items():
                p.copy_(params[k])
        state.opt = type(state.opt)(mu, nu, count)
        state.step = step_no + 1
        return metrics

    return step_fn


def _half_batch(step):
    """A step over the first half of its batch, the mean over those rows."""

    def step_fn(state, batch, *args):
        half = batch["x"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, *args)

    return step_fn


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_sound_training_is_correct(tmp_path, workload):
    _, readings = harness_tiny.drive_and_check(_train_ctx(tmp_path, workload))
    assert harness_tiny.correct(readings, workload)


@pytest.mark.parametrize("workload", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(tmp_path, monkeypatch, workload, fault):
    _broken_step(monkeypatch, fault)
    _, readings = harness_tiny.drive_and_check(_train_ctx(tmp_path, workload))
    assert not harness_tiny.correct(readings, workload)


def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    build = infer.build_synthesizer

    def build_altered(*args, **kwargs):
        synth = build(*args, **kwargs)

        def altered(batch_ids, speaker=None):
            mels = synth(batch_ids, speaker)
            mels[1] = mels[1].copy()  # one frame of one answer, where it is produced
            mels[1][:, -1] += 0.5
            return mels

        return altered

    monkeypatch.setattr(infer, "build_synthesizer", build_altered)
    ctx = harness_tiny.context(harness_tiny.tiny_config(tmp_path), harness_tiny.SYNTH_TRAFFIC)
    _, readings = harness_tiny.drive_and_check(ctx)
    assert not harness_tiny.correct(readings, "base.synth_b16")


def test_sound_synthesis_is_correct(tmp_path):
    ctx = harness_tiny.context(harness_tiny.tiny_config(tmp_path), harness_tiny.SYNTH_TRAFFIC)
    _, readings = harness_tiny.drive_and_check(ctx)
    assert harness_tiny.correct(readings, "base.synth_b16")

"""The reference agrees with the port's CPU path at a tiny width: in f32 the
two are the same arithmetic in another order, so every number reads at
round-off; in bf16 the program's numbers stay within the cell's limits."""

import pytest

import harness_tiny


@pytest.mark.parametrize("name", ["base", "multispeaker"])
def test_training_reference_matches_the_port_in_f32(tmp_path, name):
    traffic = dict(harness_tiny.TRAIN_TRAFFIC, speakers=5 if name == "multispeaker" else 1)
    ctx = harness_tiny.context(harness_tiny.tiny_config(tmp_path, name), traffic, window=False)
    _, readings = harness_tiny.drive_and_check(ctx)
    assert readings["loss_gap"] < 1e-6
    assert readings["grad_gap"] < 1e-4
    assert readings["update_gap"] < 1e-3
    # a key's bias gets no gradient under softmax: left out by the rule, not by name
    assert "encoder/attn/k/b" in readings["left_out"]


def test_synthesis_reference_matches_the_port_in_f32(tmp_path):
    ctx = harness_tiny.context(harness_tiny.tiny_config(tmp_path), harness_tiny.SYNTH_TRAFFIC)
    record, readings = harness_tiny.drive_and_check(ctx)
    assert readings["sentences"] >= 8
    assert readings["mel_gap"] < 1e-4
    assert readings["frame_mismatch"] == 0
    assert record["failed"] == 0

"""The port's ``--format onnx`` (glow_tts_train_tpu_torch.export and its
copy of the numpy ONNX exporter) against the JAX package's exporter on the
same ``.npz``: the same graph node for node, the same initializers (each
InvConvNear's dense inverse, which each side inverts in its own f32, within
1e-6 of its max), and the port's numpy executor at noise 0 against the
port's plain ``forward_gen``."""

import json

import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.onnx.export import export_generator_onnx as jax_export_onnx
from glow_tts_train_tpu_torch import checkpoint, export
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.onnx import OnnxRuntime, proto

from helpers import tiny_config

CONFIGS = {
    "default": ({}, None),
    "mean_only_false_sigmoid": ({"mean_only": False, "sigmoid_scale": True}, None),
    "multispeaker": ({"n_speakers": 3, "gin_channels": 8}, 2),
    "no_prenet": ({"prenet": False}, None),
}
# the numpy executor against the live plain graph (tests/test_onnx_export.py)
ONNX_ATOL = 2e-4
INVERSE_RTOL = 1e-6


def _exported(tmp_path, name, seed=0):
    """A random checkpoint through the export CLI -> (config, hp, flat
    arrays, the port's .onnx bytes, the JAX exporter's bytes)."""
    over, speaker = CONFIGS[name]
    config = tiny_config(**over)
    hp = model.hyper_from_config(config)
    flat = checkpoint.random_params(hp, seed)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, flat)
    cfg = tmp_path / "config.json"
    with open(cfg, "w") as f:
        config.save(f)
    argv = [str(path), str(tmp_path / "out"), "--config", str(cfg), "--format", "onnx",
            "--platform", "cpu"]
    if speaker is not None:
        argv += ["--speaker", str(speaker)]
    export.main(argv)
    ours = (tmp_path / "out" / export.ONNX_NAME).read_bytes()
    jparams = jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    theirs = jax_export_onnx(jax_model.store_inverse(jparams), config, speaker=speaker or 0)
    return config, hp, flat, ours, theirs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_onnx_matches_jax_exporter(tmp_path, name):
    """Node for node (op, inputs, outputs, attributes), the same graph
    inputs and outputs with their dims, and every initializer equal in
    name, dtype and shape; values bit for bit but the dense inverses."""
    _, _, _, ours, theirs = _exported(tmp_path, name)
    a, b = proto.decode_model(ours), proto.decode_model(theirs)
    assert (a.opset_version, a.ir_version) == (b.opset_version, b.ir_version) == (12, 7)
    assert a.graph.inputs == b.graph.inputs and a.graph.outputs == b.graph.outputs
    assert len(a.graph.nodes) == len(b.graph.nodes)
    for x, y in zip(a.graph.nodes, b.graph.nodes):
        assert (x.op_type, x.inputs, x.outputs) == (y.op_type, y.inputs, y.outputs)
        assert json.dumps(x.attributes, default=repr) == json.dumps(y.attributes, default=repr)
    assert [t.name for t in a.graph.initializers] == [t.name for t in b.graph.initializers]
    inverses = 0
    for x, y in zip(a.graph.initializers, b.graph.initializers):
        assert x.array.dtype == y.array.dtype and x.array.shape == y.array.shape, x.name
        if "_minv" in x.name:
            inverses += 1
            scale = np.abs(y.array).max()
            np.testing.assert_allclose(x.array, y.array, rtol=0, atol=INVERSE_RTOL * scale,
                                       err_msg=x.name)
        else:
            np.testing.assert_array_equal(x.array, y.array, err_msg=x.name)
    assert inverses == tiny_config().model.n_blocks_dec


def _batch(config, b, t_x, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, config.model.num_symbols, size=(b, t_x)).astype(np.int64)
    x_lengths = np.linspace(t_x, max(3, t_x - 4), b).astype(np.int64)
    for i in range(b):
        x[i, x_lengths[i]:] = 0
    return x, x_lengths


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_numpy_executor_matches_forward_gen(tmp_path, name):
    """The port's ``.onnx`` under the port's numpy executor at noise 0
    against the port's plain ``forward_gen`` on the same checkpoint (the
    speaker baked in against ``g_ids``): equal lengths, mels within 2e-4."""
    config, hp, flat, ours, _ = _exported(tmp_path, name)
    speaker = CONFIGS[name][1]
    x, x_lengths = _batch(config, 2, 9, seed=1)
    mel, mel_lengths = OnnxRuntime(ours, seed=0).run(None, {
        "input": x, "input_lengths": x_lengths,
        "scales": np.array([0.0, 1.1], np.float32),
    })
    weights = model.store_inverse(checkpoint.params_from_numpy(flat, hp), hp)
    g_ids = None if speaker is None else torch.full((2,), speaker)
    (y, *_), _, _, y_lengths = model.forward_gen(
        weights, hp, torch.from_numpy(x), torch.from_numpy(x_lengths), 256,
        noise_scale=0.0, length_scale=1.1, g_ids=g_ids, eps=torch.zeros(2, 256, hp.out_channels),
    )
    assert mel.shape == (2, hp.out_channels, int(y_lengths.max()))
    assert list(mel_lengths) == y_lengths.tolist()
    for i in range(2):
        n = int(y_lengths[i])
        np.testing.assert_allclose(mel[i, :, :n], y[i, :n].numpy().T, rtol=0, atol=ONNX_ATOL)


def test_dynamic_batch_and_length(tmp_path):
    """One artifact takes any batch and text length: three batches of
    different shapes, each row equal to the same text run alone (lengths
    equal, mels within 2e-4)."""
    config, _, _, ours, _ = _exported(tmp_path, "default")
    sess = OnnxRuntime(ours, seed=0)
    scales = np.array([0.0, 1.0], np.float32)
    for b, t_x, seed in ((1, 5, 2), (3, 13, 3), (4, 7, 4)):
        x, x_lengths = _batch(config, b, t_x, seed)
        mel, mel_lengths = sess.run(None, {"input": x, "input_lengths": x_lengths, "scales": scales})
        assert mel.shape[0] == b and mel.shape[2] == int(mel_lengths.max())
        for i in range(b):
            n = int(x_lengths[i])
            one, one_len = sess.run(None, {"input": x[i:i + 1, :n], "input_lengths": x_lengths[i:i + 1],
                                           "scales": scales})
            assert int(one_len[0]) == int(mel_lengths[i])
            k = int(one_len[0])
            np.testing.assert_allclose(one[0, :, :k], mel[i, :, :k], rtol=0, atol=ONNX_ATOL)

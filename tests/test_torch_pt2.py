"""The port's ``--format pt2`` artifact (glow_tts_train_tpu_torch.export):
saved and loaded on the CPU, it matches the JAX package's exported graph
(``glow_tts_train_tpu.export.build_infer_fn``, the function its StableHLO
artifact serializes) at noise 0 on the same params and inputs; its noise
comes from its ``seed`` input; it names no device but the one it runs on;
and it pads to its static budgets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu.export import build_infer_fn
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu_torch import checkpoint, export
from glow_tts_train_tpu_torch.models import glow_tts as model

from helpers import tiny_config

CONFIGS = {
    "default": ({}, None),
    "mean_only_false_sigmoid": ({"mean_only": False, "sigmoid_scale": True}, None),
    "multispeaker": ({"n_speakers": 3, "gin_channels": 8}, 2),
}
MAX_TEXT, MAX_FRAMES = 32, 128
# f32 on the CPU in both frameworks, as tests/test_torch_model.py holds forward_gen
PT2_ATOL = 1e-4


def _export(tmp_path, name, max_text=MAX_TEXT, max_frames=MAX_FRAMES, seed=0):
    """A random checkpoint through the export CLI (pt2, checked on the CPU)
    -> (config, flat arrays, the export directory)."""
    over, speaker = CONFIGS[name]
    config = tiny_config(**over)
    flat = checkpoint.random_params(model.hyper_from_config(config), seed)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, flat)
    cfg = tmp_path / "config.json"
    with open(cfg, "w") as f:
        config.save(f)
    out = tmp_path / f"pt2_{max_text}_{max_frames}"
    argv = [str(path), str(out), "--config", str(cfg), "--platform", "cpu",
            "--max-text-length", str(max_text), "--max-frames", str(max_frames)]
    if speaker is not None:
        argv += ["--speaker", str(speaker)]
    export.main(argv)
    return config, flat, path, out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def exported(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"pt2_{request.param}")
    config, flat, path, out = _export(tmp, request.param)
    module, program = export.load_pt2(out / export.ARTIFACT_NAME, "cpu")
    return request.param, config, path, out, module, program


def _text(config, n, seed, budget=MAX_TEXT):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, config.model.num_symbols, size=n)
    text = np.zeros((1, budget), np.int32)
    text[0, :n] = ids
    return text, np.array([n], np.int32)


def _call(module, text, lengths, noise, seed, length_scale=1.0):
    with torch.no_grad():
        mel, mel_lengths = module(
            torch.from_numpy(text), torch.from_numpy(lengths),
            torch.tensor([noise, length_scale], dtype=torch.float32),
            torch.tensor(seed, dtype=torch.int32),
        )
    return mel.numpy(), mel_lengths.numpy()


def test_pt2_matches_jax_build_infer_fn(exported):
    """The saved and loaded program at noise 0 against the JAX package's
    ``build_infer_fn`` (the speaker baked in on both sides) at two text
    lengths and two length scales: the same output shapes and dtypes, equal
    lengths, mels within 1e-4."""
    name, config, path, _, module, _ = exported
    jparams = jax_model.store_inverse(
        jax_checkpoint.load_checkpoint(path, config, load_optimizer=False).params
    )
    infer_fn = jax.jit(build_infer_fn(jparams, config, MAX_FRAMES, speaker=CONFIGS[name][1] or 0))
    for n, length_scale, seed in ((11, 1.0, 1), (30, 0.8, 2)):
        text, lengths = _text(config, n, seed)
        mel, mel_lengths = _call(module, text, lengths, 0.0, 7, length_scale)
        jmel, jlen = infer_fn(jnp.asarray(text), jnp.asarray(lengths),
                              jnp.asarray([0.0, length_scale], jnp.float32), jnp.int32(7))
        assert mel.shape == np.asarray(jmel).shape == (1, config.audio.mel_channels, MAX_FRAMES)
        assert mel.dtype == np.float32 and mel_lengths.dtype == np.int32
        np.testing.assert_array_equal(mel_lengths, np.asarray(jlen))
        np.testing.assert_allclose(mel, np.asarray(jmel), rtol=0, atol=PT2_ATOL)


def test_seed_contract(exported):
    """At noise 0.667 the same seed gives the same mel and another seed
    another one; at noise 0 the seed does not matter.  The in-graph noise
    is standard normal: over 10^5 draws its mean is within 0.02 of 0 and
    its deviation within 0.02 of 1."""
    _, config, _, _, module, _ = exported
    text, lengths = _text(config, 20, 3)
    a, la = _call(module, text, lengths, 0.667, 11)
    b, lb = _call(module, text, lengths, 0.667, 11)
    c, _ = _call(module, text, lengths, 0.667, 12)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    n = int(la[0])
    assert np.abs(a[..., :n] - c[..., :n]).max() > 1e-2
    d, _ = _call(module, text, lengths, 0.0, 11)
    e, _ = _call(module, text, lengths, 0.0, 12)
    np.testing.assert_array_equal(d, e)
    z = export.seeded_normal(torch.tensor(5, dtype=torch.int32), torch.empty(100_000))
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    assert torch.isfinite(z).all()
    assert not torch.equal(z, export.seeded_normal(torch.tensor(6), torch.empty(100_000)))


def test_program_names_only_its_inputs_device(exported):
    """The saved program names only the CPU, where its inputs were; moved
    to another device (``meta``, the one a CPU-only host has) it names only
    that one and runs there on inputs there, with the signature's shapes."""
    _, config, _, out, _, _ = exported
    assert export.graph_devices(torch.export.load(str(out / export.ARTIFACT_NAME))) == {"cpu"}
    module, moved = export.load_pt2(out / export.ARTIFACT_NAME, "meta")
    assert export.graph_devices(moved) == {"meta"}
    text, lengths = _text(config, 9, 4)
    with torch.no_grad():
        mel, mel_lengths = module(
            torch.from_numpy(text).to("meta"), torch.from_numpy(lengths).to("meta"),
            torch.tensor([0.0, 1.0], device="meta"), torch.tensor(1, dtype=torch.int32, device="meta"),
        )
    assert mel.device.type == mel_lengths.device.type == "meta"
    assert tuple(mel.shape) == (1, config.audio.mel_channels, MAX_FRAMES)
    assert tuple(mel_lengths.shape) == (1,) and mel_lengths.dtype == torch.int32


def test_budgets(tmp_path):
    """The static budgets: the program takes texts of exactly
    ``max_text_length`` ids and gives ``max_frames`` frames, zero past the
    length; the same text in a program with larger budgets gives the same
    length and mel (within 1e-4); a length past ``max_frames`` is cut to
    it."""
    config, _, _, small = _export(tmp_path, "default")
    _, _, _, large = _export(tmp_path, "default", max_text=48, max_frames=192)
    m_small, _ = export.load_pt2(small / export.ARTIFACT_NAME, "cpu")
    m_large, _ = export.load_pt2(large / export.ARTIFACT_NAME, "cpu")
    text, lengths = _text(config, 25, 5)
    mel, n = _call(m_small, text, lengths, 0.0, 1)
    wide = np.zeros((1, 48), np.int32)
    wide[:, :MAX_TEXT] = text
    mel2, n2 = _call(m_large, wide, lengths, 0.0, 1)
    assert mel.shape[2] == MAX_FRAMES and mel2.shape[2] == 192
    assert n[0] == n2[0] and 0 < n[0] < MAX_FRAMES
    assert not mel[..., n[0]:].any()
    np.testing.assert_allclose(mel[..., :n[0]], mel2[..., :n[0]], rtol=0, atol=PT2_ATOL)
    with pytest.raises(AssertionError, match="Guard failed"):
        _call(m_small, wide, lengths, 0.0, 1)
    _, cut = _call(m_small, text, lengths, 0.0, 1, length_scale=20.0)
    assert cut[0] == MAX_FRAMES

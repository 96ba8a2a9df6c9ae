"""The reference ``.pth`` bridge of glow_tts_train_tpu_torch.checkpoint
against the JAX package's mappers, both ways: the state dict and the Adam
state the port writes equal the JAX package's key for key (in order) and
bit for bit, a ``.pth`` either package writes loads in the other equal to
its ``.npz``, and the train CLI fine-tunes from a ``.pth`` with its Adam
state."""

import logging

import numpy as np
import pytest
import torch

from glow_tts_train_tpu import checkpoint as jax_checkpoint
from glow_tts_train_tpu_torch import checkpoint
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.optimize import AdamState

from helpers import tiny_config
from test_torch_resume import RESUMED_KEYS, _run_cli
from test_torch_train import corpus  # noqa: F401  (a fixture)

CONFIGS = {
    "base": {},
    "mean_only_false": {"mean_only": False, "sigmoid_scale": True},
    "multispeaker": {"n_speakers": 3, "gin_channels": 8},
    "no_prenet": {"prenet": False},
    "no_window": {"window_size": None},
}


def _setup(tmp_path, over, seed=0):
    """A random checkpoint with Adam state at count 5 -> (config, port flat
    arrays, AdamState, the JAX package's Checkpoint of the same file)."""
    config = tiny_config(**over)
    hp = model.hyper_from_config(config)
    flat = checkpoint.random_params(hp, seed)
    rng = np.random.default_rng(seed + 1)
    params = {k[len("model/"):]: torch.from_numpy(v) for k, v in flat.items()}
    opt = AdamState(
        {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) for k, v in params.items()},
        {k: torch.from_numpy(rng.uniform(0, 1e-3, v.shape).astype(np.float32)) for k, v in params.items()},
        5,
    )
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_checkpoint(params, path, 6, 0.25, 1, opt, config.scheduler)
    jckpt = jax_checkpoint.load_checkpoint(path, config, load_optimizer=True)
    return config, flat, opt, jckpt


def _same_state_dicts(ours: dict, theirs: dict) -> None:
    assert list(ours) == list(theirs)
    for k in ours:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_state_dict_matches_jax(tmp_path, name):
    """``export_torch_state_dict`` and ``reference_param_order`` equal the
    JAX package's on the same params: keys in the same order, values bit
    for bit; importing it back gives the ``.npz``'s arrays bit for bit and
    the JAX importer's."""
    config, flat, _, jckpt = _setup(tmp_path, CONFIGS[name])
    ours = checkpoint.export_torch_state_dict(flat, config)
    _same_state_dicts(ours, jax_checkpoint.export_torch_state_dict(jckpt.params, config))
    assert checkpoint.reference_param_order(config) == jax_checkpoint._reference_param_order(config)
    sd = {k: torch.from_numpy(v) for k, v in ours.items()}
    back = checkpoint.import_torch_state_dict(sd, config)
    jback = jax_checkpoint._flatten(jax_checkpoint.import_torch_state_dict(sd, config), "model/")
    assert set(back) == set(flat) == set(jback)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
        np.testing.assert_array_equal(back[k], np.asarray(jback[k]), err_msg=k)


@pytest.mark.parametrize("stepped", [True, False])
def test_opt_state_matches_jax(tmp_path, stepped):
    """``export_torch_opt_state`` equals the JAX package's on the same Adam
    state (a count of 5, or none: the empty state of an Adam that never
    stepped): param groups, and per index the step and both moments bit
    for bit."""
    config, flat, opt, jckpt = _setup(tmp_path, {})
    ours = checkpoint.export_torch_opt_state(opt if stepped else None, config, 0.25)
    theirs = jax_checkpoint.export_torch_opt_state(
        jckpt.opt_state if stepped else None, jckpt.params, config, 0.25
    )
    assert ours["param_groups"] == theirs["param_groups"]
    assert list(ours["state"]) == list(theirs["state"])
    assert len(ours["state"]) == (len(checkpoint.reference_param_order(config)) if stepped else 0)
    for i, s in ours["state"].items():
        t = theirs["state"][i]
        assert float(s["step"]) == float(t["step"]) == 5.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert s[key].dtype == t[key].dtype
            np.testing.assert_array_equal(s[key].numpy(), t[key].numpy())


@pytest.mark.parametrize("name", ["base", "multispeaker"])
def test_jax_pth_loads_into_port(tmp_path, name):
    """A ``.pth`` that the JAX package writes (``save_torch_checkpoint``)
    loads in the port strictly, equal to the ``.npz`` it came from bit for
    bit, with its meta; its Adam state maps to ``opt/`` arrays that
    ``restore_opt_state`` takes whole, equal to the ``.npz``'s."""
    config, flat, opt, jckpt = _setup(tmp_path, CONFIGS[name])
    pth = tmp_path / "generator.pth"
    jax_checkpoint.save_torch_checkpoint(jckpt, config, pth)
    hp = model.hyper_from_config(config)
    loaded, meta = checkpoint.load_checkpoint(pth, hp)
    for k, p in loaded.flat().items():
        np.testing.assert_array_equal(p.detach().numpy(), flat["model/" + k], err_msg=k)
    assert meta == {"global_step": 6, "learning_rate": 0.25, "version": 1}
    saved: dict = {}
    _, meta = checkpoint.read_checkpoint(pth, config, saved)
    restored, why = checkpoint.restore_opt_state(
        saved, meta["opt_treedef"], loaded.flat(), config.scheduler
    )
    assert restored is not None, why
    assert restored.count == 5
    for moment in ("mu", "nu"):
        for k, v in getattr(restored, moment).items():
            np.testing.assert_array_equal(v.numpy(), getattr(opt, moment)[k].numpy(), err_msg=k)


def test_port_pth_loads_in_jax(tmp_path):
    """A ``.pth`` the port writes loads in the JAX package's
    ``load_checkpoint`` with the same params and Adam moments bit for bit
    and the same count."""
    config, flat, opt, jckpt = _setup(tmp_path, CONFIGS["multispeaker"])
    pth = tmp_path / "port.pth"
    checkpoint.save_torch_checkpoint(pth, flat, config, 6, 0.25, 1, opt)
    back = jax_checkpoint.load_checkpoint(pth, config, load_optimizer=True)
    assert (back.global_step, back.learning_rate) == (6, 0.25)
    jflat = jax_checkpoint._flatten(back.params, "model/")
    assert set(jflat) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(jflat[k]), flat[k], err_msg=k)
    adam = back.opt_state[1]
    assert int(adam.count) == 5
    for moment in ("mu", "nu"):
        for k, v in jax_checkpoint._flatten(getattr(adam, moment), "").items():
            np.testing.assert_array_equal(np.asarray(v), getattr(opt, moment)[k].numpy(), err_msg=k)


def test_unmappable_opt_state_is_left_out(tmp_path, caplog):
    """An Adam state that covers only part of the model maps to nothing,
    with a warning; the weights still load."""
    config, flat, opt, _ = _setup(tmp_path, {})
    pth = tmp_path / "partial.pth"
    checkpoint.save_torch_checkpoint(pth, flat, config, 6, 0.25, 1, opt)
    ckpt = torch.load(pth, weights_only=True)
    del ckpt["optimizer"]["state"][0]
    torch.save(ckpt, pth)
    saved: dict = {}
    with caplog.at_level(logging.WARNING):
        got, meta = checkpoint.read_checkpoint(pth, config, saved)
    assert saved == {} and "opt_treedef" not in meta
    assert "could not import torch optimizer state" in caplog.text
    assert set(got) == set(flat)


def test_train_cli_resumes_from_pth(corpus, tmp_path, caplog):  # noqa: F811
    """The train CLI's ``--checkpoint x.pth``: one epoch, its checkpoint
    written as a reference ``.pth``, and one epoch resumed from that
    ``.pth`` restores the Adam state (count 3) and gives the metrics line
    and the checkpoint of the epoch resumed from the ``.npz`` bit for bit."""
    from glow_tts_train_tpu_torch.config import load_config

    _run_cli(tmp_path, corpus, "first", {"epochs": 1})
    npz = tmp_path / "first" / "checkpoint_4.npz"
    config = load_config([corpus / "config.json"])
    saved: dict = {}
    flat, meta = checkpoint.read_npz(npz, saved)
    hp = model.hyper_from_config(config)
    params = checkpoint.params_from_numpy(flat, hp).flat()
    opt, why = checkpoint.restore_opt_state(saved, meta["opt_treedef"], params, config.scheduler)
    assert opt is not None, why
    pth = tmp_path / "checkpoint_4.pth"
    checkpoint.save_torch_checkpoint(
        pth, flat, config, meta["global_step"], meta["learning_rate"], 1, opt
    )
    from_npz = _run_cli(tmp_path, corpus, "from_npz", {"epochs": 1}, "--checkpoint", str(npz))
    with caplog.at_level(logging.INFO):
        from_pth = _run_cli(tmp_path, corpus, "from_pth", {"epochs": 1}, "--checkpoint", str(pth))
    assert "Restored Adam state (count=3)" in caplog.text
    assert "dropped" not in caplog.text
    assert [{k: line[k] for k in RESUMED_KEYS} for line in from_pth] == [
        {k: line[k] for k in RESUMED_KEYS} for line in from_npz
    ]
    with np.load(tmp_path / "from_npz" / "checkpoint_7.npz") as a, \
            np.load(tmp_path / "from_pth" / "checkpoint_7.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

"""The port's FLOP model (``utils/flops.py``) and sequence helpers
(``utils/text.py``) against the JAX package's.

For each config, one JSON loads through each package's ``load_config``
and ``hyper_from_config``; the port's six functions must equal the JAX
package's at several shapes, ``wn_residuals: "store"`` against JAX's
``remat="none"`` and ``"recompute"`` against ``remat="full"``.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from glow_tts_train_tpu import config as jax_config
from glow_tts_train_tpu.models import glow_tts as jax_model
from glow_tts_train_tpu.utils import flops as jax_flops
from glow_tts_train_tpu.utils import intersperse as jax_intersperse
from glow_tts_train_tpu.utils import shift_1d as jax_shift_1d
from glow_tts_train_tpu_torch import config as port_config
from glow_tts_train_tpu_torch.models import glow_tts as port_model
from glow_tts_train_tpu_torch.utils import flops, intersperse, shift_1d

REPO = Path(__file__).resolve().parent.parent
CONFIGS = {
    "base": ("base.json", {}),
    "large": ("large.json", {}),
    "multispeaker": ("multispeaker.json", {}),
    "base_mean_only_false": ("base.json", {"model": {"mean_only": False}}),
    "base_window_size_null": ("base.json", {"model": {"window_size": None}}),
    "base_no_prenet": ("base.json", {"model": {"prenet": False}}),
}
FUNCTIONS = ("encoder_forward_flops", "decoder_forward_flops", "alignment_flops",
             "forward_flops", "training_flops", "model_flops")
# (b, t_x, t_y): the smoke's training bucket, the shipped batch, odd lengths
SHAPES = ((16, 192, 1408), (32, 128, 1024), (3, 37, 211))
MODES = {"store": "none", "recompute": "full"}


def _hypers(tmp_path, name, residuals):
    file, override = CONFIGS[name]
    over = tmp_path / "override.json"
    over.write_text(json.dumps({**override, "wn_residuals": residuals}))
    paths = [REPO / "configs" / file, over]
    port_hp = port_model.hyper_from_config(port_config.load_config(paths))
    jax_hp = jax_model.hyper_from_config(
        jax_config.TrainingConfig.load_and_merge(jax_config.TrainingConfig(), paths)
    )._replace(remat=MODES[residuals])
    assert port_hp.wn_residuals == residuals
    return port_hp, jax_hp


def _call(module, fn, hp, b, t_x, t_y):
    f = getattr(module, fn)
    if fn == "encoder_forward_flops":
        return f(hp, b, t_x)
    if fn == "decoder_forward_flops":
        return f(hp, b, t_y)
    return f(hp, b, t_x, t_y)


@pytest.mark.parametrize("residuals", sorted(MODES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_equal_the_jax_packages(tmp_path, name, residuals):
    port_hp, jax_hp = _hypers(tmp_path, name, residuals)
    for b, t_x, t_y in SHAPES:
        for fn in FUNCTIONS:
            got = _call(flops, fn, port_hp, b, t_x, t_y)
            want = _call(jax_flops, fn, jax_hp, b, t_x, t_y)
            assert got == want and got > 0, (fn, (b, t_x, t_y), got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_flops_count_no_recompute(tmp_path, name):
    """``model_flops`` is the same in both residual modes; ``training_flops``
    adds one decoder forward in recompute mode and equals ``model_flops``
    in store mode."""
    store, _ = _hypers(tmp_path, name, "store")
    recompute, _ = _hypers(tmp_path, name, "recompute")
    for b, t_x, t_y in SHAPES:
        model = flops.model_flops(store, b, t_x, t_y)
        assert flops.model_flops(recompute, b, t_x, t_y) == model
        assert flops.training_flops(store, b, t_x, t_y) == model
        assert flops.training_flops(recompute, b, t_x, t_y) == (
            model + flops.decoder_forward_flops(recompute, b, t_y))


@pytest.mark.parametrize("seq", [[], [3], [1, 2, 3], ["a", "b"], (4, 5, 6, 7)])
def test_intersperse_equals_the_jax_packages(seq):
    assert intersperse(seq, 0) == jax_intersperse(seq, 0)
    assert intersperse(seq, "_") == jax_intersperse(seq, "_")


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 4)])
def test_shift_1d_equals_the_jax_packages(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    got = shift_1d(x)
    np.testing.assert_array_equal(got, jax_shift_1d(x))
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_array_equal(got[..., 0], 0)
    np.testing.assert_array_equal(got[..., 1:], x[..., :-1])

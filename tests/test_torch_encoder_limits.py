"""``encoder_fuse: "auto"`` resolved by the port's encoder kernel's own
limits (``encoder_cuda.kernel_takes``: a head width that is a multiple of
8 and at most 128, a window of at most 16, no ``block_length``): a config
outside them resolves to false and trains and serves op by op, as
``window_size: null`` does, instead of reaching the kernel and its
``ValueError`` on the card.  On the CPU; the card's side is in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch import checkpoint, training
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import encoder_cuda

from helpers import random_batch, tiny_config

# (model overrides, encoder_fuse "auto" resolves to)
CASES = {
    "head_width_192": (dict(hidden_channels=384, hidden_channels_enc=384, n_heads=2), False),
    "window_20": (dict(window_size=20), False),
    "head_width_12": (dict(hidden_channels=24, hidden_channels_enc=24, n_heads=2), False),
    "head_width_128_window_16": (
        dict(hidden_channels=256, hidden_channels_enc=256, n_heads=2, window_size=16), True),
    "tiny": ({}, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_auto_resolves_by_the_kernels_limits(case):
    """"auto" -> whether ``kernel_takes`` the encoder, which serving reads
    too (``encoder_kernel_fits``); an explicit value still wins."""
    over, want = CASES[case]
    config = tiny_config(**over)
    hp = model.hyper_from_config(config)
    assert hp.encoder_fuse is want and hp.encoder_kernel_fits is want
    m = config.model
    assert encoder_cuda.kernel_takes(m.hidden_channels_enc, m.n_heads, m.window_size,
                                     m.block_length) is want
    config.encoder_fuse = True
    assert model.hyper_from_config(config).encoder_fuse is True


@pytest.mark.parametrize("case", ["head_width_192", "window_20"])
def test_configs_past_the_limits_train_a_step(case):
    """Head width 192 and window 20 train one step through
    ``training.make_train_step`` with dropout on (the text side op by op,
    its masks from the generator): finite metrics, every param finite, and
    the step equal to the one with ``encoder_fuse: false`` spelled out,
    bit for bit (the same path)."""
    runs = []
    for fuse in ("auto", False):
        config = tiny_config(**CASES[case][0])
        config.encoder_fuse = fuse
        hp = model.hyper_from_config(config)
        flat = {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, 1).items()}
        state = training.TrainState(training.trainable_model(flat, hp, "cpu"))
        batch = training.batch_to(random_batch(config, np.random.default_rng(3), b=4), "cpu")
        gens = [torch.Generator().manual_seed(11) for _ in range(2)]
        metrics = training.make_train_step(config)(state, batch, *gens)
        runs.append(({k: float(v) for k, v in metrics.items()}, state.model.flat()))
    (metrics, params), (ref_metrics, ref_params) = runs
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics == ref_metrics
    for k, p in params.items():
        assert bool(p.isfinite().all()), k
        assert bool((p == ref_params[k]).all()), k

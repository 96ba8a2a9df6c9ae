"""Configuration of the port: the JAX package's ``TrainingConfig``
dataclasses (``glow_tts_train_tpu/config.py``, which imports no jax),
loaded from JSON files."""

import typing
from pathlib import Path


def load_config(paths: typing.Sequence = ()):
    """The defaults merged with each JSON file of ``paths`` in order ->
    ``TrainingConfig``."""
    from glow_tts_train_tpu.config import TrainingConfig

    config = TrainingConfig()
    if paths:
        config = TrainingConfig.load_and_merge(config, [Path(p) for p in paths])
    return config

"""Sequence helpers, copied from glow_tts_train_tpu ``utils/text.py``
(reference utils.py:8-11, :47-49)."""

import typing

import numpy as np


def intersperse(lst: typing.Sequence, item) -> list:
    """Insert ``item`` between (and around) every element: used by front-ends
    that train with blank tokens between phonemes (reference utils.py:8-11)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def shift_1d(x: np.ndarray) -> np.ndarray:
    """Right-shift along the last axis with zero fill (reference utils.py:47-49)."""
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(1, 0)])[..., :-1]

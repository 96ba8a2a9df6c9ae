"""Sequence masks and duration -> alignment path (glow_tts_train_tpu
ops/masks.py), channels-last: masks are ``[b, t, 1]``."""

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask [b, t]: True where position < length."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def time_mask(
    lengths: torch.Tensor, max_length: int, dtype=torch.float32
) -> torch.Tensor:
    """Float mask [b, t, 1] for channels-last activations."""
    return sequence_mask(lengths, max_length).to(dtype)[:, :, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Integer durations [b, t_x] -> 0/1 monotonic path [b, t_x, t_y] where
    row x covers frames [cum[x-1], cum[x]); fp32 cumsum, as the JAX
    package's."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration.to(torch.float32), dim=1)
    frame_pos = torch.arange(t_y, device=duration.device, dtype=torch.float32)
    path = (frame_pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    path = path - torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask

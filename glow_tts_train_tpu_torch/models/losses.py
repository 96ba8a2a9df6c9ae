"""Training losses (glow_tts_train_tpu models/losses.py), in f32."""

import math

import torch


def mle_loss(z, m, logs, logdet, mask) -> torch.Tensor:
    """Flow negative log-likelihood: z, m, logs [b, t, c]; logdet [b];
    mask [b, t, 1].  Normalised by the masked element count (batch, time
    and channels), with the 1/2 log(2 pi) constant added back."""
    z, m, logs = z.to(torch.float32), m.to(torch.float32), logs.to(torch.float32)
    maskf = mask.to(torch.float32)
    loss = torch.sum(logs) + 0.5 * torch.sum(torch.exp(-2.0 * logs) * torch.square(z - m))
    loss = loss - torch.sum(logdet.to(torch.float32))
    loss = loss / torch.sum(torch.ones_like(z) * maskf)
    return loss + 0.5 * math.log(2 * math.pi)


def duration_loss(logw, logw_, lengths) -> torch.Tensor:
    """MSE on log-durations, normalised by the total phoneme count."""
    diff = logw.to(torch.float32) - logw_.to(torch.float32)
    return torch.sum(torch.square(diff)) / torch.sum(lengths.to(torch.float32))

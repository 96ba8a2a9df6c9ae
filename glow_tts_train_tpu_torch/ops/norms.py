"""Channel LayerNorm (glow_tts_train_tpu ops/norms.py): over the last
axis, eps 1e-4, biased variance, in fp32."""

import typing

import torch

LN_EPS = 1e-4


def layer_norm(
    x: torch.Tensor, params: typing.Dict[str, torch.Tensor], eps: float = LN_EPS
) -> torch.Tensor:
    return layer_norm_affine(x, params["gamma"], params["beta"], eps)


def layer_norm_affine(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = LN_EPS
) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.reshape(-1) + beta.reshape(-1)).to(x.dtype)

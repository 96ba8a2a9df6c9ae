"""Channels-last 1-D convolution and weight norm (glow_tts_train_tpu
ops/conv.py).

Conv params are ``{"w": [k, c_in, c_out], "b": [c_out]}``; weight-normed
params ``{"v", "g", "b"}``.  These are plain PyTorch, for the paths that
run outside the kernels (embedding-side projections, weight folds) and
the kernels' plain versions."""

import typing

import torch
import torch.nn.functional as F

Params = typing.Dict[str, torch.Tensor]


def weight_norm_effective(params: Params) -> torch.Tensor:
    """w = g * v / max(||v||, 1e-12), the norm over (k, c_in) per output
    channel, in fp32."""
    v = params["v"].to(torch.float32)
    g = params["g"].to(torch.float32)
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    return v * (g[None, None, :] / torch.clamp(norm, min=1e-12))


def conv1d(
    x: torch.Tensor, params: Params, dilation: int = 1
) -> torch.Tensor:
    """x [b, t, c_in] -> [b, t, c_out] with torch-style symmetric "same"
    padding ``(k*d - d) // 2``."""
    w = weight_norm_effective(params) if "v" in params else params["w"]
    w = w.to(x.dtype)
    k = w.shape[0]
    b = params["b"].to(x.dtype)
    if k == 1:
        return x @ w[0] + b
    pad = (k * dilation - dilation) // 2
    out = F.conv1d(
        x.transpose(1, 2), w.permute(2, 1, 0), b, padding=pad, dilation=dilation
    )
    return out.transpose(1, 2)


def offsets(kernel_size: int, dilation: int) -> typing.Tuple[int, ...]:
    """Tap offsets of the kernels' convs (wn_pallas.py ``_offsets``)."""
    return tuple(dilation * (k - kernel_size // 2) for k in range(kernel_size))


def _shifted(x: torch.Tensor, off: int) -> torch.Tensor:
    """out[:, i] = x[:, i + off], zero where i + off is outside [0, t)."""
    t = x.shape[1]
    if off >= 0:
        s = min(off, t)
        return F.pad(x[:, s:], (0, 0, 0, s))
    s = min(-off, t)
    return F.pad(x[:, : t - s], (0, 0, s, 0))


def conv_taps(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, taps: int, dilation: int = 1
) -> torch.Tensor:
    """The kernels' conv: the im2col of x [b, t, c] at ``offsets(taps,
    dilation)`` (tap-major columns) times a folded weight [taps * c, n],
    plus b — the same gather the CUDA GEMM does while staging."""
    cols = torch.cat([_shifted(x, o) for o in offsets(taps, dilation)], dim=-1)
    return cols @ w + b.reshape(-1)

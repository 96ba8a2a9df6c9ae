"""The prenet and duration-predictor conv stacks: CUDA kernels
(``csrc/text.cu``) and their plain PyTorch versions.

:func:`prenet` replaces ``glow_tts_train_tpu/ops/text_pallas.py::
_prenet_fwd_kernel`` (3 x [masked k=5 conv -> LN -> ReLU], residual 1x1
projection, x mask); :func:`duration_stack` replaces ``::_dp_fwd_kernel``
(2 x [masked k=3 conv -> ReLU -> LN]).  The duration predictor's 1-channel
projection stays outside the kernel, as in the JAX package.

Bound on the card: both stacks are small f32 GEMMs (rows = batch * t_x,
192 or 256 columns) whose time at serving sizes is launch latency and
per-block occupancy, not FLOPs or bytes.  The kernels gather each conv's
taps while staging the GEMM operand (no im2col buffer) and keep one
launch per GEMM and per LayerNorm.

Weights are the JAX folds' layout (``prenet_weights``/``dp_weights``):
conv weights [taps * c_in, c_out], tap-major rows.
"""

import typing

import torch

from .. import kernels
from .attention import dropout
from .conv import conv1d, conv_taps
from .norms import layer_norm_affine

Params = typing.Dict[str, typing.Any]


def prenet_weights(params: Params) -> tuple:
    """Prenet params -> (W [L, K*h, h], b [L, h], gamma [L, h], beta [L, h],
    W_proj [h, h], b_proj [1, h])."""
    layers = params["layers"]
    L, K, h = layers["conv"]["w"].shape[:3]
    f32 = torch.float32
    return (
        layers["conv"]["w"].reshape(L, K * h, -1).to(f32).contiguous(),
        layers["conv"]["b"].to(f32).contiguous(),
        layers["norm"]["gamma"].to(f32).contiguous(),
        layers["norm"]["beta"].to(f32).contiguous(),
        params["proj"]["w"][0].to(f32).contiguous(),
        params["proj"]["b"].to(f32).reshape(1, -1).contiguous(),
    )


def dp_weights(params: Params) -> tuple:
    """Duration-predictor params -> (W1 [K*c, f], b1, gamma1, beta1,
    W2 [K*f, f], b2, gamma2, beta2), vectors as [1, f]."""
    f32 = torch.float32

    def conv(p):
        w = p["w"]
        return (
            w.reshape(w.shape[0] * w.shape[1], -1).to(f32).contiguous(),
            p["b"].to(f32).reshape(1, -1).contiguous(),
        )

    def norm(p):
        return (
            p["gamma"].to(f32).reshape(1, -1).contiguous(),
            p["beta"].to(f32).reshape(1, -1).contiguous(),
        )

    return (
        *conv(params["conv_1"]), *norm(params["norm_1"]),
        *conv(params["conv_2"]), *norm(params["norm_2"]),
    )


def prenet_plain(
    weights: tuple,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Plain version of :func:`prenet` (text_pallas.py ``_prenet_fwd_math``);
    differentiable, and with dropout after each ReLU when ``generator`` is
    given (the training encoder, ``encoder_fuse: false``)."""
    w, b, gamma, beta, wp, bp = weights
    taps = w.shape[1] // x.shape[-1]
    cur = x
    for l in range(w.shape[0]):
        pre = conv_taps(cur * x_mask, w[l], b[l], taps)
        cur = dropout(torch.relu(layer_norm_affine(pre, gamma[l], beta[l])), p_dropout, generator)
    return (x + cur @ wp + bp) * x_mask


def prenet(weights: tuple, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """ConvReluNorm prenet, x [b, t, h], x_mask [b, t, 1] -> [b, t, h]."""
    if kernels.route(x) == "plain":
        return prenet_plain(weights, x, x_mask)
    w, b, gamma, beta, wp, bp = weights
    batch, t, h = x.shape
    L = w.shape[0]
    taps = w.shape[1] // h
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, w=w, b=b, gamma=gamma, beta=beta, wp=wp, bp=bp
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("w", w, (L, taps * h, h))
    kernels.check_shape("wp", wp, (h, h))
    out = torch.empty_like(x)
    pre = torch.empty_like(x)
    cur = torch.empty_like(x)
    kernels.PRENET(
        x, x_mask, w, b, gamma, beta, wp, bp, out, pre, cur, batch, t, h, L, taps
    )
    return out


def duration_stack_plain(
    weights: tuple,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Plain version of :func:`duration_stack` (text_pallas.py
    ``_dp_fwd_math``); differentiable, and with dropout after each
    LayerNorm when ``generator`` is given."""
    w1, b1, g1, be1, w2, b2, g2, be2 = weights
    taps = w1.shape[0] // x.shape[-1]
    cur = x
    for w, b, g, be in ((w1, b1, g1, be1), (w2, b2, g2, be2)):
        cur = layer_norm_affine(torch.relu(conv_taps(cur * x_mask, w, b, taps)), g, be)
        cur = dropout(cur, p_dropout, generator)
    return cur


def duration_stack(weights: tuple, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """Duration-predictor conv stack, x [b, t, c] -> [b, t, f]."""
    if kernels.route(x) == "plain":
        return duration_stack_plain(weights, x, x_mask)
    w1, b1, g1, be1, w2, b2, g2, be2 = weights
    batch, t, c = x.shape
    taps = w1.shape[0] // c
    f = w1.shape[1]
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, w1=w1, b1=b1, g1=g1, be1=be1,
        w2=w2, b2=b2, g2=g2, be2=be2,
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("w1", w1, (taps * c, f))
    kernels.check_shape("w2", w2, (taps * f, f))
    out = x.new_empty((batch, t, f))
    pre = x.new_empty((batch, t, f))
    kernels.DURATION_STACK(
        x, x_mask, w1, b1, g1, be1, w2, b2, g2, be2, out, pre, batch, t, c, f, taps
    )
    return out


def duration_predictor(
    weights: tuple, proj: Params, x: torch.Tensor, x_mask: torch.Tensor
) -> torch.Tensor:
    """Log-durations [b, t, 1]: the stack, then the 1-channel projection."""
    h2 = duration_stack(weights, x, x_mask)
    return conv1d(h2 * x_mask, proj) * x_mask

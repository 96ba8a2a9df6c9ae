"""One text-encoder layer: CUDA kernel (``csrc/encoder.cu``) and its plain
PyTorch version.

:func:`encoder_layer` replaces ``glow_tts_train_tpu/ops/encoder_pallas.py::
_fwd_kernel`` (math ``_layer_fwd_math``): masked input -> Q/K/V -> per head
softmax(q.k^T/sqrt(d) + banded rel-k, -1e4 fill) . v + banded rel-v ->
output projection -> residual LN -> conv FFN -> residual LN.

Bound on the card: at serving sizes (t_x of tens to hundreds, h = 192,
f = 768) the FFN GEMMs hold most of the FLOPs but every piece is small,
so launch latency and the attention core's per-(sample, head) parallelism
bound it.  The design keeps the TPU kernel's banded rel-pos form (2w+1
diagonals instead of the [t, 2t-1] pad/reshape) and streams keys through
shared memory with an online softmax, so no [t, t] score matrix is
written; the GEMMs gather conv taps on load and fuse bias/ReLU/mask.
The TPU kernel's sample packing (``_pick_pack``) is a TPU device and is
not ported.

Weights are ``fold_encoder_layer``'s tuple, the JAX fold's order and
layout.
"""

import typing

import torch

from .. import kernels
from .attention import attention_core
from .conv import conv_taps
from .norms import layer_norm_affine

Params = typing.Dict[str, typing.Any]


def fold_encoder_layer(layer: Params) -> tuple:
    """Layer params -> (wq, bq, wk, bk, wv, bv, wo, bo, rel_k [2w+1, d],
    rel_v, gamma1, beta1, gamma2, beta2, W1 [K*h, f], c1, W2 [K*f, h], c2);
    1x1 weights [h, h], vectors [1, n].  Reshapes and casts only."""
    f32 = torch.float32
    at, ffn = layer["attn"], layer["ffn"]

    def cw(conv):
        return conv["w"][0].to(f32).contiguous()

    def vec(a):
        return a.to(f32).reshape(1, -1).contiguous()

    def ffn_w(conv):
        w = conv["w"]
        return w.reshape(w.shape[0] * w.shape[1], -1).to(f32).contiguous()

    return (
        cw(at["q"]), vec(at["q"]["b"]),
        cw(at["k"]), vec(at["k"]["b"]),
        cw(at["v"]), vec(at["v"]["b"]),
        cw(at["o"]), vec(at["o"]["b"]),
        at["emb_rel_k"][0].to(f32).contiguous(),
        at["emb_rel_v"][0].to(f32).contiguous(),
        vec(layer["norm_1"]["gamma"]), vec(layer["norm_1"]["beta"]),
        vec(layer["norm_2"]["gamma"]), vec(layer["norm_2"]["beta"]),
        ffn_w(ffn["conv_1"]), vec(ffn["conv_1"]["b"]),
        ffn_w(ffn["conv_2"]), vec(ffn["conv_2"]["b"]),
    )


def encoder_layer_plain(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, n_heads: int,
    window_size: int,
) -> torch.Tensor:
    """Plain version of :func:`encoder_layer`."""
    (wq, bq, wk, bk, wv, bv, wo, bo, rel_k, rel_v,
     g1, be1, g2, be2, w1, c1, w2, c2) = weights
    taps = w1.shape[0] // x.shape[-1]
    m = x_mask[:, :, 0]
    xm = x * x_mask
    att = attention_core(
        xm @ wq + bq, xm @ wk + bk, xm @ wv + bv,
        m[:, None, :] * m[:, :, None], n_heads,
        rel_k[None], rel_v[None], window_size,
    )
    x1 = layer_norm_affine(xm + (att @ wo + bo), g1, be1)
    r = torch.relu(conv_taps(x1 * x_mask, w1, c1, taps))
    y2 = conv_taps(r * x_mask, w2, c2, taps) * x_mask
    return layer_norm_affine(x1 + y2, g2, be2)


def encoder_layer(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, n_heads: int,
    window_size: int,
) -> torch.Tensor:
    """One encoder layer, x [b, t, h], x_mask [b, t, 1] -> [b, t, h]
    (unmasked, like the JAX layer; the stack masks its output)."""
    if kernels.route(x) == "plain":
        return encoder_layer_plain(weights, x, x_mask, n_heads, window_size)
    (wq, bq, wk, bk, wv, bv, wo, bo, rel_k, rel_v,
     g1, be1, g2, be2, w1, c1, w2, c2) = weights
    batch, t, h = x.shape
    d = h // n_heads
    taps = w1.shape[0] // h
    f = w1.shape[1]
    if d > 128 or 2 * window_size + 1 > 33:
        raise ValueError(
            f"the encoder kernel takes head width <= 128 and window <= 16; "
            f"got {d} and {window_size}"
        )
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
        wo=wo, bo=bo, rel_k=rel_k, rel_v=rel_v, g1=g1, be1=be1, g2=g2, be2=be2,
        w1=w1, c1=c1, w2=w2, c2=c2,
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("rel_k", rel_k, (2 * window_size + 1, d))
    kernels.check_shape("w1", w1, (taps * h, f))
    kernels.check_shape("w2", w2, (taps * f, h))
    out = torch.empty_like(x)
    qkv = x.new_empty((batch, t, 3 * h))
    att = torch.empty_like(x)
    x1 = torch.empty_like(x)
    ffn = x.new_empty((batch, t, f))
    kernels.ENCODER_LAYER(
        x, x_mask, wq, bq, wk, bk, wv, bv, wo, bo, rel_k, rel_v,
        g1, be1, g2, be2, w1, c1, w2, c2, out, qkv, att, x1, ffn,
        batch, t, h, n_heads, window_size, f, taps,
    )
    return out

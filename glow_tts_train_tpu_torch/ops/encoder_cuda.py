"""One text-encoder layer: CUDA kernels (``csrc/encoder.cu``,
``csrc/encoder_train.cu``) and their plain PyTorch versions.

:func:`encoder_layer` replaces ``glow_tts_train_tpu/ops/encoder_pallas.py::
_fwd_kernel`` (math ``_layer_fwd_math``): masked input -> Q/K/V -> per head
softmax(q.k^T/sqrt(d) + banded rel-k, -1e4 fill) . v + banded rel-v ->
output projection -> residual LN -> conv FFN -> residual LN.
:func:`encoder_layer_bwd` replaces ``::_bwd_kernel``: from (weights, x,
mask, seed) and the output cotangent it recomputes the layer and returns
dx and the weight gradients.  :class:`EncoderLayerTrain` joins the two
as a ``torch.autograd.Function`` that saves only (weights, x, mask).

Dropout is the JAX kernel's per-site keep mask (``wn_cuda.regen_keep``)
at its ``pack = 1`` numbering, ``H + 3`` sites for ``H`` heads: site
``hd`` on head ``hd``'s probabilities ``[t, t]``, site ``H`` on the
attention output ``[t, h]`` after its projection, ``H + 1`` on the FFN's
ReLU ``[t, f]``, ``H + 2`` on the FFN's masked output ``[t, h]``; sample
``i`` draws from ``seed + i``.  The TPU kernel's sample packing
(``_pick_pack``), which renumbers the sites, is a TPU device and is not
ported.

Bound on the card: at training sizes ([16, 192, 192], f = 768) the
operations of the FFN's products, which run on the tensor cores (3xTF32;
split-K for the short, deep shapes of t_x <= 192); at serving sizes (t_x
of tens to hundreds) every piece is small, so launch latency and the
attention core's per-(sample, head) parallelism bound it.  The design
keeps the TPU kernel's banded rel-pos form (2w+1 diagonals instead of the
[t, 2t-1] pad/reshape) and streams keys through shared memory with an
online softmax, so the forward writes no [t, t] score matrix; the
backward computes each score once and writes the score cotangents and
dropped probabilities ([batch, heads, t, t] each) for its three products.
The GEMMs gather conv taps on load and fuse bias/ReLU/mask and their
backward tails; the transposed products read the weights as they lie.

Weights: ``fold_encoder_layer``'s 18-tuple (the JAX fold's order and
layout) or :func:`merge_qkv`'s 14-tuple, the kernels' layout, whose Q/K/V
projection is one [h, 3h] weight (what serving folds once at load and
training once a step, under autograd).  Every function takes either and
returns gradients in the layout it was given.
"""

import typing

import torch

from .. import kernels
from .attention import attention_core
from .conv import conv_taps
from .norms import layer_norm_affine
from .text_cuda import plain_grads
from .wn_cuda import drop_args, site_dropout

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


def merge_qkv(weights: tuple) -> tuple:
    """``fold_encoder_layer``'s 18-tuple -> the kernels' 14-tuple
    (wqkv [h, 3h], bqkv [1, 3h], wo, bo, rel_k, rel_v, gamma1, beta1,
    gamma2, beta2, W1, c1, W2, c2): Q, K and V side by side, one
    differentiable concatenation."""
    wq, bq, wk, bk, wv, bv, *rest = weights
    return (torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv], dim=1), *rest)


def _kernel_layout(weights: tuple) -> typing.Tuple[tuple, bool]:
    """-> (the 14-tuple, whether ``weights`` was the 18-tuple)."""
    if len(weights) == 18:
        return merge_qkv(weights), True
    if len(weights) != 14:
        raise ValueError(f"an encoder layer takes 18 or 14 weights; got {len(weights)}")
    return tuple(weights), False


def _split_qkv_grads(grads: tuple) -> tuple:
    """(dx, dwqkv, dbqkv, *rest) -> (dx, dwq, dbq, dwk, dbk, dwv, dbv, *rest)."""
    dx, dw, db, *rest = grads
    h = dw.shape[0]
    parts = [(dw[:, i * h:(i + 1) * h].contiguous(), db[:, i * h:(i + 1) * h].contiguous())
             for i in range(3)]
    return (dx, *(a for pair in parts for a in pair), *rest)


def encoder_layer_plain(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, n_heads: int,
    window_size: int, p_dropout: float = 0.0, seed: int = 0,
    gates: typing.Optional[typing.Sequence[torch.Tensor]] = None,
    saves: typing.Optional[dict] = None,
) -> torch.Tensor:
    """Plain version of :func:`encoder_layer`; differentiable.  With
    ``p_dropout`` > 0 the kernel's keep masks of ``seed``.  ``gates`` (one
    tensor: where the FFN's dropped, masked ReLU output is positive)
    replace that ReLU and its keep mask; ``saves`` receives the ReLU's input
    and this run's gate (see ``text_cuda``)."""
    (wqkv, bqkv, wo, bo, rel_k, rel_v,
     g1, be1, g2, be2, w1, c1, w2, c2), _ = _kernel_layout(weights)
    h = x.shape[-1]
    taps = w1.shape[0] // h
    n_sites = n_heads + 3

    def drop(a, site):
        return site_dropout(a, seed, site, n_sites, p_dropout)

    m = x_mask[:, :, 0]
    xm = x * x_mask
    q, k, v = (xm @ wqkv + bqkv).split(h, dim=-1)
    att = attention_core(
        q, k, v,
        m[:, None, :] * m[:, :, None], n_heads,
        rel_k[None], rel_v[None], window_size,
        drop_probs=lambda p: drop(p, 0),
    )
    x1 = layer_norm_affine(xm + drop(att @ wo + bo, n_heads), g1, be1)
    pre = conv_taps(x1 * x_mask, w1, c1, taps)
    if gates is not None:
        r = pre * gates[0] * drop_args(p_dropout)[2]
    else:
        r = drop(torch.relu(pre), n_heads + 1)
    if saves is not None:
        saves["pre"], saves["gates"] = [pre.detach()], [(r * x_mask).detach() > 0]
    y2 = drop(conv_taps(r * x_mask, w2, c2, taps) * x_mask, n_heads + 2)
    return layer_norm_affine(x1 + y2, g2, be2)


def _check_layer(weights, x, x_mask, n_heads, window_size):
    (wqkv, bqkv, wo, bo, rel_k, rel_v, g1, be1, g2, be2, w1, c1, w2, c2) = weights
    batch, t, h = x.shape
    d = h // n_heads
    taps = w1.shape[0] // h
    f = w1.shape[1]
    if d > 128 or d % 8 or 2 * window_size + 1 > 33:
        raise ValueError(
            f"the encoder kernel takes a head width that is a multiple of 8 and at most "
            f"128, and window <= 16; got {d} and {window_size}"
        )
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, wqkv=wqkv, bqkv=bqkv,
        wo=wo, bo=bo, rel_k=rel_k, rel_v=rel_v, g1=g1, be1=be1, g2=g2, be2=be2,
        w1=w1, c1=c1, w2=w2, c2=c2,
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("wqkv", wqkv, (h, 3 * h))
    kernels.check_shape("rel_k", rel_k, (2 * window_size + 1, d))
    kernels.check_shape("rel_v", rel_v, (2 * window_size + 1, d))
    kernels.check_shape("w1", w1, (taps * h, f))
    kernels.check_shape("w2", w2, (taps * f, h))
    for name, table in (("rel_k", rel_k), ("rel_v", rel_v)):
        if table.data_ptr() % 16:
            raise ValueError(f"{name}: the attention core reads it 16 bytes at a time; "
                             f"its storage is not 16-byte aligned")
    return batch, t, h, d, f, taps


def encoder_layer(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, n_heads: int,
    window_size: int, p_dropout: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """One encoder layer, x [b, t, h], x_mask [b, t, 1] -> [b, t, h]
    (unmasked, like the JAX layer; the stack masks its output); with
    ``p_dropout`` > 0 the keep masks of ``seed``."""
    if kernels.route(x) == "plain":
        return encoder_layer_plain(weights, x, x_mask, n_heads, window_size, p_dropout, seed)
    weights, _ = _kernel_layout(weights)
    batch, t, h, d, f, taps = _check_layer(weights, x, x_mask, n_heads, window_size)
    out = torch.empty_like(x)
    floats = kernels.encoder_scratch_floats(batch, t, h, n_heads, window_size, f, taps, False)
    scratch = x.new_empty((floats,))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.ENCODER_LAYER(
        x, x_mask, *weights, out, scratch, floats,
        batch, t, h, n_heads, window_size, f, taps, drop, int(seed), threshold, scale,
    )
    return out


def encoder_layer_bwd_plain(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, dout: torch.Tensor,
    n_heads: int, window_size: int, p_dropout: float = 0.0, seed: int = 0,
    gates=None, saves=None,
) -> tuple:
    """Plain version of :func:`encoder_layer_bwd`: autograd of
    :func:`encoder_layer_plain` with the same keep masks (at the given
    ``gates``, if any)."""
    return plain_grads(
        lambda w, xx: encoder_layer_plain(
            w, xx, x_mask, n_heads, window_size, p_dropout, seed, gates, saves
        ),
        weights, x, dout,
    )


def encoder_layer_bwd(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, dout: torch.Tensor,
    n_heads: int, window_size: int, p_dropout: float = 0.0, seed: int = 0,
    saves: typing.Optional[dict] = None,
) -> tuple:
    """The layer's backward from (weights, x, mask, seed): recomputes the
    forward, then -> (dx, *dweights) in the given weights' order, each
    shaped as its primal.  ``saves`` receives the recomputed forward's FFN
    gate (``gates``) and its output (``out``)."""
    if kernels.route(x) == "plain":
        return encoder_layer_bwd_plain(
            weights, x, x_mask, dout, n_heads, window_size, p_dropout, seed, saves=saves
        )
    weights, split = _kernel_layout(weights)
    batch, t, h, d, f, taps = _check_layer(weights, x, x_mask, n_heads, window_size)
    kernels.check_operands(x.device, dout=dout)
    kernels.check_shape("dout", dout, x.shape)
    grads = tuple(torch.empty_like(a) for a in (x, *weights))
    out = torch.empty_like(x)
    ffn = x.new_empty((batch, t, f))
    floats = kernels.encoder_scratch_floats(batch, t, h, n_heads, window_size, f, taps, True)
    scratch = x.new_empty((floats,))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.ENCODER_LAYER_BWD(
        x, x_mask, *weights, dout, *grads, out, ffn, scratch, floats,
        batch, t, h, n_heads, window_size, f, taps, drop, int(seed), threshold, scale,
    )
    if saves is not None:
        saves["gates"] = [ffn > 0]
        saves["out"] = out
    return _split_qkv_grads(grads) if split else grads


class EncoderLayerTrain(torch.autograd.Function):
    """One training encoder layer: :func:`encoder_layer` forward,
    :func:`encoder_layer_bwd` backward.  Saves (weights, x, mask) only; the
    backward recomputes, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, x_mask, cfg, *weights):
        ctx.cfg = cfg
        ctx.save_for_backward(x, x_mask, *weights)
        return encoder_layer(weights, x, x_mask, *cfg)

    @staticmethod
    def backward(ctx, dout):
        x, x_mask, *weights = ctx.saved_tensors
        grads = encoder_layer_bwd(tuple(weights), x, x_mask, dout.contiguous(), *ctx.cfg)
        return (grads[0], None, None, *grads[1:])


def encoder_layer_train(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, n_heads: int,
    window_size: int, p_dropout: float = 0.0, seed: int = 0,
) -> torch.Tensor:
    """:func:`encoder_layer` with its hand-written backward; an 18-tuple
    is merged under autograd first, so its leaves get their gradients."""
    weights, _ = _kernel_layout(weights)
    cfg = (int(n_heads), int(window_size), float(p_dropout), int(seed))
    return EncoderLayerTrain.apply(x, x_mask, cfg, *weights)

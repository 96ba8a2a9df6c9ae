"""Relative-position multi-head attention, conv FFN and the text encoder
stack, op by op (glow_tts_train_tpu ops/attention.py), on the JAX
param layout: 1x1 convs ``{"w": [1, c, c], "b"}``, rel-pos tables
``[heads_rel, 2w+1, d]``.

These are the plain paths: encoder configurations the CUDA encoder kernel
does not take (``window_size=None``, ``block_length`` set), through
:func:`attention_core` the attention of the encoder kernel's plain
version, and the op-by-op training encoder (``encoder_fuse: false``), with
the JAX package's dropout sites: attention probabilities, attention
output, FFN hidden and FFN output (the training prenet and duration
predictor are ``text_cuda``'s plain versions with :func:`dropout`).
Masks come from an explicit ``torch.Generator`` (JAX draws from
``jax.random``, a different stream).  :func:`encoder_apply` with
``fused=True`` is the training encoder through the kernels.  Masked scores are filled with -1e4,
not -inf: a fully masked (padded) query row then gets a uniform softmax
instead of NaN.
"""

import math
import typing

import torch
import torch.nn.functional as F

from .conv import conv1d
from .norms import layer_norm

Params = typing.Dict[str, typing.Any]


def dropout(
    x: torch.Tensor, p: float, generator: typing.Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout (torch semantics): keep with probability 1 - p and
    scale by 1 / (1 - p); identity when ``generator`` is None or p == 0.
    The keep mask is drawn on ``generator``'s device."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= p
    return x * keep.to(device=x.device, dtype=x.dtype) * (1.0 / (1.0 - p))


def get_relative_embeddings(
    rel_emb: torch.Tensor, length: int, window_size: int
) -> torch.Tensor:
    """Slice/zero-pad the ±window table [heads_rel, 2w+1, d] to 2*length-1
    positions."""
    pad_length = max(length - (window_size + 1), 0)
    slice_start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        rel_emb = F.pad(rel_emb, (0, 0, pad_length, pad_length))
    return rel_emb[:, slice_start : slice_start + 2 * length - 1]


def relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[b, h, l, 2l-1] -> [b, h, l, l]."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1 :]


def absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[b, h, l, l] -> [b, h, l, 2l-1]."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: torch.Tensor,
    n_heads: int,
    rel_k: typing.Optional[torch.Tensor] = None,
    rel_v: typing.Optional[torch.Tensor] = None,
    window_size: typing.Optional[int] = None,
    block_length: typing.Optional[int] = None,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
    drop_probs: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Self-attention of projected q, k, v [b, t, ch] -> [b, t, ch] (heads
    concatenated, before the output projection).  attn_mask [b, t, t],
    1 = attend.  rel_k/rel_v [heads_rel, 2w+1, d] when ``window_size`` is
    set.  Dropout on the attention probabilities [b, heads, t, t]: drawn
    from ``generator``, or ``drop_probs`` applied to them (the encoder
    kernel's per-head keep masks)."""
    b, t, ch = q.shape
    d = ch // n_heads

    def split_heads(u):
        return u.reshape(b, t, n_heads, d).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    if window_size is not None:
        rk = get_relative_embeddings(rel_k.to(q.dtype), t, window_size)
        # [1, m, d] shared across heads or [h, m, d] per head
        rel_logits = torch.einsum("bhld,hmd->bhlm", q, rk.expand(n_heads, -1, -1))
        scores = scores + relative_to_absolute(rel_logits) * scale
    fill = torch.tensor(-1e4, dtype=scores.dtype, device=scores.device)
    scores = torch.where(attn_mask[:, None] == 0, fill, scores)
    if block_length is not None:
        idx = torch.arange(t, device=q.device)
        band = (idx[:, None] - idx[None, :]).abs() <= block_length
        scores = torch.where(band[None, None], scores, fill)
    p_attn = dropout(torch.softmax(scores, dim=-1), p_dropout, generator)
    if drop_probs is not None:
        p_attn = drop_probs(p_attn)
    out = torch.einsum("bhts,bhsd->bhtd", p_attn, v)
    if window_size is not None:
        rv = get_relative_embeddings(rel_v.to(q.dtype), t, window_size)
        out = out + torch.einsum(
            "bhlm,hmd->bhld", absolute_to_relative(p_attn), rv.expand(n_heads, -1, -1)
        )
    return out.transpose(1, 2).reshape(b, t, ch)


def mha_apply(
    params: Params,
    x: torch.Tensor,
    attn_mask: torch.Tensor,
    n_heads: int,
    window_size: typing.Optional[int] = None,
    block_length: typing.Optional[int] = None,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Self-attention of x [b, t, ch] with its q/k/v/o projections."""
    out = attention_core(
        conv1d(x, params["q"]),
        conv1d(x, params["k"]),
        conv1d(x, params["v"]),
        attn_mask,
        n_heads,
        params.get("emb_rel_k"),
        params.get("emb_rel_v"),
        window_size,
        block_length,
        p_dropout,
        generator,
    )
    return conv1d(out, params["o"])


def ffn_apply(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    x = dropout(torch.relu(conv1d(x * x_mask, params["conv_1"])), p_dropout, generator)
    return conv1d(x * x_mask, params["conv_2"]) * x_mask


def encoder_layer_apply(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    n_heads: int,
    window_size: typing.Optional[int] = None,
    block_length: typing.Optional[int] = None,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One encoder layer: attention -> residual LN -> FFN -> residual LN."""
    m = x_mask[:, :, 0]
    attn_mask = m[:, None, :] * m[:, :, None]
    x = x * x_mask
    y = mha_apply(
        params["attn"], x, attn_mask, n_heads, window_size, block_length, p_dropout, generator
    )
    x = layer_norm(x + dropout(y, p_dropout, generator), params["norm_1"])
    y = ffn_apply(params["ffn"], x, x_mask, p_dropout, generator)
    return layer_norm(x + dropout(y, p_dropout, generator), params["norm_2"])


def draw_seed(seed_generator: typing.Optional[torch.Generator]) -> int:
    """One int32 dropout seed for a kernel from the CPU ``seed_generator``
    (JAX draws it from its rng, a different stream); 0 without one."""
    if seed_generator is None:
        return 0
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=seed_generator))


def encoder_apply(
    layers: typing.Sequence[Params],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    n_heads: int,
    window_size: typing.Optional[int] = None,
    block_length: typing.Optional[int] = None,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
    fused: bool = False,
    seed_generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The encoder stack over per-layer params; x: [b, t, c], x_mask
    [b, t, 1].

    ``fused``: each layer through the encoder kernel with its hand-written
    backward (``encoder_cuda.encoder_layer_train``): all layers folded
    once, Q/K/V merged into one [h, 3h] weight (reshapes and a
    concatenation, so autograd carries the kernels' folded gradients back
    to the raw params), dropout on when ``seed_generator`` (a CPU
    generator) is given, one seed per layer drawn from it.  Configurations
    the kernel does not take (``window_size=None``, ``block_length`` set)
    run op by op, as in the JAX package."""
    if fused and window_size is not None and block_length is None:
        from . import encoder_cuda

        folded = [
            encoder_cuda.merge_qkv(encoder_cuda.fold_encoder_layer(layer)) for layer in layers
        ]
        drop = seed_generator is not None and p_dropout > 0.0
        for weights in folded:
            x = encoder_cuda.encoder_layer_train(
                weights, x, x_mask, n_heads, window_size,
                p_dropout if drop else 0.0, draw_seed(seed_generator) if drop else 0,
            )
        return x * x_mask
    for layer in layers:
        x = encoder_layer_apply(
            layer, x, x_mask, n_heads, window_size, block_length, p_dropout, generator
        )
    return x * x_mask

"""Relative-position multi-head attention, conv FFN, the text encoder
stack, the prenet and the duration predictor, op by op
(glow_tts_train_tpu ops/attention.py and models/glow_tts.py), on the JAX
param layout: 1x1 convs ``{"w": [1, c, c], "b"}``, rel-pos tables
``[heads_rel, 2w+1, d]``, the prenet's layers stacked ``[n_layers, ...]``.

These are the op-by-op paths: encoder configurations the CUDA encoder
kernel does not take (``window_size=None``, ``block_length`` set), through
:func:`attention_core` the attention of the encoder kernel's plain
version, and the op-by-op training text side (``encoder_fuse: false``:
:func:`prenet_apply`, :func:`encoder_apply`,
:func:`duration_predictor_apply`), with the JAX package's dropout sites.
Each runs in its input's dtype as the JAX package's XLA path does: in
bf16 (``fp16_run``) every conv's output and bias bf16, LayerNorm in f32
rounded back, attention scores, softmax and the probabilities' products
accumulated in f32, the probabilities and the heads' output rounded to
bf16; the mask multiplies in that dtype (its values are 0 and 1).  Masks
come from an explicit ``torch.Generator`` (JAX draws from ``jax.random``,
a different stream).  :func:`encoder_apply` with ``fused=True`` is the
training encoder through the kernels.  Masked scores are filled with
-1e4, not -inf: a fully masked (padded) query row then gets a uniform
softmax instead of NaN.
"""

import math
import typing

import torch
import torch.nn.functional as F

from ..tree import tree_index
from .conv import conv1d
from .norms import layer_norm

Params = typing.Dict[str, typing.Any]


class RowsGenerator(torch.Generator):
    """A dropout generator for the rows ``first_row`` on of a batch of
    ``rows`` rows: it starts from ``source``'s state, its keep masks are
    those rows of the whole batch's (:func:`dropout` draws the whole
    shape and takes its rows) and the kernels' seeds are offset by
    ``first_row`` (:func:`draw_seed`; a kernel's sample i draws from seed
    + i).  So a rank of a data-parallel step, or a slice of an
    accumulated one, draws the masks that one process draws for those
    rows of the global batch."""

    def __new__(cls, source: torch.Generator, first_row: int, rows: int):
        return super().__new__(cls, device=source.device)

    def __init__(self, source: torch.Generator, first_row: int, rows: int):
        self.set_state(source.get_state())
        self.first_row, self.rows = int(first_row), int(rows)


def rows_of(
    generator: typing.Optional[torch.Generator], first_row: int, rows: int
) -> typing.Optional[RowsGenerator]:
    """:class:`RowsGenerator` of ``generator`` (None without one)."""
    return None if generator is None else RowsGenerator(generator, first_row, rows)


def dropout(
    x: torch.Tensor, p: float, generator: typing.Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout (torch semantics): keep with probability 1 - p and
    scale by 1 / (1 - p), the scale in x's dtype as JAX holds it;
    identity when ``generator`` is None or p == 0.  The keep mask is drawn
    on ``generator``'s device; a :class:`RowsGenerator` draws it for the
    whole batch and takes x's rows."""
    if generator is None or p == 0.0:
        return x
    rows = getattr(generator, "rows", None)
    shape = x.shape if rows is None else (rows, *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=generator.device) >= p
    if rows is not None:
        keep = keep[generator.first_row:generator.first_row + x.shape[0]]
    scale = torch.tensor(1.0 / (1.0 - p), dtype=x.dtype, device=x.device)
    return x * keep.to(device=x.device, dtype=x.dtype) * scale


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
    kernel's per-head keep masks).  In q's dtype: for bf16 the products
    take bf16 values and accumulate in f32, the softmax is f32 and its
    probabilities bf16 (JAX ``mha_apply``'s ``preferred_element_type``)."""
    b, t, ch = q.shape
    d = ch // n_heads
    cd = q.dtype

    def split_heads(u):
        return u.reshape(b, t, n_heads, d).transpose(1, 2).float()

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    if window_size is not None:
        rk = get_relative_embeddings(rel_k.to(cd).float(), t, window_size)
        # [1, m, d] shared across heads or [h, m, d] per head
        rel_logits = torch.einsum("bhld,hmd->bhlm", q, rk.expand(n_heads, -1, -1))
        scores = scores + relative_to_absolute(rel_logits) * scale
    fill = torch.tensor(-1e4, dtype=scores.dtype, device=scores.device)
    scores = torch.where(attn_mask[:, None] == 0, fill, scores)
    if block_length is not None:
        idx = torch.arange(t, device=q.device)
        band = (idx[:, None] - idx[None, :]).abs() <= block_length
        scores = torch.where(band[None, None], scores, fill)
    p_attn = dropout(torch.softmax(scores, dim=-1).to(cd), p_dropout, generator)
    if drop_probs is not None:
        p_attn = drop_probs(p_attn)
    out = torch.einsum("bhts,bhsd->bhtd", p_attn.float(), v)
    if window_size is not None:
        rv = get_relative_embeddings(rel_v.to(cd).float(), t, window_size)
        out = out + torch.einsum(
            "bhlm,hmd->bhld", absolute_to_relative(p_attn).float(), rv.expand(n_heads, -1, -1)
        )
    return out.to(cd).transpose(1, 2).reshape(b, t, ch)


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
    m = x_mask.to(x.dtype)
    x = dropout(torch.relu(conv1d(x * m, params["conv_1"])), p_dropout, generator)
    return conv1d(x * m, params["conv_2"]) * m


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
    x = x * x_mask.to(x.dtype)
    y = mha_apply(
        params["attn"], x, attn_mask, n_heads, window_size, block_length, p_dropout, generator
    )
    x = layer_norm(x + dropout(y, p_dropout, generator), params["norm_1"])
    y = ffn_apply(params["ffn"], x, x_mask, p_dropout, generator)
    return layer_norm(x + dropout(y, p_dropout, generator), params["norm_2"])


def draw_seed(seed_generator: typing.Optional[torch.Generator]) -> int:
    """One dropout seed for a kernel from the CPU ``seed_generator`` (JAX
    draws it from its rng, a different stream), below 2**31 and, from a
    :class:`RowsGenerator`, plus its first row mod 2**32 (the kernels take
    it as a uint32); 0 without one."""
    if seed_generator is None:
        return 0
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=seed_generator))
    return (seed + getattr(seed_generator, "first_row", 0)) % 2 ** 32


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
    the kernel does not take (``encoder_cuda.kernel_takes``:
    ``window_size=None``, ``block_length`` set, a head width over 128 or
    not a multiple of 8, a window over 16) run op by op, as in the JAX
    package."""
    from . import encoder_cuda

    if fused and encoder_cuda.kernel_takes(x.shape[-1], n_heads, window_size, block_length):
        folded = [
            encoder_cuda.merge_qkv(encoder_cuda.fold_encoder_layer(layer, x.dtype))
            for layer in layers
        ]
        drop = seed_generator is not None and p_dropout > 0.0
        for weights in folded:
            x = encoder_cuda.encoder_layer_train(
                weights, x, x_mask, n_heads, window_size,
                p_dropout if drop else 0.0, draw_seed(seed_generator) if drop else 0,
            )
        return (x * x_mask).to(x.dtype)
    for layer in layers:
        x = encoder_layer_apply(
            layer, x, x_mask, n_heads, window_size, block_length, p_dropout, generator
        )
    return x * x_mask.to(x.dtype)


def prenet_apply(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.5,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The ConvReluNorm prenet op by op (JAX ``prenet_apply``): per layer
    conv -> LayerNorm -> ReLU -> dropout, then x plus the projection of
    the last layer's output, masked.  ``params``: ``{"layers": {"conv",
    "norm"} stacked [n_layers, ...], "proj"}``."""
    m = x_mask.to(x.dtype)
    layers = params["layers"]
    cur = x
    for i in range(layers["conv"]["w"].shape[0]):
        layer = tree_index(layers, i)
        cur = layer_norm(conv1d(cur * m, layer["conv"]), layer["norm"])
        cur = dropout(torch.relu(cur), p_dropout, generator)
    return (x + conv1d(cur, params["proj"])) * m


def duration_predictor_apply(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The duration predictor op by op (JAX ``duration_predictor_apply``):
    x [b, t, c] -> log-durations [b, t, 1]; per layer conv -> ReLU ->
    LayerNorm -> dropout (the norm after the ReLU, unlike the prenet),
    then the 1x1 projection, masked."""
    m = x_mask.to(x.dtype)
    for conv, norm in (("conv_1", "norm_1"), ("conv_2", "norm_2")):
        x = layer_norm(torch.relu(conv1d(x * m, params[conv])), params[norm])
        x = dropout(x, p_dropout, generator)
    return conv1d(x * m, params["proj"]) * m

"""Glow-TTS graph (glow_tts_train_tpu models/glow_tts.py): text encoder,
duration predictor and flow decoder, for generation and for training.

:class:`GlowTTS` holds one parameter per leaf of the JAX param tree,
named by its path (``encoder.attn.q.w`` is the JAX ``encoder/attn/q/w``,
stacked ``[n_layers, ...]``/``[n_blocks, ...]`` as there).
:func:`store_inverse` folds everything the serving path needs once, at
load — the flow blocks' inverses and weight norms included — into
:class:`ServingWeights`; :func:`forward_gen` runs on those.
:func:`forward_train` is the training graph on the raw param tree:
the text side through its kernels (``encoder_fuse`` true: prenet, encoder
layers and duration stack, each a ``torch.autograd.Function`` over its
forward and backward kernel) or op by op (``encoder_fuse: false``), the
flow decoder through the fused block kernels (``block_fuse``) or op by op
around the WN stack's kernels, either with stored or recomputed residuals
(``wn_residuals``), the f32 pairwise log-likelihood, MAS, and the
expansion of the text statistics to frames.

Device rule, in place of the JAX package's TPU resolvers: each kernel
wrapper (``ops/*_cuda.py``) launches its CUDA kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors.  Encoder configurations
the kernel does not take (``window_size=None`` or ``block_length`` set)
run their encoder layers op by op on either device, in training and in
serving, as in the JAX package.
"""

import dataclasses
import json
import math
import typing

import torch
from torch import nn

from ..ops import attention, encoder_cuda, flows, mas_cuda, text_cuda
from ..ops.conv import conv1d
from ..ops.masks import generate_path, time_mask
from ..tree import tree_index, tree_map, unflatten

Params = typing.Dict[str, typing.Any]


class GlowTTSHyper(typing.NamedTuple):
    """Model hyperparameters (the JAX GlowTTSHyper's model fields)."""

    n_vocab: int
    hidden_channels: int
    filter_channels: int
    filter_channels_dp: int
    out_channels: int
    kernel_size: int = 3
    n_heads: int = 2
    n_layers_enc: int = 6
    p_dropout: float = 0.0
    n_blocks_dec: int = 12
    kernel_size_dec: int = 5
    dilation_rate: int = 1
    n_block_layers: int = 4
    p_dropout_dec: float = 0.05
    n_speakers: int = 0
    gin_channels: int = 0
    n_split: int = 4
    n_sqz: int = 2
    sigmoid_scale: bool = False
    window_size: typing.Optional[int] = 4
    block_length: typing.Optional[int] = None
    mean_only: bool = False
    hidden_channels_enc: typing.Optional[int] = None
    hidden_channels_dec: typing.Optional[int] = None
    prenet: bool = False
    # backward of the block / WN kernels: "store" or "recompute"
    wn_residuals: str = "store"
    # each training-forward flow block as one kernel pair (True), or op by
    # op around the WN stack's kernels (False)
    block_fuse: bool = True
    # training text side: through its kernels (True) or op by op (False)
    encoder_fuse: bool = False

    @property
    def h_enc(self) -> int:
        return self.hidden_channels_enc or self.hidden_channels

    @property
    def h_dec(self) -> int:
        return self.hidden_channels_dec or self.hidden_channels

    @property
    def encoder_kernel_fits(self) -> bool:
        """The CUDA encoder kernel takes this configuration
        (``encoder_cuda.kernel_takes``: a rel-pos window of at most 16, no
        block_length, a head width that is a multiple of 8 and at most
        128)."""
        return encoder_cuda.kernel_takes(
            self.h_enc, self.n_heads, self.window_size, self.block_length
        )


def _resolve(value, auto, choices: tuple, key: str):
    """An "auto" config value -> ``auto``; any other must be one of
    ``choices`` (bools are spelled as JSON spells them)."""
    if value == "auto":
        return auto
    if value not in choices or (isinstance(value, bool) != isinstance(choices[0], bool)):
        raise ValueError(
            f"{key}: expected \"auto\" or {' or '.join(json.dumps(c) for c in choices)}; "
            f"got {json.dumps(value)}"
        )
    return value


def hyper_from_config(config) -> GlowTTSHyper:
    """TrainingConfig -> GlowTTSHyper.  An explicit value wins; "auto"
    resolves as the JAX package resolves it on its accelerator, with the
    CUDA kernels in place of the TPU's:

    * ``flow_block_fuse`` -> true;
    * ``wn_residuals`` -> "store": the port always unrolls its blocks, the
      case in which JAX resolves to store (``_resolve_wn_residuals``);
    * ``encoder_fuse`` -> whether the encoder kernel takes the
      configuration (JAX ``_resolve_encoder_fuse``, by the port's kernel's
      own limits: ``GlowTTSHyper.encoder_kernel_fits``).

    ``wn_impl`` and ``flow_block_fuse_reverse`` pick nothing here: the WN
    stack runs through the port's kernels ("pallas"; their plain versions
    serve CPU tensors only) and each inverse block is one kernel (true).
    "auto" and that value are accepted, "xla" and false refused.

    A value outside the key's choices raises ``ValueError``."""
    m = config.model
    encoder_fuse = getattr(config, "encoder_fuse", "auto")
    flags = (True, False)
    _resolve(getattr(config, "wn_impl", "auto"), "pallas", ("pallas",), "wn_impl")
    _resolve(
        getattr(config, "flow_block_fuse_reverse", "auto"), True, (True,), "flow_block_fuse_reverse"
    )
    hp = GlowTTSHyper(
        n_vocab=m.num_symbols,
        hidden_channels=m.hidden_channels,
        filter_channels=m.filter_channels,
        filter_channels_dp=m.filter_channels_dp,
        out_channels=config.audio.mel_channels,
        kernel_size=m.kernel_size,
        n_heads=m.n_heads,
        n_layers_enc=m.n_layers_enc,
        p_dropout=m.p_dropout,
        n_blocks_dec=m.n_blocks_dec,
        kernel_size_dec=m.kernel_size_dec,
        dilation_rate=m.dilation_rate,
        n_block_layers=m.n_block_layers,
        p_dropout_dec=m.p_dropout_dec,
        n_speakers=m.n_speakers,
        gin_channels=m.gin_channels,
        n_split=m.n_split,
        n_sqz=m.n_sqz,
        sigmoid_scale=m.sigmoid_scale,
        window_size=m.window_size,
        block_length=m.block_length,
        mean_only=m.mean_only,
        hidden_channels_enc=m.hidden_channels_enc,
        hidden_channels_dec=m.hidden_channels_dec,
        prenet=m.prenet,
        wn_residuals=_resolve(
            getattr(config, "wn_residuals", "auto"), "store", ("store", "recompute"), "wn_residuals"
        ),
        block_fuse=_resolve(getattr(config, "flow_block_fuse", "auto"), True, flags, "flow_block_fuse"),
    )
    fuse = hp.encoder_kernel_fits if encoder_fuse == "auto" else bool(encoder_fuse)
    return hp._replace(encoder_fuse=fuse)


class _Node(nn.Module):
    """An inner node of the parameter tree."""


class GlowTTS(nn.Module):
    """Parameters named by their JAX tree paths; ``shapes`` maps
    ``"a/b/c"`` paths to shapes (``checkpoint.param_shapes`` without the
    ``model/`` prefix).  Values are uninitialized until loaded;
    ``requires_grad`` makes them trainable."""

    def __init__(
        self, shapes: typing.Mapping[str, typing.Sequence[int]], requires_grad: bool = False
    ):
        super().__init__()
        for path, shape in shapes.items():
            *parents, leaf = path.split("/")
            node: nn.Module = self
            for name in parents:
                if not hasattr(node, name):
                    node.add_module(name, _Node())
                node = getattr(node, name)
            node.register_parameter(
                leaf, nn.Parameter(torch.empty(tuple(shape)), requires_grad=requires_grad)
            )

    def flat(self) -> typing.Dict[str, nn.Parameter]:
        """{"a/b/c": parameter} in registration order."""
        return {name.replace(".", "/"): p for name, p in self.named_parameters()}

    def tree(self, detach: bool = True) -> Params:
        """The parameters as the JAX package's nested dict (the parameters
        themselves with ``detach=False``, for autograd)."""
        return unflatten({k: p.detach() if detach else p for k, p in self.flat().items()})


@dataclasses.dataclass
class ServingWeights:
    """Everything :func:`forward_gen` reads, folded once by
    :func:`store_inverse`."""

    emb: torch.Tensor
    prenet: typing.Optional[tuple]  # text_cuda.prenet_weights
    # per layer: encoder_cuda.merge_qkv's tuple (the kernels' layout) when the encoder
    # kernel takes the config, else the raw layer params (op-by-op path)
    encoder: typing.List[typing.Any]
    proj_m: Params
    proj_s: typing.Optional[Params]
    dp: tuple  # text_cuda.dp_weights
    dp_proj: Params
    emb_g: typing.Optional[torch.Tensor]
    blocks: typing.List[dict]  # fold_block_params_inverse + split_inverse_weights
    cond: typing.Optional[typing.List[Params]]  # per-block effective cond conv

    def to(self, device) -> "ServingWeights":
        return ServingWeights(
            **{
                f.name: tree_map(lambda a: a.to(device), getattr(self, f.name))
                for f in dataclasses.fields(self)
            }
        )


def store_inverse(model: GlowTTS, hp: GlowTTSHyper) -> ServingWeights:
    """Fold all serving weights once (the JAX package folds per call inside
    its jitted graph): block inverses, weight norms, kernel layouts."""
    p = tree_map(lambda a: a.to(torch.float32), model.tree())
    layers = [tree_index(p["encoder"], i) for i in range(hp.n_layers_enc)]
    if hp.encoder_kernel_fits:
        layers = [
            encoder_cuda.merge_qkv(encoder_cuda.fold_encoder_layer(layer)) for layer in layers
        ]
    blocks, cond = flows.decoder_store_inverse(
        p["decoder"]["blocks"], hp.n_block_layers, hp.n_split
    )
    return ServingWeights(
        emb=p["emb"],
        prenet=text_cuda.prenet_weights(p["prenet"]) if hp.prenet else None,
        encoder=layers,
        proj_m=p["proj_m"],
        proj_s=None if hp.mean_only else p["proj_s"],
        dp=text_cuda.dp_weights(p["proj_w"]),
        dp_proj=p["proj_w"]["proj"],
        emb_g=p.get("emb_g"),
        blocks=blocks,
        cond=cond,
    )


def _speaker_vector(
    emb_g: typing.Optional[torch.Tensor], g_ids: typing.Optional[torch.Tensor]
) -> typing.Optional[torch.Tensor]:
    """L2-normalized speaker embedding [b] -> [b, 1, gin]."""
    if g_ids is None:
        return None
    g = emb_g[g_ids]
    norm = torch.sqrt(torch.sum(torch.square(g), dim=-1, keepdim=True))
    return (g / torch.clamp(norm, min=1e-12))[:, None, :]


def duration_predictor_apply(
    w: ServingWeights, x: torch.Tensor, x_mask: torch.Tensor
) -> torch.Tensor:
    """x: [b, t, c] -> log-durations [b, t, 1]."""
    return text_cuda.duration_predictor(w.dp, w.dp_proj, x, x_mask)


def encoder_forward(
    w: ServingWeights,
    hp: GlowTTSHyper,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
):
    """x: [b, t_x] phoneme ids; g: optional [b, 1, gin] speaker vector.
    Returns (x_m, x_logs, logw, x_mask), channels-last."""
    t_x = x.shape[1]
    xh = w.emb[x] * math.sqrt(hp.h_enc)
    x_mask = time_mask(x_lengths, t_x)
    if hp.prenet:
        xh = text_cuda.prenet(w.prenet, xh, x_mask)
    if hp.encoder_kernel_fits:
        for layer in w.encoder:
            xh = encoder_cuda.encoder_layer(
                layer, xh, x_mask, hp.n_heads, hp.window_size
            )
        xh = xh * x_mask
    else:  # the JAX package's op-by-op encoder, on either device
        xh = attention.encoder_apply(
            w.encoder, xh, x_mask, hp.n_heads, hp.window_size, hp.block_length
        )
    x_dp = xh
    if g is not None:
        x_dp = torch.cat([xh, g.expand(-1, t_x, -1)], dim=-1)
    x_m = conv1d(xh, w.proj_m) * x_mask
    x_logs = torch.zeros_like(x_m) if hp.mean_only else conv1d(xh, w.proj_s) * x_mask
    logw = duration_predictor_apply(w, x_dp, x_mask)
    return x_m, x_logs, logw, x_mask


def forward_gen(
    w: ServingWeights,
    hp: GlowTTSHyper,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    y_max_length: int,
    noise_scale: float = 1.0,
    length_scale: float = 1.0,
    g_ids: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    eps: typing.Optional[torch.Tensor] = None,
    encoder_out: typing.Optional[tuple] = None,
):
    """Generation into a ``y_max_length`` frame budget, as the JAX
    ``forward_gen``.  The noise is ``eps`` when given (shape of z_m), else
    drawn from ``generator``.  ``encoder_out``: a precomputed
    :func:`encoder_forward` result, so callers that sized the budget with
    it do not run the encoder twice.

    Returns ((y, z_m, z_logs, z_mask), (x_m, x_logs, x_mask),
    (attn, logw, logw_), y_lengths)."""
    g = _speaker_vector(w.emb_g, g_ids)
    if encoder_out is None:
        encoder_out = encoder_forward(w, hp, x, x_lengths, g=g)
    x_m, x_logs, logw, x_mask = encoder_out

    dur = torch.exp(logw.to(torch.float32)) * x_mask * length_scale
    w_ceil = torch.ceil(dur)
    y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int32)
    y_lengths = torch.clamp(y_lengths, max=y_max_length)
    t_y = (y_max_length // hp.n_sqz) * hp.n_sqz
    y_lengths = (y_lengths // hp.n_sqz) * hp.n_sqz

    z_mask = time_mask(y_lengths, t_y)
    attn_mask = x_mask[:, :, 0][:, :, None] * z_mask[:, :, 0][:, None, :]
    attn = generate_path(w_ceil[:, :, 0], attn_mask)
    z_m = torch.einsum("bxy,bxd->byd", attn, x_m)
    z_logs = torch.einsum("bxy,bxd->byd", attn, x_logs)
    logw_ = torch.log(1e-8 + torch.sum(attn, dim=2))[:, :, None] * x_mask

    if eps is None:
        eps = torch.randn(
            z_m.shape, generator=generator, device=z_m.device, dtype=z_m.dtype
        )
    z = (z_m + torch.exp(z_logs) * eps * noise_scale) * z_mask
    g_all = None
    if w.cond is not None and g is not None:
        L, h = hp.n_block_layers, hp.h_dec
        g_all = [conv1d(g, c).reshape(g.shape[0], L, 2 * h).contiguous() for c in w.cond]
    y = flows.decoder_inv(
        w.blocks, z, z_mask,
        kernel_size=hp.kernel_size_dec, dilation_rate=hp.dilation_rate,
        n_sqz=hp.n_sqz, sigmoid_scale=hp.sigmoid_scale, g_all=g_all,
    )
    return (
        (y, z_m, z_logs, z_mask),
        (x_m, x_logs, x_mask),
        (attn, logw, logw_),
        y_lengths,
    )


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(hp: GlowTTSHyper, generator: torch.Generator) -> typing.Dict[str, torch.Tensor]:
    """Fresh params, {"a/b/c": tensor} with the keys and shapes of
    ``checkpoint.param_shapes`` (without ``model/``), initialised as the
    JAX ``init_model`` does: torch conv init U(+-1/sqrt(fan_in)), Xavier
    for the q/k/v projections, weight norm with g = ||v||, zero coupling
    ``end`` and prenet ``proj``, zero actnorm, orthogonal invconv with a
    positive determinant, N(0, h^-0.5) embeddings, U(-0.1, 0.1) speakers.
    Values differ from JAX's (another generator); the distributions do
    not."""
    from ..checkpoint import PREFIX, param_shapes

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    out: typing.Dict[str, torch.Tensor] = {}
    for key, shape in param_shapes(hp).items():
        key = key[len(PREFIX):]
        group, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
        weight = out.get(f"{group}/w", out.get(f"{group}/v"))
        if group.endswith(("coupling/end", "prenet/proj")) or "/actnorm/" in f"/{key}":
            a = torch.zeros(shape)
        elif key == "emb":
            a = torch.randn(shape, generator=generator) * hp.h_enc ** -0.5
        elif "emb_rel" in key:
            a = torch.randn(shape, generator=generator) * shape[-1] ** -0.5
        elif key == "emb_g":
            a = uniform(shape, 0.1)
        elif key.endswith("invconv/weight"):
            mats = []
            for _ in range(shape[0]):
                q = torch.linalg.qr(torch.randn(shape[1:], generator=generator))[0]
                if torch.linalg.det(q) < 0:
                    q[:, 0] = -q[:, 0]
                mats.append(q)
            a = torch.stack(mats)
        elif leaf == "gamma":
            a = torch.ones(shape)
        elif leaf == "beta":
            a = torch.zeros(shape)
        elif leaf == "g":  # weight norm: g = ||v|| over (k, c_in)
            a = torch.sqrt(torch.sum(weight * weight, dim=(-3, -2)))
        elif leaf == "b":
            a = uniform(shape, (weight.shape[-3] * weight.shape[-2]) ** -0.5)
        elif group.split("/")[-1] in ("q", "k", "v") and group.startswith("encoder/attn"):
            k, c_in, c_out = shape[-3:]
            a = uniform(shape, math.sqrt(6.0 / (c_in * k + c_out * k)))
        else:  # conv weights w / v
            a = uniform(shape, (shape[-3] * shape[-2]) ** -0.5)
        out[key] = a.to(torch.float32)
    return out


def encoder_forward_train(
    params: Params,
    hp: GlowTTSHyper,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    seed_generator: typing.Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """The text side on the raw param tree: prenet, encoder, projections,
    and the duration predictor on the detached encoder output (plus the
    speaker vector).  With ``hp.encoder_fuse`` each stack runs its kernel
    pair (``PrenetTrain``, ``EncoderLayerTrain``, ``DurationStackTrain``;
    their plain versions on CPU tensors; the encoder layers op by op where
    the encoder kernel does not take the configuration, as in JAX) and
    dropout is on when ``seed_generator`` (CPU) is given, one seed per
    stack and layer drawn from it; otherwise each stack op by op
    (``attention.prenet_apply``, ``encoder_apply``,
    ``duration_predictor_apply``) with masks drawn from ``generator``.
    ``compute_dtype`` bf16 (JAX ``encoder_forward``'s compute_dtype): the
    embedding, the stacks' activations and their product weights in bf16,
    rounded as the kernels round them or, op by op, as XLA does; the mask
    f32 (its values are 0 and 1, so a masked bf16 value is the same bf16
    value).  Returns (x_m, x_logs, logw, x_mask)."""
    t_x = x.shape[1]
    cd = compute_dtype
    if cd == torch.float32:
        xh = params["emb"][x] * math.sqrt(hp.h_enc)
    else:  # JAX: a Python scalar times a bf16 array is a bf16 product
        xh = params["emb"].to(cd)[x] * torch.tensor(math.sqrt(hp.h_enc), dtype=cd)
    x_mask = time_mask(x_lengths, t_x).contiguous()
    fused = hp.encoder_fuse
    drop = seed_generator is not None

    def masked(a):
        return (a * x_mask).to(a.dtype)

    def rate_and_seed(p):
        on = drop and p > 0.0
        return (p, attention.draw_seed(seed_generator)) if on else (0.0, 0)

    if hp.prenet:
        if fused:
            pw = text_cuda.prenet_weights(params["prenet"], cd)
            xh = text_cuda.prenet_train(pw, xh.contiguous(), x_mask, *rate_and_seed(0.5))
        else:
            xh = attention.prenet_apply(params["prenet"], xh, x_mask, 0.5, generator)
    layers = [tree_index(params["encoder"], i) for i in range(hp.n_layers_enc)]
    xh = attention.encoder_apply(
        layers, xh.contiguous(), x_mask, hp.n_heads, hp.window_size, hp.block_length,
        hp.p_dropout, generator, fused=fused, seed_generator=seed_generator,
    )
    x_dp = xh.detach()
    if g is not None:
        x_dp = torch.cat([x_dp, g.expand(-1, t_x, -1).to(cd)], dim=-1)
    x_m = masked(conv1d(xh, params["proj_m"]))
    x_logs = torch.zeros_like(x_m) if hp.mean_only else masked(conv1d(xh, params["proj_s"]))
    if fused:
        dw = text_cuda.dp_weights(params["proj_w"], cd)
        dp = text_cuda.duration_stack_train(
            dw, x_dp.contiguous(), x_mask, *rate_and_seed(hp.p_dropout)
        )
        logw = masked(conv1d(masked(dp), params["proj_w"]["proj"]))
    else:
        logw = attention.duration_predictor_apply(
            params["proj_w"], x_dp, x_mask, hp.p_dropout, generator
        )
    return x_m, x_logs, logw, x_mask


def _decoder_kwargs(hp: GlowTTSHyper) -> dict:
    return dict(
        hidden_channels=hp.h_dec, kernel_size=hp.kernel_size_dec,
        dilation_rate=hp.dilation_rate, n_layers=hp.n_block_layers,
        n_sqz=hp.n_sqz, sigmoid_scale=hp.sigmoid_scale,
    )


def forward_train(
    params: Params,
    hp: GlowTTSHyper,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    y: torch.Tensor,
    y_lengths: torch.Tensor,
    g_ids: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    seed_generator: typing.Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """Training graph (JAX ``forward_train``): encoder -> flow forward ->
    f32 pairwise log-likelihood -> MAS (no gradient) -> expansion.  x [b,
    t_x] ids, y [b, t_y, n_mel].  Dropout is on when generators are given:
    ``generator`` (on x's device) draws the encoder's masks,
    ``seed_generator`` (CPU) the flow blocks' seeds.  ``compute_dtype``
    bf16: the text side, the mels and the flow blocks in bf16 (JAX casts
    y, z_m and z_logs to it), logdet, logp and MAS in f32.

    Returns ((z, z_m, z_logs, logdet, z_mask), (x_m, x_logs, x_mask),
    (attn, logw, logw_))."""
    g = _speaker_vector(params.get("emb_g"), g_ids)
    x_m, x_logs, logw, x_mask = encoder_forward_train(
        params, hp, x, x_lengths, g, generator, seed_generator, compute_dtype
    )

    t_y = (y.shape[1] // hp.n_sqz) * hp.n_sqz
    y = y[:, :t_y].to(compute_dtype)
    y_lengths = (y_lengths // hp.n_sqz) * hp.n_sqz
    z_mask = time_mask(y_lengths, t_y)
    attn_mask = x_mask[:, :, 0][:, :, None] * z_mask[:, :, 0][:, None, :]
    z, logdet = flows.decoder_fwd(
        params["decoder"]["blocks"], y, z_mask, n_split=hp.n_split, g=g,
        p_dropout=hp.p_dropout_dec, seed_generator=seed_generator,
        block_fuse=hp.block_fuse, wn_residuals=hp.wn_residuals,
        **_decoder_kwargs(hp),
    )

    with torch.no_grad():  # the path carries no gradient (JAX stop_gradient)
        x_m32, x_logs32, z32 = x_m.float(), x_logs.float(), z.float()
        x_s_sq_r = torch.exp(-2.0 * x_logs32)
        logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - x_logs32, dim=-1)[:, :, None]
        logp2 = torch.einsum("bxd,byd->bxy", x_s_sq_r, -0.5 * torch.square(z32))
        logp3 = torch.einsum("bxd,byd->bxy", x_m32 * x_s_sq_r, z32)
        logp4 = torch.sum(-0.5 * torch.square(x_m32) * x_s_sq_r, dim=-1)[:, :, None]
        logp = logp1 + logp2 + logp3 + logp4
        attn = mas_cuda.maximum_path(logp.contiguous(), attn_mask.contiguous())

    z_m = torch.einsum("bxy,bxd->byd", attn, x_m.float()).to(compute_dtype)
    z_logs = torch.einsum("bxy,bxd->byd", attn, x_logs.float()).to(compute_dtype)
    attn_c = attn.to(compute_dtype)  # JAX: the path in the compute dtype
    logw_ = (torch.log(1e-8 + torch.sum(attn_c, dim=2))[:, :, None] * x_mask).to(compute_dtype)
    return (z, z_m, z_logs, logdet, z_mask), (x_m, x_logs, x_mask), (attn, logw, logw_)


@torch.no_grad()
def ddi_init(
    params: Params,
    hp: GlowTTSHyper,
    y: torch.Tensor,
    y_lengths: torch.Tensor,
    g_ids: typing.Optional[torch.Tensor] = None,
    reduce: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Params:
    """Data-dependent ActNorm init from one batch's mels (JAX ``ddi_init``;
    deterministic, no dropout) -> the decoder's new actnorm
    {"logs", "bias"} [n_blocks, c].  ``reduce``: each block's [3, c]
    masked sums -> the global batch's (``flows.decoder_ddi``)."""
    g = _speaker_vector(params.get("emb_g"), g_ids)
    t_y = (y.shape[1] // hp.n_sqz) * hp.n_sqz
    y = y[:, :t_y].to(torch.float32)
    y_lengths = (y_lengths // hp.n_sqz) * hp.n_sqz
    z_mask = time_mask(y_lengths, t_y)
    return flows.decoder_ddi(
        params["decoder"]["blocks"], y, z_mask, g=g, reduce=reduce, **_decoder_kwargs(hp)
    )

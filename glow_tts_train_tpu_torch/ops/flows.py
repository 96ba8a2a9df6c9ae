"""The flow decoder (glow_tts_train_tpu ops/flows.py), channels-last
[b, t, c].

:func:`decoder_inv` is the serving path: squeeze, then the blocks in
reverse order through :func:`block_cuda.block_inverse` (the CUDA kernel for
CUDA tensors, its plain version for CPU tensors), then unsqueeze.  Each
block's bijectors (coupling, InvConvNear and ActNorm inverses) run in the
folded form of :func:`block_cuda.fold_block_params_inverse`.

:func:`decoder_fwd` is the training direction.  Fused (``block_fuse``):
the blocks folded once per step (:func:`block_cuda.fold_blocks_stacked`),
then each block through :func:`block_cuda.block_forward`, with the actnorm
and invconv logdets (weights and lengths only) kept outside, as JAX's
``decoder_fwd`` does.  Op by op (``flow_block_fuse: false``): ActNorm,
InvConvNear and the coupling under autograd, the coupling's WN stack
through :func:`wn_cuda.wn_stack_train` (the WN kernels for CUDA tensors).
``wn_residuals`` picks the backward of either form's kernels: "store" or
"recompute".  x bf16 (``fp16_run``) runs either form in bf16, as JAX's
decoder does: the fused blocks' bf16 kernels, or the bijectors in bf16
(products and elementwise math rounding as XLA's bf16 ops do, logdets in
f32) around the WN stack's bf16 kernels; the mask stays f32, and a masked
bf16 value is cast back to bf16 (its values are those of the bf16 mask's
product).
:func:`decoder_ddi` is data-dependent actnorm init: the forward bijectors
op by op, the WN stack through :func:`wn_cuda.wn_stack`.
"""

import typing

import torch

from . import block_cuda, wn_cuda
from .attention import draw_seed
from .conv import conv1d, weight_norm_effective
from ..tree import tree_index

Params = typing.Dict[str, typing.Any]


def squeeze(
    x: torch.Tensor, x_mask: torch.Tensor, n_sqz: int = 2
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Fold time into channels: [b, t, c] -> [b, t//n, c*n]; the mask is
    subsampled at stride n from n-1."""
    b, t, c = x.shape
    t_trunc = (t // n_sqz) * n_sqz
    x_sqz = x[:, :t_trunc].reshape(b, t_trunc // n_sqz, n_sqz * c)
    x_mask = x_mask[:, n_sqz - 1 :: n_sqz]
    return (x_sqz * x_mask).to(x.dtype), x_mask


def unsqueeze(
    x: torch.Tensor, x_mask: torch.Tensor, n_sqz: int = 2
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of squeeze: [b, t, C] -> [b, t*n, C//n]."""
    b, t, c = x.shape
    x_unsqz = x.reshape(b, t * n_sqz, c // n_sqz)
    x_mask = torch.repeat_interleave(x_mask, n_sqz, dim=1)
    return (x_unsqz * x_mask).to(x.dtype), x_mask


def decoder_store_inverse(blocks: Params, n_layers: int, n_split: int):
    """Stacked block params -> (per-block inverse folds, per-block
    effective speaker-conditioning convs or None), all folded once here:
    the s x s inverses, weight norm, the actnorm/invconv affine, and the
    products' weight splits of the serving kernel."""
    n_blocks = blocks["actnorm"]["logs"].shape[0]
    folded, cond = [], []
    for i in range(n_blocks):
        bp = tree_index(blocks, i)
        folded.append(block_cuda.split_inverse_weights(
            block_cuda.fold_block_params_inverse(bp, n_layers, n_split)))
        if "cond" in bp["coupling"]["wn"]:
            c = bp["coupling"]["wn"]["cond"]
            cond.append(
                {"w": weight_norm_effective(c).contiguous(), "b": c["b"].to(torch.float32)}
            )
    return folded, (cond or None)


def decoder_inv(
    blocks: typing.Sequence[dict],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    kernel_size: int,
    dilation_rate: int,
    n_sqz: int,
    sigmoid_scale: bool = False,
    g_all: typing.Optional[typing.Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """z -> mel: the inverse blocks in reverse order on ``decoder_store_inverse``
    folds.  g_all: per-block [b, L, 2h] conditioning, or None."""
    x, x_mask = squeeze(x, x_mask, n_sqz)
    x_mask = x_mask.contiguous()
    for i in reversed(range(len(blocks))):
        x = block_cuda.block_inverse(
            blocks[i], None if g_all is None else g_all[i], x, x_mask,
            kernel_size, dilation_rate, sigmoid_scale,
        )
    x, _ = unsqueeze(x, x_mask, n_sqz)
    return x


def _masked(a: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
    """a * mask in a's dtype (the f32 mask would promote a bf16 a)."""
    return (a * x_mask).to(a.dtype)


def actnorm_fwd(params: Params, x: torch.Tensor, x_mask: torch.Tensor):
    """z = (bias + exp(logs) * x) * mask, logs and bias in x's dtype;
    logdet = sum(logs) * frames in f32."""
    logs, bias = params["logs"].to(x.dtype), params["bias"].to(x.dtype)
    z = _masked(bias + torch.exp(logs) * x, x_mask)
    x_len = torch.sum(x_mask.to(torch.float32), dim=(1, 2))
    return z, torch.sum(params["logs"].to(torch.float32)) * x_len


def actnorm_ddi_stats(
    x: torch.Tensor,
    x_mask: torch.Tensor,
    reduce: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Params:
    """ActNorm bias/logs from the masked batch statistics of x, so that the
    output is about N(0, 1) per channel.  The masked sums Σx·m, Σx²·m and
    Σm go through ``reduce`` as one [3, c] tensor (the sum over ranks, for
    the statistics of the global batch) before they divide."""
    xf = x.to(torch.float32)
    mf = x_mask.to(torch.float32)
    sums = torch.stack([
        torch.sum(xf * mf, dim=(0, 1)),
        torch.sum(xf * xf * mf, dim=(0, 1)),
        torch.sum(mf, dim=(0, 1)).expand(xf.shape[-1]),
    ])
    if reduce is not None:
        sums = reduce(sums)
    m = sums[0] / sums[2]
    m_sq = sums[1] / sums[2]
    logs = 0.5 * torch.log(torch.clamp(m_sq - m ** 2, min=1e-6))
    return {"bias": -m * torch.exp(-logs), "logs": -logs}


def invconv_apply(params: Params, x: torch.Tensor, x_mask: torch.Tensor):
    """InvConvNear: the s x s group mix as its dense [c, c] map (in x's
    dtype, the product a plain matmul); logdet = log|det W| * (c / s) *
    frames."""
    c = x.shape[-1]
    w = params["weight"].to(torch.float32)
    s = w.shape[0]
    x_len = torch.sum(x_mask.to(torch.float32), dim=(1, 2))
    logdet = torch.linalg.slogdet(w)[1] * (c / s) * x_len
    m = block_cuda.invconv_dense(w, c, s).to(x.dtype)
    return _masked(x @ m.T, x_mask), logdet


def coupling_apply(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor],
    hidden_channels: int,
    kernel_size: int,
    dilation_rate: int,
    n_layers: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
    wn_residuals: str = "store",
):
    """Affine coupling, identity on the first half: start 1x1 of x0, the WN
    stack, end 1x1 -> (m, logs); z1 = (m + e^logs * x1) * mask with logdet
    = sum(logs * mask) in f32.  The stack runs through
    :func:`wn_cuda.wn_stack_train` (the WN kernels on CUDA tensors,
    backward per ``wn_residuals``) and drops its pre-gate tensors with the
    portable keep masks of ``seed`` when ``p_dropout`` > 0.  x bf16: the
    convs, the conditioning and the stack's weights in bf16."""
    c2 = x.shape[-1] // 2
    x0, x1 = x[..., :c2], x[..., c2:]
    hidden = _masked(conv1d(x0, params["start"]), x_mask).contiguous()
    wn = params["wn"]
    g_all = None
    if g is not None:
        g_all = conv1d(g, wn["cond"]).reshape(g.shape[0], n_layers, 2 * hidden_channels)
        g_all = g_all.to(x.dtype).contiguous()
    skip = wn_cuda.wn_stack_train(
        wn_cuda.fold_wn_weights(wn, n_layers, x.dtype), g_all, hidden, x_mask, kernel_size,
        dilation_rate, p_dropout, seed, wn_residuals,
    )
    out = conv1d(_masked(skip, x_mask), params["end"])
    m, logs = out[..., :c2], out[..., c2:]
    if sigmoid_scale:
        logs = torch.log(1e-6 + torch.sigmoid(logs + 2.0))
    z1 = _masked(m + torch.exp(logs) * x1, x_mask)
    logdet = torch.sum(logs.to(torch.float32) * x_mask.to(torch.float32), dim=(1, 2))
    return torch.cat([x0, z1], dim=-1), logdet


@torch.no_grad()
def decoder_ddi(
    blocks: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    hidden_channels: int,
    kernel_size: int,
    dilation_rate: int,
    n_layers: int,
    n_sqz: int,
    sigmoid_scale: bool = False,
    g: typing.Optional[torch.Tensor] = None,
    reduce: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Params:
    """Data-dependent ActNorm init: one deterministic forward pass in which
    each block's ActNorm params become the statistics of its input, its
    masked sums through ``reduce`` (:func:`actnorm_ddi_stats`; one call a
    block, each block's statistics feeding the next block's input).
    Returns {"logs": [nb, c], "bias": [nb, c]}."""
    x, x_mask = squeeze(x, x_mask, n_sqz)
    x_mask = x_mask.contiguous()
    logs, bias = [], []
    for i in range(blocks["actnorm"]["logs"].shape[0]):
        bp = tree_index(blocks, i)
        an = actnorm_ddi_stats(x, x_mask, reduce)
        logs.append(an["logs"])
        bias.append(an["bias"])
        x, _ = actnorm_fwd(an, x, x_mask)
        x, _ = invconv_apply(bp["invconv"], x, x_mask)
        x, _ = coupling_apply(
            bp["coupling"], x, x_mask, g, hidden_channels, kernel_size,
            dilation_rate, n_layers, sigmoid_scale,
        )
    return {"logs": torch.stack(logs), "bias": torch.stack(bias)}


def decoder_fwd(
    blocks: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    hidden_channels: int,
    kernel_size: int,
    dilation_rate: int,
    n_layers: int,
    n_split: int,
    n_sqz: int,
    sigmoid_scale: bool = False,
    g: typing.Optional[torch.Tensor] = None,
    p_dropout: float = 0.0,
    seed_generator: typing.Optional[torch.Generator] = None,
    block_fuse: bool = True,
    wn_residuals: str = "store",
):
    """mel -> (z, logdet [b]): squeeze, the blocks, unsqueeze.  With
    ``block_fuse`` the blocks are folded once and each runs through
    :func:`block_cuda.block_forward`; without, each runs its three
    bijectors op by op (:func:`actnorm_fwd`, :func:`invconv_apply`,
    :func:`coupling_apply`).  Dropout is on when ``seed_generator`` (a CPU
    generator) is given and ``p_dropout`` > 0: each block draws its int32
    seed from it, in either form (JAX draws it from its rng, a different
    stream).  x bf16 (``fp16_run``): the blocks in bf16 in either form and
    residual mode (the fused blocks' product weights and conditioning
    folded to bf16, as ``block_pallas.fold_blocks_stacked`` does), logdet
    f32."""
    x, x_mask = squeeze(x, x_mask, n_sqz)
    x_mask = x_mask.contiguous()
    drop = seed_generator is not None and p_dropout > 0.0
    p_dropout = p_dropout if drop else 0.0
    n_blocks = blocks["actnorm"]["logs"].shape[0]
    if not block_fuse:
        logdet = 0.0
        for i in range(n_blocks):
            bp = tree_index(blocks, i)
            seed = draw_seed(seed_generator) if drop else 0
            x, ld1 = actnorm_fwd(bp["actnorm"], x, x_mask)
            x, ld2 = invconv_apply(bp["invconv"], x, x_mask)
            x, ld3 = coupling_apply(
                bp["coupling"], x, x_mask, g, hidden_channels, kernel_size,
                dilation_rate, n_layers, sigmoid_scale, p_dropout=p_dropout, seed=seed,
                wn_residuals=wn_residuals,
            )
            logdet = logdet + ld1 + ld2 + ld3
        x, _ = unsqueeze(x, x_mask, n_sqz)
        return x, logdet
    c = x.shape[-1]
    x_len = torch.sum(x_mask.to(torch.float32), dim=(1, 2))
    folded, logs_sum, logabsdet, g_all = block_cuda.fold_blocks_stacked(
        blocks, n_layers, n_split, g, hidden_channels, x.dtype
    )
    logdet = torch.zeros_like(x_len)
    for i, fold in enumerate(folded):
        seed = draw_seed(seed_generator) if drop else 0
        ld1 = logs_sum[i] * x_len
        ld2 = logabsdet[i] * (c / n_split) * x_len
        x, ld3 = block_cuda.block_forward(
            fold, None if g_all is None else g_all[i], x, x_mask,
            kernel_size, dilation_rate, sigmoid_scale, p_dropout, seed, wn_residuals,
        )
        logdet = logdet + ld1 + ld2 + ld3
    x, _ = unsqueeze(x, x_mask, n_sqz)
    return x, logdet

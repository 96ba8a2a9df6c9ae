"""One flow block (ActNorm -> InvConvNear -> affine coupling) in both
directions: CUDA kernels (``csrc/block.cu``, ``csrc/block_train.cu``) and
their plain PyTorch versions.

:func:`block_inverse` replaces ``glow_tts_train_tpu/ops/block_pallas.py::
_block_inv_kernel``: start 1x1 of x0, the L-layer WN gated stack, end 1x1
-> (m, logs), z1 = (x1 - m) * exp(-logs), then the folded inverse of
InvConvNear and ActNorm as one [c, c] affine.  Its products read their
weights' K-major 3xTF32 splits, made once at load
(:func:`split_inverse_weights`, which ``flows.decoder_store_inverse``
applies), and take the tensor cores by the serving chain's plan
(``tc_gemm.inverse_product_plan``): split-K at any row count and 64-row
tiles, so a lone sentence's products fill the card too.

:func:`block_forward` is the training direction.  Its CUDA path is
:class:`FlowBlockTrain`.  With ``residuals="store"`` the forward replaces
``_block_fwd_save_kernel`` (zp = (x @ A + bA) * mask, start 1x1, WN stack
with dropout, end 1x1, z1 = (m + e^logs * x1) * mask, ld = sum(logs *
mask), saving zp, skipm and the per-layer WN inputs and gates), the
backward ``_block_bwd_store_kernel`` (coupling and end conv -> WN reverse
walk with the keep masks replayed from the seed -> start conv -> folded
A).  Saved residuals are laid out layer-major, ``[L, b, t, h]``, so each
layer's slice is one [rows, h] GEMM operand.  With
``residuals="recompute"`` the forward replaces ``_block_fwd_kernel``
(:func:`block_fwd`: the same chain, nothing saved; also what any forward
that is not differentiated runs) and the backward ``_block_bwd_kernel``
(:func:`block_bwd`: the forward-save chain again into scratch that lives
for that call only, then the store backward's chain, so its gradients
equal store mode's bit for bit, and at most one block's residuals are
alive at a time: 3 L b t h floats, where store mode holds every block's
from its forward to its backward).

Bound on the card: the operations of the in-layer conv GEMMs (80% of the
block's: rows = batch * t_y/2, K = 5 * 192, N = 384; backward runs three
such products per layer), on the tensor cores by the 3xTF32 split
(``csrc/tc_gemm.cu``: wgmma conv-GEMM and weight gradient, both
f32-accurate) where the shape fits, else f32 on the CUDA cores.  The TPU
kernels hold a sample's whole block with its 7 MB of weights in VMEM;
here each GEMM streams its weights from L2 (227 KB of shared memory
cannot hold them), gathers the dilated taps while staging, and fuses the
gate, the residual/skip split and the coupling into its epilogue, so only
[rows, h] and [rows, c] activations reach device memory.

Weights are the JAX folds' layout (``fold_block_params`` and
``fold_block_params_inverse``).
"""

import typing

import numpy as np
import torch

from .. import kernels
from .conv import conv1d, weight_norm_effective
from .wn_cuda import (
    check_residuals, drop_args, fold_wn_weights, needs_grad, tc_scratch, wn_stack_plain,
)

Params = typing.Dict[str, typing.Any]


def _invconv_selectors(c: int, n_split: int):
    """One-hot group selector S [c, s] and same-position mask QQT [c, c] of
    the reference's channel regrouping (ops/flows.py ``_invconv_selectors``)."""
    s = n_split
    ch = np.arange(c)
    a = ch // (c // 2)
    q = (ch % (c // 2)) // (s // 2)
    r = ch % (s // 2)
    sel = np.zeros((c, s), np.float32)
    sel[ch, a * (s // 2) + r] = 1.0
    qqt = (q[:, None] == q[None, :]).astype(np.float32)
    return sel, qqt


def invconv_dense(weight: torch.Tensor, c: int, n_split: int) -> torch.Tensor:
    """The s x s group mix as the equivalent dense [c, c] channel map
    M = (S W S^T) * QQT, so that z = x @ M^T."""
    sel, qqt = _invconv_selectors(c, n_split)
    sel = torch.as_tensor(sel, dtype=weight.dtype, device=weight.device)
    qqt = torch.as_tensor(qqt, dtype=weight.dtype, device=weight.device)
    return (sel @ weight @ sel.T) * qqt


def fold_block_params_inverse(block: Params, n_layers: int, n_split: int) -> dict:
    """Block params -> {A, bA, W_s, b_s, W_e, b_e, W_in, b_in, W_rs, b_rs}
    for the inverse direction, in fp32:

        y = z @ A + bA,  A = Minv^T diag(e^-logs),  bA = -bias e^-logs

    with Minv the dense [c, c] expansion of the s x s inverse mix
    (``weight_inv`` when stored, else inverted here)."""
    f32 = torch.float32
    an, inv, cp = block["actnorm"], block["invconv"], block["coupling"]
    w_inv = inv.get("weight_inv")
    if w_inv is None:
        w_inv = torch.linalg.inv(inv["weight"].to(f32))
    ws_full = weight_norm_effective(cp["start"])  # [1, c/2, h]
    c = 2 * ws_full.shape[1]
    minv = invconv_dense(w_inv.to(f32), c, n_split)
    e = torch.exp(-an["logs"].to(f32))
    W_in, b_in, W_rs, b_rs = fold_wn_weights(cp["wn"], n_layers)
    return {
        "A": (minv.T * e[None, :]).contiguous(),
        "bA": (-an["bias"].to(f32) * e).reshape(1, c).contiguous(),
        "W_s": ws_full[0].contiguous(),
        "b_s": cp["start"]["b"].to(f32).reshape(1, -1).contiguous(),
        "W_e": cp["end"]["w"][0].to(f32).contiguous(),
        "b_e": cp["end"]["b"].to(f32).reshape(1, -1).contiguous(),
        "W_in": W_in,
        "b_in": b_in,
        "W_rs": W_rs,
        "b_rs": b_rs,
    }


def block_inverse_plain(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`block_inverse`."""
    c2 = x.shape[-1] // 2
    x0, x1 = x[..., :c2], x[..., c2:]
    h0 = (x0 @ folded["W_s"] + folded["b_s"]) * x_mask
    skip = wn_stack_plain(
        (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"]),
        g_all, h0, x_mask, kernel_size, dilation_rate,
    )
    out = (skip * x_mask) @ folded["W_e"] + folded["b_e"]
    m, logs = out[..., :c2], out[..., c2:]
    if sigmoid_scale:
        logs = torch.log(1e-6 + torch.sigmoid(logs + 2.0))
    z1 = (x1 - m) * torch.exp(-logs) * x_mask
    z = torch.cat([x0, z1], dim=-1)
    return (z @ folded["A"] + folded["bA"]) * x_mask


def _block_tc_scratch(x_like: torch.Tensor, folded: dict) -> torch.Tensor:
    return tc_scratch(x_like, *(folded[k] for k in ("A", "W_s", "W_e", "W_in", "W_rs")))


# the serving block's products' weights, in the order of the C entry point
INVERSE_SPLIT_KEYS = ("A", "W_s", "W_e", "W_in", "W_rs")


def split_inverse_weights(folded: dict) -> dict:
    """``folded`` (:func:`fold_block_params_inverse`) with, beside each
    product's weights, their K-major 3xTF32 split (``tc_gemm.split_weights``:
    the kernel on a CUDA tensor, its plain version, the same bits, on a CPU
    one) under ``<key>_split``: [2, N, K] of a [K, N] matrix, [L, 2, N, K]
    of the WN stack's per-layer ones.  Made once at load; the serving
    block's products read them and split nothing at serve time (about
    twice the folded weights' memory: 3.6 M floats a block at base
    width)."""
    from .tc_gemm import split_weights

    out = dict(folded)
    for key in INVERSE_SPLIT_KEYS:
        w = folded[key].detach().contiguous()
        out[key + "_split"] = (
            torch.stack([split_weights(wl) for wl in w]) if w.dim() == 3 else split_weights(w)
        )
    return out


def block_inverse(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
) -> torch.Tensor:
    """One inverse flow block, x [b, t, c], x_mask [b, t, 1] -> [b, t, c].
    g_all: [b, L, 2h] per-layer speaker conditioning, or None.  On a CUDA
    tensor ``folded`` must carry its splits (:func:`split_inverse_weights`)."""
    if kernels.route(x) == "plain":
        return block_inverse_plain(
            folded, g_all, x, x_mask, kernel_size, dilation_rate, sigmoid_scale
        )
    batch, t, c = x.shape
    W_in = folded["W_in"]
    n_layers, kh, h2 = W_in.shape
    h = h2 // 2
    kernels.check_operands(x.device, x=x, x_mask=x_mask, g_all=g_all, **folded)
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("W_in", W_in, (n_layers, kernel_size * h, 2 * h))
    kernels.check_shape("W_s", folded["W_s"], (c // 2, h))
    kernels.check_shape("W_e", folded["W_e"], (h, c))
    kernels.check_shape("A", folded["A"], (c, c))
    if g_all is not None:
        kernels.check_shape("g_all", g_all, (batch, n_layers, 2 * h))
    missing = [k for k in INVERSE_SPLIT_KEYS if k + "_split" not in folded]
    if missing:
        raise ValueError(
            f"block_inverse: no weight splits for {missing}: fold with split_inverse_weights"
        )
    for key in INVERSE_SPLIT_KEYS:
        w = folded[key]
        split = (w.shape[0], 2, w.shape[2], w.shape[1]) if w.dim() == 3 else (2, w.shape[1], w.shape[0])
        kernels.check_shape(key + "_split", folded[key + "_split"], split)
    y = torch.empty_like(x)
    scratch = x.new_empty((kernels.block_inverse_scratch_floats(batch, t, c, h),))
    f = folded
    kernels.BLOCK_INVERSE(
        x, x_mask, f["A"], f["bA"], f["W_s"], f["b_s"], f["W_e"], f["b_e"],
        f["W_in"], f["b_in"], f["W_rs"], f["b_rs"], g_all,
        *(f[k + "_split"] for k in INVERSE_SPLIT_KEYS), y, scratch, scratch.numel(),
        0 if g_all is None else n_layers * 2 * h,
        batch, t, c, h, n_layers, kernel_size, dilation_rate, int(sigmoid_scale),
    )
    return y


# ---------------------------------------------------------------------------
# training direction
# ---------------------------------------------------------------------------

FOLD_KEYS = ("A", "bA", "W_s", "b_s", "W_e", "b_e", "W_in", "b_in", "W_rs", "b_rs")


def fold_block_params(block: Params, n_layers: int, n_split: int) -> dict:
    """Block params -> the training-direction kernel weights
    (``block_pallas.fold_block_params``), in fp32 and differentiable:

        zp = (x @ A + bA) * mask,  A = diag(e^logs) M^T,  bA = bias M^T

    with M the dense [c, c] expansion of the s x s mix.  Autograd carries
    the folded-weight gradients back to the actnorm logs/bias, the s x s
    invconv weight and the weight-normed g/v."""
    f32 = torch.float32
    an, inv, cp = block["actnorm"], block["invconv"], block["coupling"]
    ws_full = weight_norm_effective(cp["start"])  # [1, c/2, h]
    c = 2 * ws_full.shape[1]
    m = invconv_dense(inv["weight"].to(f32), c, n_split)
    scale = torch.exp(an["logs"].to(f32))
    W_in, b_in, W_rs, b_rs = fold_wn_weights(cp["wn"], n_layers)
    return {
        "A": (scale[:, None] * m.T).contiguous(),
        "bA": (an["bias"].to(f32) @ m.T).reshape(1, c).contiguous(),
        "W_s": ws_full[0].contiguous(),
        "b_s": cp["start"]["b"].to(f32).reshape(1, -1).contiguous(),
        "W_e": cp["end"]["w"][0].to(f32).contiguous(),
        "b_e": cp["end"]["b"].to(f32).reshape(1, -1).contiguous(),
        "W_in": W_in,
        "b_in": b_in,
        "W_rs": W_rs,
        "b_rs": b_rs,
    }


def fold_blocks_stacked(
    blocks: Params,
    n_layers: int,
    n_split: int,
    g: typing.Optional[torch.Tensor],
    hidden_channels: int,
) -> tuple:
    """All stacked blocks folded once per step (``block_pallas.
    fold_blocks_stacked``) -> (per-block folds, logs_sum [nb], logabsdet
    [nb], per-block conditioning [b, L, 2h] or None).  logs_sum is the
    actnorm logdet coefficient, logabsdet = log|det W| the invconv's
    (slogdet: ARCHITECTURE.md, Known divergences)."""
    from ..tree import tree_index

    f32 = torch.float32
    n_blocks = blocks["actnorm"]["logs"].shape[0]
    folded, g_all = [], []
    for i in range(n_blocks):
        bp = tree_index(blocks, i)
        folded.append(fold_block_params(bp, n_layers, n_split))
        if g is not None:
            cond = conv1d(g, bp["coupling"]["wn"]["cond"])
            g_all.append(cond.reshape(g.shape[0], n_layers, 2 * hidden_channels).contiguous())
    logs_sum = torch.sum(blocks["actnorm"]["logs"].to(f32), dim=-1)
    logabsdet = torch.linalg.slogdet(blocks["invconv"]["weight"].to(f32))[1]
    return folded, logs_sum, logabsdet, (g_all if g is not None else None)


def block_forward_plain(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
    saves: typing.Optional[dict] = None,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward (``block_pallas.
    _block_fwd_math``): x [b, t, c] -> (z [b, t, c], ld [b] = sum(logs *
    mask)).  Dropout uses the portable keep masks of ``seed`` (sample i:
    ``seed + i``), as the kernel does.  ``saves``: a dict that receives the
    store-mode residuals (zp, skipm, and lists xs/th/sg)."""
    c2 = x.shape[-1] // 2
    zp = (x @ folded["A"] + folded["bA"]) * x_mask
    x0, x1 = zp[..., :c2], zp[..., c2:]
    h0 = (x0 @ folded["W_s"] + folded["b_s"]) * x_mask
    skip = wn_stack_plain(
        (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"]),
        g_all, h0, x_mask, kernel_size, dilation_rate, p_dropout, seed, saves,
    )
    skipm = skip * x_mask
    out = skipm @ folded["W_e"] + folded["b_e"]
    m, logs = out[..., :c2], out[..., c2:]
    if sigmoid_scale:
        logs = torch.log(1e-6 + torch.sigmoid(logs + 2.0))
    z1 = (m + torch.exp(logs) * x1) * x_mask
    if saves is not None:
        saves["zp"], saves["skipm"] = zp, skipm
    return torch.cat([x0, z1], dim=-1), torch.sum(logs * x_mask, dim=(1, 2))


def _check_train_operands(folded, g_all, x, x_mask, kernel_size):
    batch, t, c = x.shape
    n_layers, kh, h2 = folded["W_in"].shape
    h = h2 // 2
    kernels.check_operands(x.device, x=x, x_mask=x_mask, g_all=g_all, **folded)
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("W_in", folded["W_in"], (n_layers, kernel_size * h, 2 * h))
    kernels.check_shape("W_rs", folded["W_rs"], (n_layers, h, 2 * h))
    kernels.check_shape("W_s", folded["W_s"], (c // 2, h))
    kernels.check_shape("W_e", folded["W_e"], (h, c))
    kernels.check_shape("A", folded["A"], (c, c))
    if g_all is not None:
        kernels.check_shape("g_all", g_all, (batch, n_layers, 2 * h))
    return batch, t, c, h, n_layers


def block_fwd_save(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> typing.Tuple[torch.Tensor, torch.Tensor, dict]:
    """The forward-save kernel on CUDA tensors -> (z, ld [b], saves): zp
    [b, t, c], skipm [b, t, h], xs/th/sg [L, b, t, h]."""
    batch, t, c, h, n_layers = _check_train_operands(folded, g_all, x, x_mask, kernel_size)
    z = torch.empty_like(x)
    ld = x.new_empty((batch,))
    zp = torch.empty_like(x)
    skipm = x.new_empty((batch, t, h))
    xs = x.new_empty((n_layers, batch, t, h))
    th = torch.empty_like(xs)
    sg = torch.empty_like(xs)
    acts = x.new_empty((batch, t, h))
    logsm = x.new_empty((batch, t, c // 2))
    ld_part = x.new_empty((batch, c // 2))
    f = folded
    drop, threshold, scale = drop_args(p_dropout)
    tc = _block_tc_scratch(x, f)
    kernels.BLOCK_FWD_SAVE(
        x, x_mask, f["A"], f["bA"], f["W_s"], f["b_s"], f["W_e"], f["b_e"],
        f["W_in"], f["b_in"], f["W_rs"], f["b_rs"], g_all,
        z, ld, zp, skipm, xs, th, sg, acts, logsm, ld_part, tc,
        tc.numel(), 0 if g_all is None else n_layers * 2 * h,
        batch, t, c, h, n_layers, kernel_size, dilation_rate, int(sigmoid_scale),
        drop, int(seed), threshold, scale,
    )
    return z, ld, {"zp": zp, "skipm": skipm, "xs": xs, "th": th, "sg": sg}


def block_fwd(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel that saves nothing, on CUDA tensors -> (z, ld [b])."""
    batch, t, c, h, n_layers = _check_train_operands(folded, g_all, x, x_mask, kernel_size)
    z = torch.empty_like(x)
    ld = x.new_empty((batch,))
    skipm = x.new_empty((batch, t, h))
    xcur = x.new_empty((batch, t, h))
    acts = x.new_empty((batch, t, h))
    logsm = x.new_empty((batch, t, c // 2))
    ld_part = x.new_empty((batch, c // 2))
    f = folded
    drop, threshold, scale = drop_args(p_dropout)
    tc = _block_tc_scratch(x, f)
    kernels.BLOCK_FWD(
        x, x_mask, f["A"], f["bA"], f["W_s"], f["b_s"], f["W_e"], f["b_e"],
        f["W_in"], f["b_in"], f["W_rs"], f["b_rs"], g_all,
        z, ld, skipm, xcur, acts, logsm, ld_part, tc,
        tc.numel(), 0 if g_all is None else n_layers * 2 * h,
        batch, t, c, h, n_layers, kernel_size, dilation_rate, int(sigmoid_scale),
        drop, int(seed), threshold, scale,
    )
    return z, ld


def _backward_operands(folded: dict, x: torch.Tensor, with_g: bool, kernel_size: int,
                       recompute: bool):
    """What both backward kernels take besides their residuals: the
    gradient tensors (keys ``dx`` and ``d<name>``, each shaped as its
    primal, and ``dg`` [b, L, 2h] or None) and the one scratch block of the
    call.  The kernels read the weights as the forward holds them."""
    batch, t, c = x.shape
    n_layers, _, h2 = folded["W_in"].shape
    grads = {"dx": torch.empty_like(x)}
    grads.update({"d" + k: torch.empty_like(folded[k]) for k in FOLD_KEYS})
    grads["dg"] = x.new_empty((batch, n_layers, h2)) if with_g else None
    scratch = x.new_empty((kernels.block_bwd_scratch_floats(
        batch, t, c, h2 // 2, n_layers, kernel_size, recompute, with_g),))
    return grads, scratch


def block_bwd_store(
    folded: dict,
    with_g: bool,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    saves: dict,
    dz: torch.Tensor,
    dld: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> dict:
    """The backward-store kernel on CUDA tensors -> the gradients of x and
    of every folded weight (keys ``dx`` and ``d<name>``, each shaped as
    its primal) and ``dg`` [b, L, 2h] when ``with_g``."""
    batch, t, c, h, n_layers = _check_train_operands(folded, None, x, x_mask, kernel_size)
    kernels.check_operands(x.device, dz=dz, dld=dld, **saves)
    kernels.check_shape("dz", dz, x.shape)
    kernels.check_shape("dld", dld, (batch,))
    kernels.check_shape("xs", saves["xs"], (n_layers, batch, t, h))
    f = folded
    grads, scratch = _backward_operands(folded, x, with_g, kernel_size, False)
    drop, threshold, scale = drop_args(p_dropout)
    s = saves
    kernels.BLOCK_BWD_STORE(
        x, x_mask, f["A"], f["W_s"], f["W_e"], f["b_e"], f["W_in"], f["W_rs"],
        s["zp"], s["skipm"], s["xs"], s["th"], s["sg"], dz, dld,
        grads["dx"], *(grads["d" + k] for k in FOLD_KEYS), grads["dg"],
        scratch, scratch.numel(), batch, t, c, h, n_layers, kernel_size, dilation_rate,
        int(sigmoid_scale), drop, int(seed), threshold, scale,
    )
    return grads


def block_bwd(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    dz: torch.Tensor,
    dld: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> dict:
    """The recompute backward kernel on CUDA tensors: the block forward
    again from its inputs (same seed, so the same keep masks) into scratch
    that lives for this call only, then the backward -> the gradients of
    :func:`block_bwd_store`."""
    batch, t, c, h, n_layers = _check_train_operands(folded, g_all, x, x_mask, kernel_size)
    kernels.check_operands(x.device, dz=dz, dld=dld)
    kernels.check_shape("dz", dz, x.shape)
    kernels.check_shape("dld", dld, (batch,))
    f = folded
    grads, scratch = _backward_operands(folded, x, g_all is not None, kernel_size, True)
    drop, threshold, scale = drop_args(p_dropout)
    kernels.BLOCK_BWD(
        x, x_mask, f["A"], f["bA"], f["W_s"], f["b_s"], f["W_e"], f["b_e"],
        f["W_in"], f["b_in"], f["W_rs"], f["b_rs"], g_all, dz, dld,
        grads["dx"], *(grads["d" + k] for k in FOLD_KEYS), grads["dg"],
        scratch, scratch.numel(), 0 if g_all is None else n_layers * 2 * h,
        batch, t, c, h, n_layers, kernel_size, dilation_rate,
        int(sigmoid_scale), drop, int(seed), threshold, scale,
    )
    return grads


class FlowBlockTrain(torch.autograd.Function):
    """One flow block's training forward on the card.  ``cfg`` =
    (kernel_size, dilation_rate, sigmoid_scale, p_dropout, seed,
    residuals).  "store": the forward-save kernel forward, the
    backward-store kernel backward; the saved residuals live from forward
    to backward only (freed with the graph).  "recompute": the forward
    kernel that saves nothing, keeping x, the mask, the weights and g_all,
    and the recompute backward kernel."""

    @staticmethod
    def forward(ctx, x, x_mask, g_all, cfg, *weights):
        *args, residuals = cfg
        folded = dict(zip(FOLD_KEYS, weights))
        ctx.cfg = cfg
        ctx.with_g = g_all is not None
        if residuals == "store":
            z, ld, saves = block_fwd_save(folded, g_all, x, x_mask, *args)
            ctx.save_for_backward(
                x, x_mask, *weights, saves["zp"], saves["skipm"], saves["xs"], saves["th"], saves["sg"]
            )
        else:
            z, ld = block_fwd(folded, g_all, x, x_mask, *args)
            ctx.save_for_backward(x, x_mask, *weights, *([g_all] if ctx.with_g else []))
        return z, ld

    @staticmethod
    def backward(ctx, dz, dld):
        *args, residuals = ctx.cfg
        x, x_mask, *rest = ctx.saved_tensors
        folded = dict(zip(FOLD_KEYS, rest[: len(FOLD_KEYS)]))
        rest = rest[len(FOLD_KEYS):]
        dz, dld = dz.contiguous(), dld.contiguous()
        if residuals == "store":
            saves = dict(zip(("zp", "skipm", "xs", "th", "sg"), rest))
            grads = block_bwd_store(folded, ctx.with_g, x, x_mask, saves, dz, dld, *args)
        else:
            grads = block_bwd(folded, rest[0] if rest else None, x, x_mask, dz, dld, *args)
        return (grads["dx"], None, grads["dg"], None, *(grads["d" + k] for k in FOLD_KEYS))


def block_forward(
    folded: dict,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    sigmoid_scale: bool = False,
    p_dropout: float = 0.0,
    seed: int = 0,
    residuals: str = "store",
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """One flow block, training direction: x [b, t, c], x_mask [b, t, 1],
    g_all [b, L, 2h] or None -> (z [b, t, c], ld [b] = sum(logs * mask)).
    CUDA tensors run :class:`FlowBlockTrain` in the ``residuals`` mode, or
    :func:`block_fwd` alone when nothing is differentiated; CPU tensors the
    plain version, whose autograd backward is the plain version of both
    backward kernels."""
    check_residuals(residuals)
    if kernels.route(x) == "plain":
        return block_forward_plain(
            folded, g_all, x, x_mask, kernel_size, dilation_rate, sigmoid_scale,
            p_dropout, seed,
        )
    args = (kernel_size, dilation_rate, bool(sigmoid_scale), float(p_dropout), int(seed))
    if not needs_grad(x, g_all, *folded.values()):
        return block_fwd(folded, g_all, x, x_mask, *args)
    return FlowBlockTrain.apply(
        x, x_mask, g_all, (*args, residuals), *(folded[k] for k in FOLD_KEYS)
    )

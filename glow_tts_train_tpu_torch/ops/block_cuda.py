"""Inverse of one flow block: CUDA kernel (``csrc/block.cu``) and its plain
PyTorch version.

:func:`block_inverse` replaces ``glow_tts_train_tpu/ops/block_pallas.py::
_block_inv_kernel``: start 1x1 of x0, the L-layer WN gated stack, end 1x1
-> (m, logs), z1 = (x1 - m) * exp(-logs), then the folded inverse of
InvConvNear and ActNorm as one [c, c] affine.

Bound on the card: f32 FMA throughput of the in-layer conv GEMM (80% of
the block's FLOPs: rows = batch * t_y/2, K = 5 * 192, N = 384).  The
TPU kernel holds the whole block with its 7 MB of weights in VMEM; here
each GEMM streams its weights from L2 (227 KB of shared memory cannot hold
them), gathers the dilated taps while staging, and fuses the gate, the
residual/skip split and the coupling inverse into its epilogue, so only
[rows, h] and [rows, c] activations reach device memory.

Weights are ``fold_block_params_inverse``'s dict, the JAX fold's layout.
"""

import typing

import numpy as np
import torch

from .. import kernels
from .conv import weight_norm_effective
from .wn_cuda import fold_wn_weights, wn_stack_plain

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
    g_all: [b, L, 2h] per-layer speaker conditioning, or None."""
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
    y = torch.empty_like(x)
    zbuf = torch.empty_like(x)
    xcur = x.new_empty((batch, t, h))
    acts = x.new_empty((batch, t, h))
    skip = x.new_empty((batch, t, h))
    f = folded
    kernels.BLOCK_INVERSE(
        x, x_mask, f["A"], f["bA"], f["W_s"], f["b_s"], f["W_e"], f["b_e"],
        f["W_in"], f["b_in"], f["W_rs"], f["b_rs"], g_all,
        y, zbuf, xcur, acts, skip,
        0 if g_all is None else n_layers * 2 * h,
        batch, t, c, h, n_layers, kernel_size, dilation_rate, int(sigmoid_scale),
    )
    return y

"""The WaveNet gated stack in the kernels' folded form (glow_tts_train_tpu
ops/wn_pallas.py ``fold_wn_weights`` and ``_layer_fwd``).

On the serving path the stack runs inside the inverse flow block's CUDA
kernel (``csrc/block.cu``), as on the TPU it runs inside
``_block_inv_kernel``; this module holds the fold and the plain layer math
that the block's plain version uses.  The standalone WN kernels
(``wn_pallas.py`` ``_fwd_kernel`` and the training kernels) are not ported
yet (ROADMAP).
"""

import typing

import torch

from .conv import conv_taps, weight_norm_effective

Params = typing.Dict[str, typing.Any]


def fold_wn_weights(params: Params, n_layers: int) -> tuple:
    """Stacked WN params -> (W_in [L, K*h, 2h], b_in [L, 2h],
    W_rs [L, h, 2h], b_rs [L, 2h]) in fp32, weight norm folded; the last
    layer's h-wide res/skip conv is padded to 2h with zeros on the
    residual half."""

    def fold(p):
        return (weight_norm_effective(p) if "v" in p else p["w"]), p["b"]

    def layer(stack, l):
        return {k: v[l] for k, v in stack.items()}

    w_list, b_list = [], []
    for l in range(n_layers):
        w, b = fold(layer(params["in_layers"], l))
        K, h, h2 = w.shape
        w_list.append(w.reshape(K * h, h2))
        b_list.append(b)
    rs_list, rb_list = [], []
    for l in range(n_layers - 1):
        w, b = fold(layer(params["res_skip"], l))
        rs_list.append(w[0])
        rb_list.append(b)
    w_last, b_last = fold(params["res_skip_last"])
    h = w_last.shape[1]
    rs_list.append(torch.cat([w_last.new_zeros((h, h)), w_last[0]], dim=1))
    rb_list.append(torch.cat([b_last.new_zeros((h,)), b_last]))
    f32 = torch.float32
    return (
        torch.stack(w_list).to(f32).contiguous(),
        torch.stack(b_list).to(f32).contiguous(),
        torch.stack(rs_list).to(f32).contiguous(),
        torch.stack(rb_list).to(f32).contiguous(),
    )


def wn_layer_plain(
    xcur: torch.Tensor,
    w_in: torch.Tensor,
    b_in: torch.Tensor,
    w_rs: torch.Tensor,
    b_rs: torch.Tensor,
    g_l: typing.Optional[torch.Tensor],
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation: int,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """One gated layer on folded weights: returns (next residual state,
    skip increment).  g_l: [b, 2h] conditioning of this layer, or None."""
    h = xcur.shape[-1]
    xin = conv_taps(xcur, w_in, b_in, kernel_size, dilation)
    if g_l is not None:
        xin = xin + g_l[:, None, :]
    acts = torch.tanh(xin[..., :h]) * torch.sigmoid(xin[..., h:])
    rs = acts @ w_rs + b_rs
    return (xcur + rs[..., :h]) * x_mask, rs[..., h:]


def wn_stack_plain(
    folded: tuple,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
) -> torch.Tensor:
    """The L-layer stack on folded weights -> skip sum [b, t, h] (not
    masked).  g_all: [b, L, 2h] or None."""
    w_in, b_in, w_rs, b_rs = folded
    skip = torch.zeros_like(x)
    for l in range(w_in.shape[0]):
        x, inc = wn_layer_plain(
            x, w_in[l], b_in[l], w_rs[l], b_rs[l],
            None if g_all is None else g_all[:, l],
            x_mask, kernel_size, dilation_rate ** l,
        )
        skip = skip + inc
    return skip

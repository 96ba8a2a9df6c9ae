"""The WaveNet gated stack in the kernels' folded form (glow_tts_train_tpu
ops/wn_pallas.py ``fold_wn_weights``, ``_layer_fwd``, the dropout bits
``_portable_bits``/``_regen_keep``), and the WN stack's own kernels.

:func:`wn_stack` replaces ``wn_pallas.py::_fwd_kernel``: the L-layer gated
stack -> skip sum, with in-kernel dropout when training, nothing saved.
It runs wherever the stack is not differentiated (data-dependent init, the
op-by-op inverse decoder) and as the forward of ``residuals="recompute"``.
On the card it is the inverse flow block's WN loop without the coupling
(``csrc/block_train.cu`` ``gtt_wn_forward``): per layer one conv-GEMM with
the gate in its epilogue and one 1x1 GEMM with the residual/skip split in
its epilogue (``csrc/common.cu``; on the tensor cores, f32-accurate by
the 3xTF32 split, where the shape fits: ``csrc/tc_gemm.cu``).  Bound: the
operations of the in-layer conv (K = 5 * 192, N = 384) over a third of
the TF32 peak; the gather-on-load taps keep the im2col matrix out of
device memory.

:class:`WNStackTrain` is the differentiable stack of the op-by-op decoder
(``wn_pallas.wn_stack_fused``).  ``residuals="store"``: :func:`wn_fwd_save`
(``_fwd_save_kernel``) writes the per-layer inputs and gates, layer-major
``[L, b, t, h]`` so each layer's slice is one GEMM operand, and
:func:`wn_bwd_store` (``_bwd_store_kernel``) walks the layers back from
them.  ``residuals="recompute"``: the forward saves only its inputs and
:func:`wn_bwd` (``_bwd_kernel``) re-runs the forward-save chain into
scratch that lives for that call only, then the same walk, so its
gradients equal store mode's bit for bit.  Keep masks are never stored:
every pass replays them from the seed.  The backward is bound like the
forward: three K = 5 * 192 products per layer, the weight gradient among
them on the tensor cores too.  The walk (``csrc/block_train.cu``) reads
W_in and W_rs as the forward holds them, splits every product's weights
in one launch a call, takes the bias gradients as the bias rows of the
weight gradients, stages the transposed conv's A once for all taps and
reads d_xin's K-major split in dW_in; its plan is
``tc_gemm.walk_products``.

Dropout keep masks are the JAX kernels' portable counter hash, bit for
bit, in its site form (``encoder_pallas._drop_keep``): the bits of flat
index ``row * n_cols + col`` of one sample's padded ``[t, n_cols]``
tensor, seeded by ``(seed + sample) * n_sites + site`` in int32
wrap-around; keep where ``bits >= round(p * 2**32)``.  The WN stack's
sites are its layers and its tensor the ``[t, 2h]`` pre-gate (``col`` in
JAX's ``[u | v]`` layout); the text kernels' sites are listed in
``text_cuda`` and ``encoder_cuda``.  CPU torch has little uint32
arithmetic, so the hash runs in int64 masked to 32 bits.
"""

import typing

import torch

from .. import kernels
from .conv import conv_taps, weight_norm_effective

Params = typing.Dict[str, typing.Any]

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for x < 2**32, in int64 without overflow (c split
    into 16-bit halves)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def portable_bits(seed, shape: typing.Tuple[int, int], device=None) -> torch.Tensor:
    """The uint32 counter hash of ``wn_pallas._portable_bits`` as int64:
    ``seed`` (an int or an int tensor of any shape S, taken mod 2**32) ->
    bits [*S, t, n] of the flat index ``row * n + col``."""
    t, n = shape
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK32
    x = torch.arange(t * n, dtype=torch.int64, device=seed.device).reshape(t, n)
    x = x ^ _mul32(seed[..., None, None], 2654435761)
    x = _mul32(x ^ (x >> 13), 0x9E3779B1)
    x = _mul32(x ^ (x >> 15), 0x85EBCA6B)
    return x ^ (x >> 16)


def drop_threshold(p: float) -> int:
    """The uint32 keep threshold of a dropout rate (wn_pallas ``st``)."""
    return min(round(p * 2 ** 32), 2 ** 32 - 1)


def drop_args(p_dropout: float) -> tuple:
    """(drop flag, uint32 threshold, f32 scale) of the kernels' dropout."""
    if p_dropout <= 0.0:
        return 0, 0, 1.0
    return 1, drop_threshold(p_dropout), 1.0 / (1.0 - p_dropout)


def regen_keep(seed, site: int, n_sites: int, shape, p: float, device=None) -> torch.Tensor:
    """The f32 0/1 keep mask of dropout site ``site`` of ``n_sites``
    (``wn_pallas._regen_keep``, ``encoder_pallas._drop_keep``): ``seed`` is
    the per-sample seed (int or int tensor [b]), ``shape`` the sample's
    padded (t, n_cols) -> [*S, t, n_cols]."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    site_seed = (_mul32(seed & _MASK32, n_sites) + site) & _MASK32
    bits = portable_bits(site_seed, shape)
    return (bits >= drop_threshold(p)).to(torch.float32)


def site_dropout(
    x: torch.Tensor, seed: int, site: int, n_sites: int, p: float
) -> torch.Tensor:
    """Inverted dropout of x [b, t, n] (or [b, heads, t, n] with one site
    per head, ``site`` then the first head's) with the portable keep masks:
    sample i draws from ``seed + i``.  The identity when p == 0."""
    if p <= 0.0:
        return x
    b = x.shape[0]
    seeds = seed + torch.arange(b, dtype=torch.int64, device=x.device)
    shape = tuple(x.shape[-2:])
    if x.dim() == 4:
        keep = torch.stack(
            [regen_keep(seeds, site + hd, n_sites, shape, p, x.device) for hd in range(x.shape[1])],
            dim=1,
        )
    else:
        keep = regen_keep(seeds, site, n_sites, shape, p, x.device)
    return x * keep * (1.0 / (1.0 - p))


def fold_wn_weights(params: Params, n_layers: int) -> tuple:
    """Stacked WN params -> (W_in [L, K*h, 2h], b_in [L, 2h],
    W_rs [L, h, 2h], b_rs [L, 2h]) in fp32, weight norm folded; the last
    layer's h-wide res/skip conv is padded to 2h with zeros on the
    residual half.  Differentiable: autograd carries the folded-weight
    gradients back to v, g and b (the padding gets none)."""

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
    keep: typing.Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> typing.Tuple[torch.Tensor, torch.Tensor, tuple]:
    """One gated layer on folded weights: returns (next residual state,
    skip increment, (tanh gate, sigmoid gate)).  g_l: [b, 2h] conditioning
    of this layer, or None; keep: [b, t, 2h] 0/1 dropout mask, or None."""
    h = xcur.shape[-1]
    xin = conv_taps(xcur, w_in, b_in, kernel_size, dilation)
    if keep is not None:
        xin = xin * keep * scale
    if g_l is not None:
        xin = xin + g_l[:, None, :]
    th, sg = torch.tanh(xin[..., :h]), torch.sigmoid(xin[..., h:])
    rs = (th * sg) @ w_rs + b_rs
    return (xcur + rs[..., :h]) * x_mask, rs[..., h:], (th, sg)


def wn_stack_plain(
    folded: tuple,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    p_dropout: float = 0.0,
    seed: int = 0,
    saves: typing.Optional[dict] = None,
) -> torch.Tensor:
    """The L-layer stack on folded weights -> skip sum [b, t, h] (not
    masked).  g_all: [b, L, 2h] or None.  With ``p_dropout`` > 0 each
    layer's pre-gate tensor is dropped with the portable keep masks of
    ``seed`` (sample i uses ``seed + i``).  ``saves``: a dict that
    receives the per-layer inputs and gates as lists ``xs``/``th``/``sg``
    (the store-mode residuals)."""
    w_in, b_in, w_rs, b_rs = folded
    n_layers = w_in.shape[0]
    b, t, h = x.shape
    sample_seeds = seed + torch.arange(b, dtype=torch.int64)
    skip = torch.zeros_like(x)
    for l in range(n_layers):
        keep = None
        if p_dropout > 0.0:
            keep = regen_keep(sample_seeds, l, n_layers, (t, 2 * h), p_dropout, x.device)
        if saves is not None:
            saves.setdefault("xs", []).append(x)
        x, inc, (th, sg) = wn_layer_plain(
            x, w_in[l], b_in[l], w_rs[l], b_rs[l],
            None if g_all is None else g_all[:, l],
            x_mask, kernel_size, dilation_rate ** l,
            keep, 1.0 / (1.0 - p_dropout),
        )
        if saves is not None:
            saves.setdefault("th", []).append(th)
            saves.setdefault("sg", []).append(sg)
        skip = skip + inc
    return skip


def _check_wn_operands(folded, g_all, x, x_mask, kernel_size):
    w_in, b_in, w_rs, b_rs = folded
    batch, t, h = x.shape
    n_layers = w_in.shape[0]
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, g_all=g_all, w_in=w_in, b_in=b_in, w_rs=w_rs, b_rs=b_rs
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("w_in", w_in, (n_layers, kernel_size * h, 2 * h))
    kernels.check_shape("w_rs", w_rs, (n_layers, h, 2 * h))
    if g_all is not None:
        kernels.check_shape("g_all", g_all, (batch, n_layers, 2 * h))
    return batch, t, h, n_layers


def tc_scratch(x_like: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """Scratch of the tensor-core conv-GEMM: room for the K-major 3xTF32
    split (two parts) of the largest of ``weights``' ``[..., K, N]``
    matrices; the products of one call use it in turn."""
    return x_like.new_empty((2 * max(w.shape[-2] * w.shape[-1] for w in weights),))


def wn_stack(
    folded: tuple,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """The WN stack forward, not differentiable: x [b, t, h], x_mask
    [b, t, 1], g_all [b, L, 2h] or None -> skip sum [b, t, h] (not
    masked).  ``p_dropout`` > 0 drops each layer's pre-gate tensor with the
    portable keep masks of ``seed``."""
    if kernels.route(x) == "plain":
        return wn_stack_plain(
            folded, g_all, x, x_mask, kernel_size, dilation_rate, p_dropout, seed
        )
    batch, t, h, n_layers = _check_wn_operands(folded, g_all, x, x_mask, kernel_size)
    w_in, b_in, w_rs, b_rs = folded
    skip = torch.empty_like(x)
    xcur = torch.empty_like(x)
    acts = torch.empty_like(x)
    drop, threshold, scale = drop_args(p_dropout)
    tc = tc_scratch(x, w_in, w_rs)
    kernels.WN_FORWARD(
        x, x_mask, w_in, b_in, w_rs, b_rs, g_all, skip, xcur, acts, tc,
        tc.numel(), 0 if g_all is None else n_layers * 2 * h,
        batch, t, h, n_layers, kernel_size, dilation_rate,
        drop, int(seed), threshold, scale,
    )
    return skip


def wn_fwd_save(
    folded: tuple,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> typing.Tuple[torch.Tensor, dict]:
    """The forward-save kernel on CUDA tensors -> (skip sum [b, t, h], not
    masked; saves: xs/th/sg [L, b, t, h], the per-layer inputs and gates)."""
    batch, t, h, n_layers = _check_wn_operands(folded, g_all, x, x_mask, kernel_size)
    w_in, b_in, w_rs, b_rs = folded
    skip = torch.empty_like(x)
    xs = x.new_empty((n_layers, batch, t, h))
    th = torch.empty_like(xs)
    sg = torch.empty_like(xs)
    acts = torch.empty_like(x)
    drop, threshold, scale = drop_args(p_dropout)
    tc = tc_scratch(x, w_in, w_rs)
    kernels.WN_FWD_SAVE(
        x, x_mask, w_in, b_in, w_rs, b_rs, g_all, skip, xs, th, sg, acts, tc,
        tc.numel(), 0 if g_all is None else n_layers * 2 * h,
        batch, t, h, n_layers, kernel_size, dilation_rate,
        drop, int(seed), threshold, scale,
    )
    return skip, {"xs": xs, "th": th, "sg": sg}


def _wn_grads(folded_like: tuple, x_like: torch.Tensor, with_g: bool) -> dict:
    w_in, w_rs = folded_like
    n_layers, _, h2 = w_in.shape
    return {
        "dx": torch.empty_like(x_like),
        "dW_in": torch.empty_like(w_in),
        "db_in": w_in.new_empty((n_layers, h2)),
        "dW_rs": torch.empty_like(w_rs),
        "db_rs": w_in.new_empty((n_layers, h2)),
        "dg": x_like.new_empty((x_like.shape[0], n_layers, h2)) if with_g else None,
    }


def wn_bwd_store(
    w_in: torch.Tensor,
    w_rs: torch.Tensor,
    with_g: bool,
    x_mask: torch.Tensor,
    saves: dict,
    dout: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> dict:
    """The backward-store kernel on CUDA tensors: from the saved per-layer
    inputs and gates and the skip sum's cotangent ``dout`` [b, t, h] -> the
    gradients ``dx``, ``dW_in``, ``db_in``, ``dW_rs``, ``db_rs`` and ``dg``
    [b, L, 2h] (None unless ``with_g``)."""
    n_layers, batch, t, h = saves["xs"].shape
    kernels.check_operands(dout.device, x_mask=x_mask, w_in=w_in, w_rs=w_rs, dout=dout, **saves)
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("dout", dout, (batch, t, h))
    kernels.check_shape("w_in", w_in, (n_layers, kernel_size * h, 2 * h))
    kernels.check_shape("w_rs", w_rs, (n_layers, h, 2 * h))
    for k in ("th", "sg"):
        kernels.check_shape(k, saves[k], (n_layers, batch, t, h))
    grads = _wn_grads((w_in, w_rs), dout, with_g)
    scratch = dout.new_empty(
        (kernels.wn_bwd_scratch_floats(batch, t, h, n_layers, kernel_size, False, with_g),))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.WN_BWD_STORE(
        x_mask, w_in, w_rs, saves["xs"], saves["th"], saves["sg"], dout,
        grads["dx"], grads["dW_in"], grads["db_in"], grads["dW_rs"], grads["db_rs"], grads["dg"],
        scratch, scratch.numel(), batch, t, h, n_layers, kernel_size, dilation_rate,
        drop, int(seed), threshold, scale,
    )
    return grads


def wn_bwd(
    folded: tuple,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    dout: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    p_dropout: float = 0.0,
    seed: int = 0,
) -> dict:
    """The recompute backward kernel on CUDA tensors: the forward again
    from its inputs into scratch that lives for this call only, then the
    walk -> the gradients of :func:`wn_bwd_store`."""
    batch, t, h, n_layers = _check_wn_operands(folded, g_all, x, x_mask, kernel_size)
    kernels.check_operands(x.device, dout=dout)
    kernels.check_shape("dout", dout, x.shape)
    w_in, b_in, w_rs, b_rs = folded
    grads = _wn_grads((w_in, w_rs), x, g_all is not None)
    scratch = x.new_empty((kernels.wn_bwd_scratch_floats(
        batch, t, h, n_layers, kernel_size, True, g_all is not None),))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.WN_BWD(
        x, x_mask, w_in, b_in, w_rs, b_rs, g_all, dout,
        grads["dx"], grads["dW_in"], grads["db_in"], grads["dW_rs"], grads["db_rs"], grads["dg"],
        scratch, scratch.numel(), 0 if g_all is None else n_layers * 2 * h,
        batch, t, h, n_layers, kernel_size, dilation_rate,
        drop, int(seed), threshold, scale,
    )
    return grads


class WNStackTrain(torch.autograd.Function):
    """The differentiable WN stack on the card.  ``cfg`` = (kernel_size,
    dilation_rate, p_dropout, seed, residuals).  "store": the forward-save
    kernel, keeping W_in, W_rs, the mask and xs/th/sg (not x, the biases or
    g_all) until the backward-store kernel has run; "recompute": the plain
    forward kernel, keeping only the inputs, and the recompute backward
    kernel."""

    @staticmethod
    def forward(ctx, x, x_mask, g_all, cfg, w_in, b_in, w_rs, b_rs):
        *args, residuals = cfg
        folded = (w_in, b_in, w_rs, b_rs)
        ctx.cfg = cfg
        ctx.with_g = g_all is not None
        if residuals == "store":
            skip, saves = wn_fwd_save(folded, g_all, x, x_mask, *args)
            ctx.save_for_backward(x_mask, w_in, w_rs, saves["xs"], saves["th"], saves["sg"])
        else:
            skip = wn_stack(folded, g_all, x, x_mask, *args)
            ctx.save_for_backward(x, x_mask, w_in, b_in, w_rs, b_rs, *([g_all] if ctx.with_g else []))
        return skip

    @staticmethod
    def backward(ctx, dout):
        *args, residuals = ctx.cfg
        dout = dout.contiguous()
        if residuals == "store":
            x_mask, w_in, w_rs, xs, th, sg = ctx.saved_tensors
            grads = wn_bwd_store(
                w_in, w_rs, ctx.with_g, x_mask, {"xs": xs, "th": th, "sg": sg}, dout, *args
            )
        else:
            x, x_mask, w_in, b_in, w_rs, b_rs, *g_all = ctx.saved_tensors
            grads = wn_bwd(
                (w_in, b_in, w_rs, b_rs), g_all[0] if g_all else None, x, x_mask, dout, *args
            )
        return (grads["dx"], None, grads["dg"], None,
                grads["dW_in"], grads["db_in"], grads["dW_rs"], grads["db_rs"])


def check_residuals(residuals: str) -> None:
    if residuals not in ("store", "recompute"):
        raise ValueError(f'residuals must be "store" or "recompute", got {residuals!r}')


def needs_grad(*tensors) -> bool:
    """Whether autograd will differentiate a function of ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def wn_stack_train(
    folded: tuple,
    g_all: typing.Optional[torch.Tensor],
    x: torch.Tensor,
    x_mask: torch.Tensor,
    kernel_size: int,
    dilation_rate: int,
    p_dropout: float = 0.0,
    seed: int = 0,
    residuals: str = "store",
) -> torch.Tensor:
    """The differentiable WN stack -> skip sum [b, t, h] (not masked; the
    caller multiplies).  CUDA tensors run :class:`WNStackTrain` (or, when
    nothing is differentiated, :func:`wn_stack`); CPU tensors the plain
    version, whose autograd backward is the plain version of both backward
    kernels."""
    check_residuals(residuals)
    if kernels.route(x) == "plain":
        return wn_stack_plain(
            folded, g_all, x, x_mask, kernel_size, dilation_rate, p_dropout, seed
        )
    if not needs_grad(x, g_all, *folded):
        return wn_stack(folded, g_all, x, x_mask, kernel_size, dilation_rate, p_dropout, seed)
    cfg = (kernel_size, dilation_rate, float(p_dropout), int(seed), residuals)
    return WNStackTrain.apply(x, x_mask, g_all, cfg, *folded)

"""The prenet and duration-predictor conv stacks: CUDA kernels
(``csrc/text.cu``, ``csrc/text_train.cu``) and their plain PyTorch
versions.

:func:`prenet` replaces ``glow_tts_train_tpu/ops/text_pallas.py::
_prenet_fwd_kernel`` (3 x [masked k=5 conv -> LN -> ReLU -> dropout],
residual 1x1 projection, x mask); :func:`duration_stack` replaces
``::_dp_fwd_kernel`` (2 x [masked k=3 conv -> ReLU -> LN -> dropout]).
:func:`prenet_bwd` and :func:`duration_stack_bwd` replace
``::_prenet_bwd_kernel`` and ``::_dp_bwd_kernel``: like them they take
(weights, x, mask, seed) and the output cotangent, recompute the stack
and return the gradients of x and of every weight.  :class:`PrenetTrain`
and :class:`DurationStackTrain` join each pair as a
``torch.autograd.Function`` that saves only (weights, x, mask).  The
duration predictor's 1-channel projection stays outside the kernel, as in
the JAX package.

Dropout is the JAX kernels' per-site keep mask (``wn_cuda.regen_keep``):
the prenet's site ``l`` of ``L`` drops layer ``l``'s ReLU output
``[t, h]``, the duration stack's site ``l`` of 2 layer ``l``'s LayerNorm
output ``[t, f]``; sample ``i`` draws from ``seed + i``.

Bound on the card: both stacks are small f32 GEMMs (rows = batch * t_x,
192 or 256 columns).  The kernels gather each conv's taps while staging the
GEMM operand (no im2col buffer) and keep one launch per GEMM and per
LayerNorm; the backward adds per layer a weight gradient (split partial
sums added in a fixed order, so the same bits from run to run) and a
transposed conv.  The prenet's products run on the tensor cores (3xTF32,
split-K for the short, deep shapes of t_x <= 192) where the rows fill the
card: every conv input is stored masked (x * mask once, then each layer's
output times the mask), since the tensor-core kernel takes no input mask
on a tap gather; the transposed products read the forward's weights as
they lie, and each call takes one scratch block
(``kernels.prenet_scratch_floats``).  A lone short sentence (b=1) and the
duration stack stay on the CUDA cores, where latency and per-block
occupancy, not FLOPs, bound them.

A ReLU whose input is within rounding of zero may open in one version
and not in the other, and its gradient then differs by a whole term, so a
backward is held to its plain version at equal gates: the backward
wrappers hand out the recomputed forward's gates (``saves["gates"]``, per
layer where the ReLU output is positive, the keep mask included where the
dropout follows the ReLU), the plain versions take them (``gates=``) and
record their own with the ReLU inputs (``saves=``), and a caller checks
that the two sets differ only at such ties.

Weights are the JAX folds' layout (``prenet_weights``/``dp_weights``):
conv weights [taps * c_in, c_out], tap-major rows.
"""

import typing

import torch

from .. import kernels
from .attention import dropout
from .conv import conv1d, conv_taps
from .norms import layer_norm_affine
from .wn_cuda import drop_args, site_dropout

Params = typing.Dict[str, typing.Any]
# a chain's convs and projection have their weights split in one launch
# (csrc/text.cuh kMaxPrenetLayers)
MAX_PRENET_LAYERS = 7


def prenet_weights(params: Params) -> tuple:
    """Prenet params -> (W [L, K*h, h], b [L, h], gamma [L, h], beta [L, h],
    W_proj [h, h], b_proj [1, h])."""
    layers = params["layers"]
    L, K, h = layers["conv"]["w"].shape[:3]
    f32 = torch.float32
    return (
        layers["conv"]["w"].reshape(L, K * h, -1).to(f32).contiguous(),
        layers["conv"]["b"].to(f32).contiguous(),
        layers["norm"]["gamma"].to(f32).contiguous(),
        layers["norm"]["beta"].to(f32).contiguous(),
        params["proj"]["w"][0].to(f32).contiguous(),
        params["proj"]["b"].to(f32).reshape(1, -1).contiguous(),
    )


def dp_weights(params: Params) -> tuple:
    """Duration-predictor params -> (W1 [K*c, f], b1, gamma1, beta1,
    W2 [K*f, f], b2, gamma2, beta2), vectors as [1, f]."""
    f32 = torch.float32

    def conv(p):
        w = p["w"]
        return (
            w.reshape(w.shape[0] * w.shape[1], -1).to(f32).contiguous(),
            p["b"].to(f32).reshape(1, -1).contiguous(),
        )

    def norm(p):
        return (
            p["gamma"].to(f32).reshape(1, -1).contiguous(),
            p["beta"].to(f32).reshape(1, -1).contiguous(),
        )

    return (
        *conv(params["conv_1"]), *norm(params["norm_1"]),
        *conv(params["conv_2"]), *norm(params["norm_2"]),
    )


def taps_transposed(w: torch.Tensor, taps: int) -> torch.Tensor:
    """[taps * c_in, n] -> [taps * n, c_in]: per tap the transposed block
    (the operand of the transposed conv; a layout copy)."""
    c_in = w.shape[0] // taps
    return w.reshape(taps, c_in, -1).transpose(1, 2).reshape(-1, c_in).contiguous()


def wgrad_scratch(x: torch.Tensor, largest: int) -> torch.Tensor:
    """Room for the weight gradients' split partial sums."""
    return x.new_empty((max(1 << 22, largest),))


def plain_grads(fn, weights: tuple, x: torch.Tensor, dout: torch.Tensor) -> tuple:
    """(dx, *dweights) of ``fn(weights, x)`` by autograd: the plain version
    of a backward kernel."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in (x, *weights)]
        out = fn(tuple(leaves[1:]), leaves[0])
        return torch.autograd.grad(out, leaves, dout)


def _record(saves: typing.Optional[dict], pre: torch.Tensor, out: torch.Tensor) -> None:
    """Keep a ReLU's input and gate (output > 0) of one layer in ``saves``."""
    if saves is not None:
        saves.setdefault("pre", []).append(pre.detach())
        saves.setdefault("gates", []).append(out.detach() > 0)


def prenet_plain(
    weights: tuple,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
    seed: typing.Optional[int] = None,
    gates: typing.Optional[typing.Sequence[torch.Tensor]] = None,
    saves: typing.Optional[dict] = None,
) -> torch.Tensor:
    """Plain version of :func:`prenet` (text_pallas.py ``_prenet_fwd_math``);
    differentiable.  Dropout after each ReLU: the kernel's hash masks when
    ``seed`` is given, else drawn from ``generator`` (the training encoder
    with ``encoder_fuse: false``), else none.  ``gates`` (per layer, where
    the dropped ReLU output is positive) replace the ReLU and the keep
    mask; ``saves`` receives the ReLU inputs and this run's gates."""
    w, b, gamma, beta, wp, bp = weights
    taps = w.shape[1] // x.shape[-1]
    n_layers = w.shape[0]
    cur = x
    for l in range(n_layers):
        y = layer_norm_affine(conv_taps(cur * x_mask, w[l], b[l], taps), gamma[l], beta[l])
        if gates is not None:
            cur = y * gates[l] * drop_args(p_dropout)[2]
        elif seed is not None:
            cur = site_dropout(torch.relu(y), seed, l, n_layers, p_dropout)
        else:
            cur = dropout(torch.relu(y), p_dropout, generator)
        _record(saves, y, cur)
    return (x + cur @ wp + bp) * x_mask


def _check_prenet(weights, x, x_mask):
    w, b, gamma, beta, wp, bp = weights
    batch, t, h = x.shape
    L = w.shape[0]
    taps = w.shape[1] // h
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, w=w, b=b, gamma=gamma, beta=beta, wp=wp, bp=bp
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("w", w, (L, taps * h, h))
    kernels.check_shape("wp", wp, (h, h))
    if L > MAX_PRENET_LAYERS:
        raise ValueError(f"the prenet kernels take at most {MAX_PRENET_LAYERS} layers, got {L}")
    return batch, t, h, L, taps


def prenet(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, p_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """ConvReluNorm prenet, x [b, t, h], x_mask [b, t, 1] -> [b, t, h];
    with ``p_dropout`` > 0 the keep masks of ``seed``."""
    if kernels.route(x) == "plain":
        return prenet_plain(weights, x, x_mask, p_dropout, seed=seed)
    batch, t, h, L, taps = _check_prenet(weights, x, x_mask)
    out = torch.empty_like(x)
    scratch = x.new_empty((kernels.prenet_scratch_floats(batch, t, h, L, taps, False),))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.PRENET(
        x, x_mask, *weights, out, scratch, scratch.numel(), batch, t, h, L, taps,
        drop, int(seed), threshold, scale,
    )
    return out


def prenet_bwd_plain(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, dout: torch.Tensor,
    p_dropout: float = 0.0, seed: int = 0, gates=None, saves=None,
) -> tuple:
    """Plain version of :func:`prenet_bwd`: autograd of :func:`prenet_plain`
    with the same keep masks (at the given ``gates``, if any)."""
    return plain_grads(
        lambda w, xx: prenet_plain(w, xx, x_mask, p_dropout, seed=seed, gates=gates, saves=saves),
        weights, x, dout,
    )


def prenet_bwd(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, dout: torch.Tensor,
    p_dropout: float = 0.0, seed: int = 0, saves: typing.Optional[dict] = None,
) -> tuple:
    """The prenet's backward from (weights, x, mask, seed): recomputes the
    forward, then -> (dx, dw, db, dgamma, dbeta, dwp, dbp), each shaped as
    its primal.  ``saves`` receives the recomputed forward's gates and
    output (``"out"``: the forward kernel's bits)."""
    if kernels.route(x) == "plain":
        return prenet_bwd_plain(weights, x, x_mask, dout, p_dropout, seed, saves=saves)
    batch, t, h, L, taps = _check_prenet(weights, x, x_mask)
    kernels.check_operands(x.device, dout=dout)
    kernels.check_shape("dout", dout, x.shape)
    grads = tuple(torch.empty_like(a) for a in (x, *weights))
    out = torch.empty_like(x)
    cur = x.new_empty((max(L, 1), batch, t, h))
    scratch = x.new_empty((kernels.prenet_scratch_floats(batch, t, h, L, taps, True),))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.PRENET_BWD(
        x, x_mask, *weights, dout, *grads, out, cur, scratch, scratch.numel(),
        batch, t, h, L, taps, drop, int(seed), threshold, scale,
    )
    if saves is not None:
        saves["gates"] = [cur[l] > 0 for l in range(L)]
        saves["out"] = out
    return grads


class PrenetTrain(torch.autograd.Function):
    """The training prenet: :func:`prenet` forward, :func:`prenet_bwd`
    backward.  Saves (weights, x, mask) only; the backward recomputes, as
    the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, x, x_mask, p_dropout, seed, *weights):
        ctx.cfg = (float(p_dropout), int(seed))
        ctx.save_for_backward(x, x_mask, *weights)
        return prenet(weights, x, x_mask, *ctx.cfg)

    @staticmethod
    def backward(ctx, dout):
        x, x_mask, *weights = ctx.saved_tensors
        grads = prenet_bwd(tuple(weights), x, x_mask, dout.contiguous(), *ctx.cfg)
        return (grads[0], None, None, None, *grads[1:])


def prenet_train(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, p_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """:func:`prenet` with its hand-written backward."""
    return PrenetTrain.apply(x, x_mask, p_dropout, seed, *weights)


def duration_stack_plain(
    weights: tuple,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    p_dropout: float = 0.0,
    generator: typing.Optional[torch.Generator] = None,
    seed: typing.Optional[int] = None,
    gates: typing.Optional[typing.Sequence[torch.Tensor]] = None,
    saves: typing.Optional[dict] = None,
) -> torch.Tensor:
    """Plain version of :func:`duration_stack` (text_pallas.py
    ``_dp_fwd_math``); differentiable.  Dropout after each LayerNorm: the
    kernel's hash masks when ``seed`` is given, else drawn from
    ``generator``, else none.  ``gates`` (per layer, where the ReLU output
    is positive) replace the ReLU; ``saves`` receives the ReLU inputs and
    this run's gates."""
    w1, b1, g1, be1, w2, b2, g2, be2 = weights
    taps = w1.shape[0] // x.shape[-1]
    cur = x
    for l, (w, b, g, be) in enumerate(((w1, b1, g1, be1), (w2, b2, g2, be2))):
        pre = conv_taps(cur * x_mask, w, b, taps)
        r = pre * gates[l] if gates is not None else torch.relu(pre)
        _record(saves, pre, r)
        cur = layer_norm_affine(r, g, be)
        if seed is not None:
            cur = site_dropout(cur, seed, l, 2, p_dropout)
        else:
            cur = dropout(cur, p_dropout, generator)
    return cur


def _check_duration(weights, x, x_mask):
    w1, b1, g1, be1, w2, b2, g2, be2 = weights
    batch, t, c = x.shape
    taps = w1.shape[0] // c
    f = w1.shape[1]
    kernels.check_operands(
        x.device, x=x, x_mask=x_mask, w1=w1, b1=b1, g1=g1, be1=be1,
        w2=w2, b2=b2, g2=g2, be2=be2,
    )
    kernels.check_shape("x_mask", x_mask, (batch, t, 1))
    kernels.check_shape("w1", w1, (taps * c, f))
    kernels.check_shape("w2", w2, (taps * f, f))
    return batch, t, c, f, taps


def duration_stack(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, p_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """Duration-predictor conv stack, x [b, t, c] -> [b, t, f]; with
    ``p_dropout`` > 0 the keep masks of ``seed``."""
    if kernels.route(x) == "plain":
        return duration_stack_plain(weights, x, x_mask, p_dropout, seed=seed)
    batch, t, c, f, taps = _check_duration(weights, x, x_mask)
    out = x.new_empty((batch, t, f))
    pre = x.new_empty((batch, t, f))
    drop, threshold, scale = drop_args(p_dropout)
    kernels.DURATION_STACK(
        x, x_mask, *weights, out, pre, batch, t, c, f, taps,
        drop, int(seed), threshold, scale,
    )
    return out


def duration_stack_bwd_plain(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, dout: torch.Tensor,
    p_dropout: float = 0.0, seed: int = 0, gates=None, saves=None,
) -> tuple:
    """Plain version of :func:`duration_stack_bwd`: autograd of
    :func:`duration_stack_plain` with the same keep masks (at the given
    ``gates``, if any)."""
    return plain_grads(
        lambda w, xx: duration_stack_plain(
            w, xx, x_mask, p_dropout, seed=seed, gates=gates, saves=saves
        ),
        weights, x, dout,
    )


def duration_stack_bwd(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, dout: torch.Tensor,
    p_dropout: float = 0.0, seed: int = 0, saves: typing.Optional[dict] = None,
) -> tuple:
    """The duration stack's backward from (weights, x, mask, seed):
    recomputes the forward, then -> (dx, dw1, db1, dgamma1, dbeta1, dw2,
    db2, dgamma2, dbeta2), each shaped as its primal.  ``saves`` receives
    the recomputed forward's gates."""
    if kernels.route(x) == "plain":
        return duration_stack_bwd_plain(weights, x, x_mask, dout, p_dropout, seed, saves=saves)
    batch, t, c, f, taps = _check_duration(weights, x, x_mask)
    kernels.check_operands(x.device, dout=dout)
    kernels.check_shape("dout", dout, (batch, t, f))
    w1_t = taps_transposed(weights[0], taps)
    w2_t = taps_transposed(weights[4], taps)
    grads = tuple(torch.empty_like(a) for a in (x, *weights))
    rows = batch * t
    out, mid, dcur, dpre = (x.new_empty((rows, f)) for _ in range(4))
    relu = x.new_empty((2, rows, f))
    xhat = x.new_empty((2, rows, f))
    rstd = x.new_empty((2, rows))
    col_part = x.new_empty((batch, f))
    wg_scratch = wgrad_scratch(x, taps * max(c, f) * f)
    drop, threshold, scale = drop_args(p_dropout)
    kernels.DURATION_STACK_BWD(
        x, x_mask, *weights, w1_t, w2_t, dout, *grads,
        out, relu, mid, xhat, rstd, dcur, dpre, col_part, wg_scratch,
        wg_scratch.numel(), batch, t, c, f, taps, drop, int(seed), threshold, scale,
    )
    if saves is not None:
        saves["gates"] = [relu[l].reshape(batch, t, f) > 0 for l in range(2)]
    return grads


class DurationStackTrain(torch.autograd.Function):
    """The training duration stack: :func:`duration_stack` forward,
    :func:`duration_stack_bwd` backward; saves (weights, x, mask) only."""

    @staticmethod
    def forward(ctx, x, x_mask, p_dropout, seed, *weights):
        ctx.cfg = (float(p_dropout), int(seed))
        ctx.save_for_backward(x, x_mask, *weights)
        return duration_stack(weights, x, x_mask, *ctx.cfg)

    @staticmethod
    def backward(ctx, dout):
        x, x_mask, *weights = ctx.saved_tensors
        grads = duration_stack_bwd(tuple(weights), x, x_mask, dout.contiguous(), *ctx.cfg)
        return (grads[0], None, None, None, *grads[1:])


def duration_stack_train(
    weights: tuple, x: torch.Tensor, x_mask: torch.Tensor, p_dropout: float = 0.0,
    seed: int = 0,
) -> torch.Tensor:
    """:func:`duration_stack` with its hand-written backward."""
    return DurationStackTrain.apply(x, x_mask, p_dropout, seed, *weights)


def duration_predictor(
    weights: tuple, proj: Params, x: torch.Tensor, x_mask: torch.Tensor
) -> torch.Tensor:
    """Log-durations [b, t, 1]: the stack, then the 1-channel projection."""
    h2 = duration_stack(weights, x, x_mask)
    return conv1d(h2 * x_mask, proj) * x_mask

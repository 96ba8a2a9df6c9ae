"""What the bf16 plain versions share (``fp16_run: true``).

The JAX package's kernels take bf16 activations and bf16 weights, compute
every product as ``jnp.dot(a.astype(bf16), w, preferred_element_type=f32)``
and all elementwise math in f32, and round to bf16 where the kernel
writes ``.astype(dtype)``.  Their backward kernels are written by hand: a
cotangent is rounded to bf16 just before it enters a product, and nowhere
else.  The plain versions compute in f32 on values that are rounded at
the same points, and place the backward's roundings with two autograd
markers:

* :func:`round_fwd`: the forward's ``.astype(bf16)``, whose cotangent
  passes unrounded (the hand-written backward has no cast there);
* :func:`round_grad`: on a product's output, the backward's
  ``cotangent.astype(bf16)`` before the product's two gradients (a bias
  added after it gets the unrounded cotangent, as the kernels' bias sums
  do).

A module's bf16 tensors at its boundary (activations, weights) cast with
``.float()`` / ``.to(bf16)``, whose autograd rounds a cotangent to bf16
where the JAX kernel returns it in bf16 (``dx``, ``g.astype(w.dtype)``).
"""

import torch

BF16 = torch.bfloat16
F32 = torch.float32


def rounded(x: torch.Tensor) -> torch.Tensor:
    """x's values rounded to bf16 (nearest even), kept in f32."""
    return x.to(BF16).to(F32)


class _RoundFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return rounded(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rounded(g)


def round_fwd(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 in the forward; the cotangent passes as it is."""
    return _RoundFwd.apply(x)


def round_grad(x: torch.Tensor) -> torch.Tensor:
    """The identity in the forward; the cotangent is rounded to bf16."""
    return _RoundGrad.apply(x)


class _ProductSaved(torch.autograd.Function):
    """a @ w whose weight gradient reads ``a_bwd`` in place of ``a`` (the
    value the backward kernel rebuilds from its saves), the cotangent
    rounded first."""

    @staticmethod
    def forward(ctx, a, a_bwd, w):
        ctx.save_for_backward(a_bwd, w)
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a_bwd, w = ctx.saved_tensors
        g = rounded(g)
        return g @ w.transpose(-1, -2), None, (a_bwd.reshape(-1, a_bwd.shape[-1]).T
                                               @ g.reshape(-1, g.shape[-1]))


def product(a: torch.Tensor, w: torch.Tensor, a_bwd=None) -> torch.Tensor:
    """A bf16 product, a @ w with f32 accumulation (a and w hold bf16
    values), its cotangent rounded in the backward.  ``a_bwd``: the value
    the backward's weight gradient reads instead of ``a``."""
    if a_bwd is None:
        return round_grad(a @ w)
    return _ProductSaved.apply(a, a_bwd.detach(), w)


class _Scores(torch.autograd.Function):
    """q @ k^T * scale whose backward rounds the score cotangent before
    its two products and scales after them (encoder_pallas._bwd_kernel:
    dq = (ds.astype(bf16) @ k) * scale)."""

    @staticmethod
    def forward(ctx, q, k, scale):
        ctx.save_for_backward(q, k)
        ctx.scale = scale
        return (q @ k.transpose(-1, -2)) * scale

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        g = rounded(g)
        return (g @ k) * ctx.scale, (g.transpose(-1, -2) @ q) * ctx.scale, None


def scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return _Scores.apply(q, k, scale)


class _Gate(torch.autograd.Function):
    """tanh(u) * sigmoid(v) rounded to bf16, whose backward reads the
    gates rounded to bf16 (the store-mode saves, wn_pallas._reverse_walk)."""

    @staticmethod
    def forward(ctx, u, v):
        th, sg = torch.tanh(u), torch.sigmoid(v)
        th_r, sg_r = rounded(th), rounded(sg)
        ctx.save_for_backward(th_r, sg_r)
        return rounded(th * sg), th_r, sg_r

    @staticmethod
    def backward(ctx, da, _dth, _dsg):
        th, sg = ctx.saved_tensors
        return da * sg * (1.0 - th * th), da * th * sg * (1.0 - sg)


def gate(u: torch.Tensor, v: torch.Tensor):
    """-> (acts, tanh gate, sigmoid gate), each rounded to bf16."""
    return _Gate.apply(u, v)

"""The prenet's and the duration stack's bf16 chains on the TMA-fed wgmma
products (bf16 rows 1 and 14: ``gtt_prenet_bf16``, ``gtt_prenet_bwd_bf16``;
rows 3 and 15: ``gtt_duration_stack_bf16``, ``gtt_duration_stack_bwd_bf16``),
on the CPU.

* The plan (``tc_gemm.bf16_prenet_products``, ``bf16_duration_products``:
  the plain version of the chains' dispatch in ``csrc/bf16_gemm.cu``): at
  [32, 192] and at [16, t] for t of 64 to 192 (and a ragged 93) every
  product on the TMA-fed units, each conv-GEMM's chunks and split-K shares
  those of fewest waves x slices (against a brute force), the rings within
  a block's 232,448 bytes; below 64 channels every product on the mma.sync
  kernels, by shape alone; the device operations of a call.
* A bf16 copy written by the kernel that produces the operand (the masked
  layer inputs, dpre's copy beside the LayerNorm backward's f32 result, the
  prenet's dout * mask) holds the bits that the mma.sync kernels' staging
  made from what the parent chain stored (``load8``: round(v * m)), with
  ties and subnormals.
* An emulation of the chains' arithmetic: every product of bf16 operands in
  64-deep K slices summed in f32, split into the plan's shares added in
  order, the weight gradients' 64-row slices split as the plan splits
  them, each f32 cotangent read through its bf16 copy and the bias and norm
  sums of the unrounded values.  Against ``prenet_plain_bf16`` /
  ``duration_stack_plain_bf16`` and their autograd at base width with
  dropout on (2e-2 of each output's max, the kernels' tolerance against
  their plain version), and against the JAX package's text kernels in bf16
  (interpret mode) at h 64, the narrowest width the TMA-fed units take,
  within half of JAX's own bf16-vs-f32 gap.
"""

import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import text_pallas as tp
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu_torch.ops import tc_gemm, text_cuda
from glow_tts_train_tpu_torch.ops.wn_cuda import drop_args, regen_keep, site_dropout

from test_torch_bf16 import _held_all, _inputs, _jax_vjp, _port_vjp, _weights
from test_torch_bf16_encoder_tc import (MAX_BLOCK_SMEM, SMS, _brute_plan, _conv, _held, _ln,
                                        _ln_bwd, _r, _special_values, _wgrad)
from test_torch_bf16_tc import _rne_bf16_bits

BF16 = torch.bfloat16
# base width: the prenet's 3 layers of 5 taps at h 192, the duration
# stack's 2 layers of 3 taps from 192 channels at f 256
BASE_H, PRENET_L, PRENET_TAPS, DP_F, DP_TAPS = 192, 3, 5, 256, 3


def _plans(batch, t, h=BASE_H, f=DP_F):
    return {
        "prenet": [tc_gemm.bf16_prenet_products(batch, t, h, PRENET_L, PRENET_TAPS, SMS, bw)
                   for bw in (False, True)],
        "duration": [tc_gemm.bf16_duration_products(batch, t, h, f, DP_TAPS, SMS, bw)
                     for bw in (False, True)],
    }


# a call's products: (forward, backward) counts of kernels.product_counts
TMA_COUNTS = {
    "prenet": ({"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 4, "bf16_tma_wgrad": 0},
               {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 8, "bf16_tma_wgrad": 4}),
    "duration": ({"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 2, "bf16_tma_wgrad": 0},
                 {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 4, "bf16_tma_wgrad": 2}),
}


@pytest.mark.parametrize("batch,t", [(32, 192), (16, 64), (16, 96), (16, 128), (16, 192),
                                     (32, 93)])
def test_every_product_takes_the_tma_units(batch, t):
    """Base width: the prenet's 4 + 8 conv-GEMMs and 4 weight gradients and
    the duration stack's 2 + 4 and 2 on the TMA-fed kernels, the backward's
    recompute the forward's products; each conv-GEMM's chunks and shares
    the brute force's; a weight gradient's tiles one wave of one block an
    SM at most; every ring within a block."""
    for stack, (fwd, bwd) in _plans(batch, t).items():
        assert (fwd["counts"], bwd["counts"]) == TMA_COUNTS[stack], stack
        n_fwd = len(fwd["products"])
        assert [p["name"] for p in bwd["products"][:n_fwd]] == [p["name"] for p in fwd["products"]]
        for p in bwd["products"]:
            assert p["unit"] == "tma" and p["smem"] <= MAX_BLOCK_SMEM, (stack, p)
            if p["kind"] == "conv_gemm":
                rows, kdim, n = p["shape"]
                taps = 1 if p["name"] in ("proj", "dproj") else (
                    PRENET_TAPS if stack == "prenet" else DP_TAPS)
                assert (p["chunks"], p["shares"]) == _brute_plan(batch, t, kdim // taps, taps,
                                                                 n, SMS), (stack, p)
            else:
                assert 1 <= p["tiles"] <= SMS, (stack, p)


def test_plan_at_the_shipped_batch():
    """At [32, 192] (configs/base.json's batch at the corpus's longest text
    bucket): the 192-column products in three-chunk tiles, the duration
    stack's 256-column conv-GEMMs in two-chunk ones (two 128-wide column
    tiles, where two of 192 would run 384 columns in the same waves), its
    weight gradients in three; split-K halves the K walk of the
    192-column conv-GEMMs (96 tiles, a third of the card's 264 slots), not
    the 256-column ones; the device operations of a call: the prenet's 12
    forward and 37 backward, the duration stack's 5 and 16."""
    plans = _plans(32, 192)
    shares = {stack: {p["name"]: p["shares"] for p in bwd["products"]
                      if p["kind"] == "conv_gemm"} for stack, (_, bwd) in plans.items()}
    assert shares == {
        "prenet": {"conv_0": 2, "conv_1": 2, "conv_2": 2, "proj": 2, "dproj": 2,
                   "transposed_2": 2, "transposed_1": 2, "transposed_0": 2},
        "duration": {"conv_0": 1, "conv_1": 1, "transposed_1": 1, "transposed_0": 2},
    }
    chunks = {stack: {p["name"]: p["chunks"] for p in bwd["products"]}
              for stack, (_, bwd) in plans.items()}
    assert set(chunks["prenet"].values()) == {3}
    assert chunks["duration"] == {"conv_0": 2, "conv_1": 2, "dW_1": 3, "transposed_1": 2,
                                  "dW_0": 3, "transposed_0": 3}
    launches = {stack: [fb["launches"] for fb in plan] for stack, plan in plans.items()}
    assert launches == {"prenet": [12, 37], "duration": [5, 16]}


@pytest.mark.parametrize("h,f", [(16, 32), (48, 48)])
def test_narrow_widths_decline_to_mma(h, f):
    """Below 64 channels or columns a product declines to the mma.sync
    kernels, decided by shape alone: at these widths every one of both
    stacks'."""
    for stack, (fwd, bwd) in _plans(4, 64, h, f).items():
        assert {p["unit"] for p in bwd["products"]} == {"mma"}, stack
        want = {k.replace("_tma", ""): v for k, v in TMA_COUNTS[stack][1].items() if v}
        assert {k: v for k, v in bwd["counts"].items() if v} == want, stack


# each new writer of a bf16 copy: (the values it reads are bf16's, what it
# multiplies the value by before rounding, what the parent chain stored in
# f32 and its mma.sync staging multiplied by)
WRITERS = {
    "xm (mask_rows, x bf16)": (True, "mask", "v * m", "one"),
    "layer outputs (LayerNorm out_masked, kOutM16)": (False, "mask", "v * m", "one"),
    "dpre (LayerNormBwd dx_c)": (False, "one", "v", "one"),
    "dout * mask (mask_rows, dout bf16)": (True, "mask", "v", "mask"),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_a_copy_written_by_its_writer_equals_rounding_at_staging(writer):
    """The writer's copy, bf16(v * m_w), against the mma.sync staging's
    round(stored * m_s) of the value the parent chain stored (f32 x * mask
    and layer outputs times the mask; dpre as it is; dout bf16, staged
    with the mask as a_mask / dy_mask), for sequence masks m of 0 and 1:
    the same bits."""
    bf16_values, mw, stored, ms = WRITERS[writer]
    v = _special_values()
    if bf16_values:  # x and dout are bf16: their values are bf16's
        v = torch.from_numpy(v).to(BF16).float().numpy()
    for m in (np.float32(0.0), np.float32(1.0)):
        pre = v * (m if mw == "mask" else np.float32(1.0))
        copy = torch.from_numpy(pre).to(BF16).view(torch.int16).numpy().view(np.uint16)
        kept = v * m if stored == "v * m" else v
        staged = _rne_bf16_bits(kept * (m if ms == "mask" else np.float32(1.0)))
        np.testing.assert_array_equal(copy, staged)


# ---------------------------------------------------------------------------
# an emulation of the chains' arithmetic
# ---------------------------------------------------------------------------


def _wg_floats(*dims):
    return max(tc_gemm.WALK_WG_FLOATS, int(np.prod(dims)))


def emulate_prenet_fwd(weights, x, mask, p, seed):
    """The bf16 prenet chain (and its backward's recompute): -> out (bf16)
    and what the backward reads."""
    w, b, gamma, beta, wp, bp = (a.detach().float() for a in weights)
    n_layers = w.shape[0]
    taps = w.shape[1] // x.shape[-1]
    xm = [_r(x.float() * mask)]  # mask_rows' bf16 copy
    ln_saves, outs = [], []
    for l in range(n_layers):
        pre = _conv(xm[l], w[l], taps) + b[l]
        y, xh, rstd = _ln(pre, gamma[l], beta[l])
        out = site_dropout(torch.relu(y), seed, l, n_layers, p)
        ln_saves.append((xh, rstd))
        outs.append(out)
        xm.append(_r(out * mask))  # the norm's masked bf16 output
    y = ((x.float() + _conv(xm[-1], wp, 1) + bp) * mask).to(BF16)
    return y, {"xm": xm, "ln": ln_saves, "outs": outs}


def emulate_prenet_bwd(weights, x, mask, dout, p, seed):
    """The bf16 prenet backward: -> (dx, dw, db, dgamma, dbeta, dwp, dbp)
    in the primals' dtypes, and the recompute's saves."""
    w, b, gamma, beta, wp, bp = (a.detach().float() for a in weights)
    n_layers, h = w.shape[0], x.shape[-1]
    taps = w.shape[1] // h
    dscale = drop_args(p)[2]
    _, sv = emulate_prenet_fwd(weights, x, mask, p, seed)
    scratch = _wg_floats(taps, h, h)
    dmasked = dout.float() * mask
    dout16 = _r(dmasked)  # mask_rows' bf16 copy (exact)
    dwp, dbp = _wgrad(sv["xm"][-1], dout16, 1, scratch), dmasked.sum((0, 1))
    dcur = _conv(dout16, wp, 1, w_t=True)
    dw, db = torch.zeros_like(w), torch.zeros_like(b)
    dgamma, dbeta = torch.zeros_like(gamma), torch.zeros_like(beta)
    for l in reversed(range(n_layers)):
        xh, rstd = sv["ln"][l]
        dy = torch.where(sv["outs"][l] > 0, dcur * dscale, 0.0)  # keep and ReLU gate
        dpre = _ln_bwd(dy, xh, rstd, gamma[l])
        dgamma[l], dbeta[l] = (dy * xh).sum((0, 1)), dy.sum((0, 1))
        dpre16 = _r(dpre)  # the norm backward's bf16 copy
        dw[l], db[l] = _wgrad(sv["xm"][l], dpre16, taps, scratch), dpre.sum((0, 1))
        dcur = _conv(dpre16, w[l], taps, -1, w_t=True) * mask
    dx = dcur + dmasked if n_layers else (dcur + dout.float()) * mask
    grads = (dx, dw, db, dgamma, dbeta, dwp, dbp)
    return (tuple(g.reshape(a.shape).to(a.dtype) for g, a in zip(grads, (x, *weights))), sv)


def emulate_duration_fwd(weights, x, mask, p, seed):
    """The bf16 duration-stack chain (and its backward's recompute): -> out
    (bf16) and what the backward reads."""
    f32 = [a.detach().float() for a in weights]
    taps = f32[0].shape[0] // x.shape[-1]
    xm = [_r(x.float() * mask)]
    relus, ln_saves = [], []
    out = None
    for l in range(2):
        w, b, g, be = f32[4 * l:4 * l + 4]
        relu = torch.relu(_conv(xm[l], w, taps) + b.reshape(-1))
        y, xh, rstd = _ln(relu, g, be)
        out = site_dropout(y, seed, l, 2, p)
        relus.append(relu)
        ln_saves.append((xh, rstd))
        if l == 0:
            xm.append(_r(out * mask))
    return out.to(BF16), {"xm": xm, "relu": relus, "ln": ln_saves}


def emulate_duration_bwd(weights, x, mask, dout, p, seed):
    """The bf16 duration-stack backward: -> (dx, dw1, db1, dgamma1, dbeta1,
    dw2, db2, dgamma2, dbeta2) in the primals' dtypes, and the saves."""
    f32 = [a.detach().float() for a in weights]
    c, f = x.shape[-1], f32[0].shape[1]
    taps = f32[0].shape[0] // c
    dscale = drop_args(p)[2]
    _, sv = emulate_duration_fwd(weights, x, mask, p, seed)
    scratch = _wg_floats(taps, max(c, f), f)
    keeps = [regen_keep(seed + torch.arange(x.shape[0], dtype=torch.int64), l, 2,
                        (x.shape[1], f), p) if p > 0 else torch.ones(1) for l in range(2)]
    grads = [None] * 8
    dcur = dout.float()
    for l in (1, 0):
        w, g = f32[4 * l], f32[4 * l + 2]
        xh, rstd = sv["ln"][l]
        dy = dcur * keeps[l] * dscale
        dpre = torch.where(sv["relu"][l] > 0, _ln_bwd(dy, xh, rstd, g), 0.0)
        dpre16 = _r(dpre)
        grads[4 * l:4 * l + 4] = (_wgrad(sv["xm"][l], dpre16, taps, scratch), dpre.sum((0, 1)),
                                  (dy * xh).sum((0, 1)), dy.sum((0, 1)))
        dcur = _conv(dpre16, w, taps, -1, w_t=True) * mask
    return (tuple(gr.reshape(a.shape).to(a.dtype)
                  for gr, a in zip((dcur, *grads), (x, *weights))), sv)


def _text_inputs(width, gen, b=2, t=96):
    lengths = torch.tensor([t, t - 23, 5][:b])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = (torch.randn(b, t, width, generator=gen) * mask).to(BF16)
    return x, mask


def _r_param(gen, *shape, s=1.0, off=0.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen) * s + off).to(dtype)


def test_emulated_prenet_matches_the_plain_bf16_prenet():
    """The prenet emulation at base width (h 192, 3 layers of 5 taps; [2,
    96], one sample ragged; dropout 0.5; every product on the TMA-fed units
    by the plan, split-K) against prenet_plain_bf16 and its autograd at the
    emulation's ReLU gates: out, dx and every weight's gradient within 2e-2
    of its max |ref|, in the plain version's dtypes."""
    gen = torch.Generator().manual_seed(0)
    h, L, taps = BASE_H, PRENET_L, PRENET_TAPS
    x, mask = _text_inputs(h, gen)
    weights = (_r_param(gen, L, taps * h, h, s=(taps * h) ** -0.5, dtype=BF16),
               _r_param(gen, L, h, s=0.1), _r_param(gen, L, h, s=0.1, off=1.0),
               _r_param(gen, L, h, s=0.1), _r_param(gen, h, h, s=h ** -0.5, dtype=BF16),
               _r_param(gen, 1, h, s=0.1))
    dout = torch.randn(*x.shape, generator=gen).to(BF16)
    cfg = (0.5, 11)
    b, t, _ = x.shape
    plan = tc_gemm.bf16_prenet_products(b, t, h, L, taps, SMS, backward=True)
    assert {p["unit"] for p in plan["products"]} == {"tma"}
    assert any(p.get("shares", 1) > 1 for p in plan["products"])
    out, _ = emulate_prenet_fwd(weights, x, mask, *cfg)
    _held("out", out, text_cuda.prenet_plain_bf16(weights, x, mask, *cfg))
    assert out.dtype == BF16
    grads, sv = emulate_prenet_bwd(weights, x, mask, dout, *cfg)
    ref = text_cuda.prenet_bwd_plain(weights, x, mask, dout, *cfg,
                                     gates=[o > 0 for o in sv["outs"]])
    for i, (got, want) in enumerate(zip(grads, ref)):
        assert got.dtype == want.dtype, i
        _held(f"grad [{i}]", got, want)


def test_emulated_duration_stack_matches_the_plain_bf16_stack():
    """The duration-stack emulation at base width (192 channels, f 256, 2
    layers of 3 taps; [2, 96]; dropout 0.1; the products on the TMA-fed
    units, the last transposed conv split-K) against
    duration_stack_plain_bf16 and its autograd at the emulation's ReLU
    gates, within 2e-2 of each output's max |ref|."""
    gen = torch.Generator().manual_seed(1)
    c, f, taps = BASE_H, DP_F, DP_TAPS
    x, mask = _text_inputs(c, gen)
    weights = (_r_param(gen, taps * c, f, s=(taps * c) ** -0.5, dtype=BF16),
               _r_param(gen, 1, f, s=0.1), _r_param(gen, 1, f, s=0.1, off=1.0),
               _r_param(gen, 1, f, s=0.1),
               _r_param(gen, taps * f, f, s=(taps * f) ** -0.5, dtype=BF16),
               _r_param(gen, 1, f, s=0.1), _r_param(gen, 1, f, s=0.1, off=1.0),
               _r_param(gen, 1, f, s=0.1))
    dout = torch.randn(x.shape[0], x.shape[1], f, generator=gen).to(BF16)
    cfg = (0.1, 12)
    plan = tc_gemm.bf16_duration_products(x.shape[0], x.shape[1], c, f, taps, SMS, True)
    assert {p["unit"] for p in plan["products"]} == {"tma"}
    out, _ = emulate_duration_fwd(weights, x, mask, *cfg)
    _held("out", out, text_cuda.duration_stack_plain_bf16(weights, x, mask, *cfg))
    grads, sv = emulate_duration_bwd(weights, x, mask, dout, *cfg)
    ref = text_cuda.duration_stack_bwd_plain(weights, x, mask, dout, *cfg,
                                             gates=[r > 0 for r in sv["relu"]])
    for i, (got, want) in enumerate(zip(grads, ref)):
        assert got.dtype == want.dtype, i
        _held(f"grad [{i}]", got, want)


class _Emulated(torch.autograd.Function):
    """An emulated stack (``fwd``, ``bwd``) as its autograd Function."""

    @staticmethod
    def forward(ctx, fns, x, mask, *weights):
        ctx.fns = fns
        ctx.save_for_backward(x, mask, *weights)
        return fns[0](weights, x, mask, 0.0, 0)[0]

    @staticmethod
    def backward(ctx, dout):
        x, mask, *weights = ctx.saved_tensors
        grads, _ = ctx.fns[1](weights, x, mask, dout, 0.0, 0)
        return (None, grads[0], None, *grads[1:])


# the narrowest width every product of both stacks takes the TMA-fed units at
TMA_H = 64


def test_emulated_prenet_within_half_of_jax_gap():
    """The prenet emulation at h 64 (3 layers of 5 taps: every product on
    the TMA-fed units by the plan) against the JAX prenet kernel in bf16
    (interpret mode): output, dx and the six weight gradients within half
    of JAX's own bf16-vs-f32 gap (test_torch_bf16's measure)."""
    h = TMA_H
    assert tc_gemm.bf16_prenet_products(3, 17, h, 3, 5, SMS, True)["counts"] \
        == TMA_COUNTS["prenet"][1]
    rng = np.random.default_rng(1)
    weights = _weights(rng, [((3, 5 * h, h), (5 * h) ** -0.5, 0.0), ((3, h), 0.1, 0.0),
                             ((3, h), 0.1, 1.0), ((3, h), 0.1, 0.0), ((h, h), h ** -0.5, 0.0),
                             ((1, h), 0.1, 0.0)])
    x, mask = _inputs(17, h)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    fn = tp._make_prenet_fn(tp._TextKey((3, _offsets(5, 1), None, 1.0), True))
    jb, jf = _jax_vjp(fn, weights, x, mask, cot, (0, 4))
    fns = (emulate_prenet_fwd, emulate_prenet_bwd)
    port = _port_vjp(lambda w, xx, m: _Emulated.apply(fns, xx, m, *w), weights, x, mask, cot,
                     (0, 4))
    assert _held_all("prenet emulated", port, jb, jf) < 0.5


def test_emulated_duration_stack_within_half_of_jax_gap():
    """The duration-stack emulation at 64 channels and f 64 (every product
    on the TMA-fed units) against the JAX stack kernel in bf16 (interpret
    mode): output, dx and the eight weight gradients within half of JAX's
    bf16-vs-f32 gap."""
    c = f = TMA_H
    assert tc_gemm.bf16_duration_products(3, 24, c, f, 3, SMS, True)["counts"] \
        == TMA_COUNTS["duration"][1]
    rng = np.random.default_rng(2)
    weights = _weights(rng, [((3 * c, f), (3 * c) ** -0.5, 0.0), ((1, f), 0.1, 0.0),
                             ((1, f), 0.1, 1.0), ((1, f), 0.1, 0.0),
                             ((3 * f, f), (3 * f) ** -0.5, 0.0), ((1, f), 0.1, 0.0),
                             ((1, f), 0.1, 1.0), ((1, f), 0.1, 0.0)])
    x, mask = _inputs(24, c)
    cot = rng.standard_normal((3, 24, f)).astype(np.float32)
    fn = tp._make_dp_fn(tp._TextKey((2, _offsets(3, 1), None, 1.0), True))
    jb, jf = _jax_vjp(fn, weights, x, mask, cot, (0, 4))
    fns = (emulate_duration_fwd, emulate_duration_bwd)
    port = _port_vjp(lambda w, xx, m: _Emulated.apply(fns, xx, m, *w), weights, x, mask, cot,
                     (0, 4))
    assert _held_all("duration_stack emulated", port, jb, jf) < 0.5

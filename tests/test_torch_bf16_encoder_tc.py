"""The text encoder layer's bf16 chains on the TMA-fed wgmma products and
the m16n8k16 attention cores (bf16 rows 2 and 13: ``gtt_encoder_layer_bf16``,
``gtt_encoder_layer_bwd_bf16``), on the CPU.

* The plan (``tc_gemm.bf16_encoder_products``, the plain version of the
  chains' dispatch in ``csrc/bf16_gemm.cu``): at [32, 192] and at [16, t]
  for t of 64 to 192 (and a ragged 93) every product on the TMA-fed units,
  each conv-GEMM's chunks and split-K shares those of fewest waves x
  slices (against a brute force over every pair the limits allow), the
  rings within a block's 232,448 bytes; at narrow widths every product on
  the mma.sync kernels, by shape alone; the device operations of a call.
* A bf16 copy written by the kernel that produces the operand (rounded
  once, masked where the product reads it masked) holds the bits that the
  mma.sync kernels' staging made from the f32 value (``load8``: round(v *
  m)), for each new writer, with ties and subnormals.
* An emulation of the chains' arithmetic: every product of bf16 operands in
  64-deep K slices summed in f32 and split into the plan's shares added in
  order (32-deep on the mma.sync kernels), the weight gradients' 64-row
  slices split as the plan splits them, the attention core's two passes
  (the rows' max and sum, then the final probabilities rounded for p.v, as
  JAX rounds them, over two key groups of 32-key tiles), its products in
  m16n8k16's 16-deep steps,
  ds and pd stored bf16, each f32 cotangent read through its bf16 copy and
  the bias and norm sums of the unrounded values.  Against
  ``encoder_layer_plain_bf16`` and its autograd at base width with dropout
  on (2e-2 of each output's max, the kernels' tolerance against their
  plain version), and against the JAX package's layer kernel in bf16
  (interpret mode, pack 1) within half of JAX's own bf16-vs-f32 gap.
"""

import math

import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import encoder_pallas as ep
from glow_tts_train_tpu.ops.wn_pallas import _offsets
from glow_tts_train_tpu_torch.ops import encoder_cuda, tc_gemm
from glow_tts_train_tpu_torch.ops.tc_gemm import im2col_plain, transposed_weights_plain
from glow_tts_train_tpu_torch.ops.wn_cuda import drop_args, regen_keep, site_dropout

from test_torch_bf16 import (F_ENC, H, HEADS, TAPS, WINDOW, _held_all, _inputs, _jax_vjp,
                             _port_vjp, _weights)
from test_torch_bf16_tc import _rne_bf16_bits

BF16 = torch.bfloat16
SMS = 132  # the H100's streaming multiprocessors
MAX_BLOCK_SMEM = 232448
BASE_H, BASE_F, BASE_TAPS = 192, 768, 3


def _brute_plan(batch, t, c_in, taps, n, sms):
    """Every (chunks, shares) pair the text chains' limits allow and its
    waves of two blocks an SM times 64-deep slices a block; the least cost,
    ties to the fewest columns past n in the last column tile, then more
    chunks, then fewer shares."""
    steps = taps * math.ceil(c_in / 64)
    row_tiles = batch * math.ceil(t / 64)
    found = []
    for chunks in range(1, min(3, math.ceil(n / 64)) + 1):
        tiles = row_tiles * math.ceil(n / (64 * chunks))
        pad = math.ceil(n / (64 * chunks)) * 64 * chunks - n
        for shares in range(1, tc_gemm.TMA_MAX_SHARES + 1):
            per = math.ceil(steps / shares)
            if math.ceil(steps / per) != shares:
                continue
            if shares > 1 and (per < tc_gemm.TMA_MIN_SLICES or shares * n > tc_gemm.TMA_SPLIT_COLS):
                continue
            found.append((math.ceil(tiles * shares / (2 * sms)) * per, pad, -chunks, shares))
    cost, pad, neg_chunks, shares = min(found)
    return -neg_chunks, shares


@pytest.mark.parametrize("batch,t", [(32, 192), (16, 64), (16, 96), (16, 128), (16, 192),
                                     (32, 93)])
def test_every_product_takes_the_tma_units(batch, t):
    """Base width (h 192, f 768, taps 3): the forward's 4 conv-GEMMs and the
    backward's 8 and 4 weight gradients on the TMA-fed kernels, each
    conv-GEMM's chunks and shares the brute force's; a weight gradient's
    tiles one wave of one block an SM at most; every ring within a block."""
    fwd = tc_gemm.bf16_encoder_products(batch, t, BASE_H, BASE_F, BASE_TAPS, SMS)
    bwd = tc_gemm.bf16_encoder_products(batch, t, BASE_H, BASE_F, BASE_TAPS, SMS, backward=True)
    assert fwd["counts"] == {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 4,
                             "bf16_tma_wgrad": 0}
    assert bwd["counts"] == {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 8,
                             "bf16_tma_wgrad": 4}
    assert [p["name"] for p in bwd["products"][:4]] == [p["name"] for p in fwd["products"]]
    for p in bwd["products"]:
        assert p["unit"] == "tma" and p["smem"] <= MAX_BLOCK_SMEM, p
        if p["kind"] == "conv_gemm":
            rows, kdim, n = p["shape"]
            taps = BASE_TAPS if kdim in (BASE_TAPS * BASE_H, BASE_TAPS * BASE_F) else 1
            assert (p["chunks"], p["shares"]) == _brute_plan(batch, t, kdim // taps, taps, n,
                                                             SMS), p
        else:
            assert 1 <= p["tiles"] <= SMS, p


def test_plan_at_the_shipped_batch():
    """At [32, 192] (configs/base.json's batch at the corpus's longest text
    bucket): every product in three-chunk tiles; split-K halves the K walk
    of the 192-column conv-GEMMs (96 tiles, a third of the card's 264
    slots), not the 576- and 768-column ones (their partial sums past
    TMA_SPLIT_COLS a row); 10 device operations a forward call and 33 a
    backward call, as the card's traces count them
    (``scripts/torch-bf16-encoder-ab.py``)."""
    fwd = tc_gemm.bf16_encoder_products(32, 192, BASE_H, BASE_F, BASE_TAPS, SMS)
    bwd = tc_gemm.bf16_encoder_products(32, 192, BASE_H, BASE_F, BASE_TAPS, SMS, backward=True)
    shares = {p["name"]: p["shares"] for p in bwd["products"] if p["kind"] == "conv_gemm"}
    assert shares == {"qkv": 1, "out_proj": 2, "ffn1": 1, "ffn2": 2, "dffn": 1, "dx1": 2,
                      "datt": 2, "dx": 2}
    assert all(p["chunks"] == 3 for p in bwd["products"])
    assert fwd["launches"] == 10 and bwd["launches"] == 33


@pytest.mark.parametrize("h,f", [(16, 32), (48, 96)])
def test_narrow_widths_decline_to_mma(h, f):
    """Below 64 channels or columns (or channels that are not whole 64-wide
    boxes under taps, for a weight gradient) a product declines to the
    mma.sync kernels, decided by shape alone: at these widths every one."""
    bwd = tc_gemm.bf16_encoder_products(4, 64, h, f, 3, SMS, backward=True)
    assert {p["unit"] for p in bwd["products"]} == {"mma"}
    assert bwd["counts"] == {"bf16_gemm": 8, "bf16_wgrad": 4, "bf16_tma_gemm": 0,
                             "bf16_tma_wgrad": 0}


def _special_values():
    """f32 values whose bf16 rounding is a tie (to even and to odd), just
    off one, subnormal (every bf16 subnormal's upper half, both signs),
    signed zero or large."""
    rng = np.random.default_rng(0)
    upper = np.concatenate([rng.integers(0, 1 << 16, size=2048, dtype=np.uint64),
                            np.arange(128, dtype=np.uint64),
                            np.arange(0x8000, 0x8080, dtype=np.uint64)])
    low = np.array([0x0000, 0x7FFF, 0x8000, 0x8001, 0xFFFF], dtype=np.uint64)
    v = (upper[:, None] << 16 | low[None, :]).ravel().astype(np.uint32).view(np.float32)
    v = v[np.isfinite(v) & (np.abs(v) < 3e38)]
    assert (np.abs(v) < 1.2e-38).sum() > 500
    return v


# each new writer of a bf16 copy: (what it multiplies the f32 value by before
# rounding, what the mma.sync staging multiplied the stored value by)
WRITERS = {
    "xm (mask_rows_bf16_kernel, x bf16)": ("mask", "mask"),
    "a_in (LayerNorm out_masked)": ("mask", "one"),
    "dconv2, dy (LayerNormBwd dx2_c)": ("mask", "one"),
    "rm (kBiasReluMask out_c)": ("mask", "one"),
    "dpre (kMaskReluBwd out_c)": ("mask", "one"),
    "dout_h (kBias out_c)": ("one", "one"),
    "heads' outputs (attention_bf16_kernel)": ("one", "one"),
    "dM (attn_bwd_products_bf16_kernel)": ("one", "one"),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_a_copy_written_by_its_writer_equals_rounding_at_staging(writer):
    """The writer's copy, bf16(v * m_w), against the mma.sync staging's
    round(stored * m_s) of the value the chain stored before (f32 v * m_w;
    xm: the bf16 x itself, times its a_mask), for sequence masks m of 0
    and 1: the same bits."""
    mw, ms = WRITERS[writer]
    v = _special_values()
    if writer.startswith("xm"):  # x is bf16: its values are bf16's
        v = torch.from_numpy(v).to(BF16).float().numpy()
    for m in (np.float32(0.0), np.float32(1.0)):
        pre = v * (m if mw == "mask" else np.float32(1.0))
        copy = torch.from_numpy(pre).to(BF16).view(torch.int16).numpy().view(np.uint16)
        stored = v if writer.startswith("xm") else pre
        staged = _rne_bf16_bits(stored * (m if ms == "mask" else np.float32(1.0)))
        np.testing.assert_array_equal(copy, staged)


# ---------------------------------------------------------------------------
# an emulation of the chains' arithmetic
# ---------------------------------------------------------------------------


def _r(t):
    """round to bf16, kept in f32"""
    return t.to(BF16).float()


def _steps(a, b, step):
    """a [..., K] @ b [K, N] as an mma's accumulator takes it: ``step``-deep
    partial products added in order."""
    acc = None
    for k0 in range(0, a.shape[-1], step):
        part = a[..., k0:k0 + step] @ b[k0:k0 + step]
        acc = part if acc is None else acc + part
    return acc


def _conv(a, w, taps, tap_sign=1, w_t=False):
    """A text chain's conv-GEMM of a [b, t, c_in] (bf16 values) by its plan:
    on the TMA-fed kernel 64-deep K slices (tap outer, channels inner) in
    the plan's shares, each summed in f32, the shares added in order; on the
    mma.sync kernel 32-deep slices over the whole walk."""
    batch, t, c_in = a.shape
    if w_t:
        w = transposed_weights_plain(w, taps)
    cols = im2col_plain(a, taps, 1, tap_sign)
    n = w.shape[1]
    chunks, shares = tc_gemm.bf16_text_conv_plan(batch, t, c_in, taps, n, SMS, w_t=w_t)
    if not chunks:
        return _steps(cols, w, 32)
    kdim = cols.shape[-1]
    per = math.ceil(math.ceil(kdim / 64) / shares) * 64
    total = None
    for k0 in range(0, kdim, per):
        part = _steps(cols[..., k0:k0 + per], w[k0:k0 + per], 64)
        total = part if total is None else total + part
    return total


def _wgrad(a, dy, taps, scratch_floats):
    """A text chain's weight gradient of a [b, t, c_in] and dy [b, t, n]
    (bf16 values): on the TMA-fed kernel each sample's rows in 64-row
    slices, the slices in order within the plan's row splits, the splits'
    sums added in split order; on the mma.sync kernel 32-row slices."""
    batch, t, c_in = a.shape
    n = dy.shape[-1]
    cols = im2col_plain(a, taps)
    chunks, splits = tc_gemm.bf16_wgrad_plan(batch, t, c_in, taps, n, c_in, SMS, scratch_floats)
    rows = 64 if chunks else 32
    slices = [(b, t0) for b in range(batch) for t0 in range(0, t, rows)]
    splits = splits if chunks else 1
    out = torch.zeros(cols.shape[-1], n)
    for s in range(splits):
        part = torch.zeros_like(out)
        for b, t0 in slices[len(slices) * s // splits:len(slices) * (s + 1) // splits]:
            part = part + cols[b, t0:t0 + rows].T @ dy[b, t0:t0 + rows]
        out = out + part
    return out


def _ln(x, g, b):
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + 1e-4)
    xh = (x - mean) * rstd
    return xh * g + b, xh, rstd


def _ln_bwd(dy, xh, rstd, g):
    gg = dy * g
    return (gg - gg.mean(-1, keepdim=True) - xh * (gg * xh).mean(-1, keepdim=True)) * rstd


def _band(t, window):
    """[t, t] offsets j - i + w and whether they lie on the band."""
    off = torch.arange(t)[None, :] - torch.arange(t)[:, None] + window
    return off, (off >= 0) & (off <= 2 * window)


def _attention_fwd(qkv, mask, rel_k, rel_v, n_heads, window, p, seed):
    """attention_bf16_kernel: per (sample, head) the scores' row max and sum
    (pass 1), then the final probabilities p = exp(s - m) / l, dropped and
    rounded, times v in 16-key steps (pass 2: key group g takes the 32-key
    tiles g, g + 2, ..., the two groups' sums added); the band terms of the
    dropped f32 probabilities.  -> the heads' outputs [b, t, h] (f32), the
    row max and inverse row sum [b, heads, t]."""
    batch, t, h3 = qkv.shape
    h = h3 // 3
    d = h // n_heads
    scale = 1.0 / math.sqrt(d)
    drop, _, dscale = drop_args(p)
    seeds = seed + torch.arange(batch, dtype=torch.int64)
    off, in_band = _band(t, window)
    out = torch.zeros(batch, t, h)
    stat_m, stat_linv = torch.zeros(batch, n_heads, t), torch.zeros(batch, n_heads, t)
    for hd in range(n_heads):
        keep = regen_keep(seeds, hd, n_heads + 3, (t, t), p) * dscale if drop else None
        for b in range(batch):
            q, k, v = (qkv[b, :, i * h + hd * d:i * h + (hd + 1) * d] for i in range(3))
            qrel = q @ rel_k.T
            mrow = mask[b, :, 0] != 0
            attend = mrow[:, None] & mrow[None, :]
            scores = _steps(q, k.T, 16) * scale
            band = torch.where(in_band, qrel.gather(1, off.clamp(0, 2 * window)), 0.0)
            scores = scores + band * scale
            scores = torch.where(attend, scores, torch.full_like(scores, -1e4))
            m = scores.max(1).values
            e = torch.exp(scores - m[:, None])
            denom = e.sum(1)
            prob = e / denom[:, None]
            if drop:
                prob = prob * keep[b]
            prob16 = _r(prob)
            acc = None
            for kg in (0, 1):
                part = torch.zeros(t, d)
                for k0 in range(32 * kg, t, 64):
                    for s0 in range(k0, min(k0 + 32, t), 16):
                        keys = slice(s0, min(s0 + 16, t))
                        part = part + prob16[:, keys] @ v[keys]
                acc = part if acc is None else acc + part
            band_p = torch.zeros(t, 2 * window + 1).scatter_add_(
                1, off.clamp(0, 2 * window), torch.where(in_band, prob, 0.0))
            out[b, :, hd * d:(hd + 1) * d] = acc + band_p @ rel_v
            stat_m[b, hd], stat_linv[b, hd] = m, 1.0 / denom
    return out, stat_m, stat_linv


def _attention_bwd(qkv, mask, rel_k, rel_v, att, datt, stat_m, stat_linv, n_heads, window, p,
                   seed):
    """The score pass (pd and ds from the forward's statistics, dsum =
    dout . out of the f32 values, both stored bf16; the band sums dqrel =
    ds * scale and pb of the rounded pd), the products kernel (ds.k, ds^T.q,
    pd^T.dout of bf16 operands in 16-deep steps) and the tables' gradients
    -> dqkv [b, t, 3h] f32, d rel_k, d rel_v (f32)."""
    batch, t, h3 = qkv.shape
    h = h3 // 3
    d = h // n_heads
    scale = 1.0 / math.sqrt(d)
    drop, _, dscale = drop_args(p)
    seeds = seed + torch.arange(batch, dtype=torch.int64)
    off, in_band = _band(t, window)
    idx = off.clamp(0, 2 * window)
    nb = 2 * window + 1
    dqkv = torch.zeros(batch, t, 3 * h)
    drk, drv = torch.zeros(nb, d), torch.zeros(nb, d)
    datt16 = _r(datt)
    for hd in range(n_heads):
        keep = regen_keep(seeds, hd, n_heads + 3, (t, t), p) * dscale if drop else None
        for b in range(batch):
            cols = slice(hd * d, (hd + 1) * d)
            q, k, v = (qkv[b, :, i * h + hd * d:i * h + (hd + 1) * d] for i in range(3))
            dout, dout16 = datt[b, :, cols], datt16[b, :, cols]
            mrow = mask[b, :, 0] != 0
            attend = mrow[:, None] & mrow[None, :]
            s = _steps(q, k.T, 16) * scale
            s = s + torch.where(in_band, (q @ rel_k.T).gather(1, idx), 0.0) * scale
            s = torch.where(attend, s, torch.full_like(s, -1e4))
            prob = torch.exp(s - stat_m[b, hd][:, None]) * stat_linv[b, hd][:, None]
            ks = keep[b] if drop else torch.ones(t, t)
            pd = prob * ks
            dpd = _steps(dout16, v.T, 16)
            dpd = dpd + torch.where(in_band, (dout @ rel_v.T).gather(1, idx), 0.0)
            dsum = (dout * att[b, :, cols]).sum(1)
            ds = torch.where(attend, prob * (dpd * ks - dsum[:, None]), 0.0)
            ds16, pd16 = _r(ds), _r(pd)

            def band_sum(m):
                return torch.zeros(t, nb).scatter_add_(1, idx, torch.where(in_band, m, 0.0))

            dqrel, pb = band_sum(ds) * scale, band_sum(pd16)
            dqkv[b, :, cols] = _steps(ds16, k, 16) * scale + dqrel @ rel_k
            dqkv[b, :, h + hd * d:h + (hd + 1) * d] = _steps(ds16.T, q, 16) * scale
            dqkv[b, :, 2 * h + hd * d:2 * h + (hd + 1) * d] = _steps(pd16.T, dout16, 16)
            drk += dqrel.T @ q
            drv += pb.T @ dout
    return dqkv, drk, drv


def emulate_fwd(weights, x, mask, n_heads, window, p, seed):
    """The bf16 forward chain (and the backward's recompute): -> out (bf16)
    and what the backward reads."""
    (wqkv, bqkv, wo, bo, rel_k, rel_v, g1, be1, g2, be2, w1, c1, w2, c2) = (
        a.detach().float() for a in weights)
    h = x.shape[-1]
    taps = w1.shape[0] // h
    n_sites = n_heads + 3

    def sdrop(a, site):
        return site_dropout(a, seed, site, n_sites, p)

    xm = _r(x.float() * mask)
    qkv = _r(_conv(xm, wqkv, 1) + bqkv)
    att, stat_m, stat_linv = _attention_fwd(qkv, mask, rel_k, rel_v, n_heads, window, p, seed)
    att16 = _r(att)
    y = sdrop(_conv(att16, wo, 1) + bo, n_heads)
    x1, xh1, rstd1 = _ln(xm + y, g1, be1)
    a_in = _r(x1 * mask)
    ffn = sdrop(torch.relu(_conv(a_in, w1, taps) + c1), n_heads + 1) * mask
    rm = _r(ffn)
    y2 = sdrop((_conv(rm, w2, taps) + c2) * mask, n_heads + 2)
    out, xh2, rstd2 = _ln(x1 + y2, g2, be2)
    saved = {"xm": xm, "qkv": qkv, "att": att, "att16": att16, "stat_m": stat_m,
             "stat_linv": stat_linv, "xh1": xh1, "rstd1": rstd1, "a_in": a_in, "ffn": ffn,
             "rm": rm, "xh2": xh2, "rstd2": rstd2}
    return out.to(BF16), saved


def emulate_bwd(weights, x, mask, dout, n_heads, window, p, seed):
    """The bf16 backward chain: -> (dx, *the 14 weights' gradients), bf16
    where the weight is, the bias and norm gradients f32."""
    f32 = [a.detach().float() for a in weights]
    (wqkv, bqkv, wo, bo, rel_k, rel_v, g1, be1, g2, be2, w1, c1, w2, c2) = f32
    h = x.shape[-1]
    f = w1.shape[1]
    taps = w1.shape[0] // h
    n_sites = n_heads + 3
    scratch = max(tc_gemm.WALK_WG_FLOATS, taps * h * f)
    dscale = drop_args(p)[2]
    _, sv = emulate_fwd(weights, x, mask, n_heads, window, p, seed)
    dout = dout.float()

    def sdrop(a, site):
        return site_dropout(a, seed, site, n_sites, p)

    da = _ln_bwd(dout, sv["xh2"], sv["rstd2"], g2)
    dg2, dbe2 = (dout * sv["xh2"]).sum((0, 1)), dout.sum((0, 1))
    db = sdrop(da, n_heads + 2) * mask
    db16 = _r(db)
    dw2, dc2 = _wgrad(sv["rm"], db16, taps, scratch), db.sum((0, 1))
    dffn = torch.where(sv["ffn"] > 0, _conv(db16, w2, taps, -1, w_t=True) * mask * dscale, 0.0)
    dffn16 = _r(dffn)
    dw1, dc1 = _wgrad(sv["a_in"], dffn16, taps, scratch), dffn.sum((0, 1))
    dx1 = _conv(dffn16, w1, taps, -1, w_t=True) * mask + da
    dg1, dbe1 = (dx1 * sv["xh1"]).sum((0, 1)), dx1.sum((0, 1))
    da1 = _ln_bwd(dx1, sv["xh1"], sv["rstd1"], g1)
    dc = sdrop(da1, n_heads)
    dc16 = _r(dc)
    dwo, dbo = _wgrad(sv["att16"], dc16, 1, scratch), dc.sum((0, 1))
    datt = _conv(dc16, wo, 1, w_t=True)
    dqkv, drk, drv = _attention_bwd(sv["qkv"], mask, rel_k, rel_v, sv["att"], datt, sv["stat_m"],
                                    sv["stat_linv"], n_heads, window, p, seed)
    dqkv16 = _r(dqkv)
    dwqkv, dbqkv = _wgrad(sv["xm"], dqkv16, 1, scratch), dqkv.sum((0, 1))
    dx = ((da1 + _conv(dqkv16, wqkv, 1, w_t=True)) * mask).to(BF16)
    grads = (dwqkv, dbqkv, dwo, dbo, drk, drv, dg1, dbe1, dg2, dbe2, dw1, dc1, dw2, dc2)
    return (dx, *(g.reshape(w.shape).to(w.dtype) for g, w in zip(grads, weights))), sv


def _base_layer(seed=0, b=2, t=96):
    gen = torch.Generator().manual_seed(seed)
    h, f, window = BASE_H, BASE_F, 4
    d = h // 2
    lengths = torch.tensor([t, t - 23, 5][:b])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = (torch.randn(b, t, h, generator=gen) * mask).to(BF16)

    def r(*shape, s=1.0, off=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * s + off).to(dtype)

    weights = (r(h, 3 * h, s=h ** -0.5, dtype=BF16), r(1, 3 * h, s=0.1),
               r(h, h, s=h ** -0.5, dtype=BF16), r(1, h, s=0.1),
               r(2 * window + 1, d, s=d ** -0.5, dtype=BF16),
               r(2 * window + 1, d, s=d ** -0.5, dtype=BF16),
               r(1, h, s=0.1, off=1.0), r(1, h, s=0.1), r(1, h, s=0.1, off=1.0), r(1, h, s=0.1),
               r(BASE_TAPS * h, f, s=(BASE_TAPS * h) ** -0.5, dtype=BF16), r(1, f, s=0.1),
               r(BASE_TAPS * f, h, s=(BASE_TAPS * f) ** -0.5, dtype=BF16), r(1, h, s=0.1))
    dout = torch.randn(b, t, h, generator=gen).to(BF16)
    return weights, x, mask, dout, (2, window, 0.1, 17)


def _held(name, got, ref, rtol=2e-2):
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    assert scale > 0, name
    err = (got - ref).abs().max().item()
    assert err <= rtol * scale, f"{name}: {err} vs max |ref| {scale}"


def test_emulated_chains_match_the_plain_bf16_layer():
    """The emulation at base width (h 192, f 768, taps 3, 2 heads, window 4;
    [2, 96], one sample ragged; dropout 0.1; its products on the TMA-fed
    units by the plan, split-K in most) against encoder_layer_plain_bf16
    and its autograd at the emulation's ReLU gates: out, dx and every
    weight's gradient within 2e-2 of its max |ref|, in the plain version's
    dtypes."""
    weights, x, mask, dout, cfg = _base_layer()
    b, t, h = x.shape
    plan = tc_gemm.bf16_encoder_products(b, t, h, BASE_F, BASE_TAPS, SMS, backward=True)
    assert {p["unit"] for p in plan["products"]} == {"tma"}
    assert any(p.get("shares", 1) > 1 for p in plan["products"])
    out, _ = emulate_fwd(weights, x, mask, *cfg)
    _held("out", out, encoder_cuda.encoder_layer_plain_bf16(weights, x, mask, *cfg))
    assert out.dtype == BF16
    grads, sv = emulate_bwd(weights, x, mask, dout, *cfg)
    ref = encoder_cuda.encoder_layer_bwd_plain(weights, x, mask, dout, *cfg,
                                               gates=[sv["ffn"] > 0])
    for i, (got, want) in enumerate(zip(grads, ref)):
        assert got.dtype == want.dtype, i
        _held(f"grad [{i}]", got, want)


class _EmulatedLayer(torch.autograd.Function):
    """The emulated chains as the layer's autograd Function (the 14-tuple)."""

    @staticmethod
    def forward(ctx, x, mask, cfg, *weights):
        ctx.cfg = cfg
        ctx.save_for_backward(x, mask, *weights)
        return emulate_fwd(weights, x, mask, *cfg)[0]

    @staticmethod
    def backward(ctx, dout):
        x, mask, *weights = ctx.saved_tensors
        grads, _ = emulate_bwd(weights, x, mask, dout, *ctx.cfg)
        return (grads[0], None, None, *grads[1:])


def test_emulated_chains_within_half_of_jax_gap():
    """The emulation (the JAX test's widths: h 32, f 64, 2 heads, window 4,
    taps 3: every product on the mma.sync kernels by the plan) through the
    merged Q/K/V weights against the JAX layer kernel in bf16 (interpret
    mode, pack 1): output, dx and the 18 weight gradients within half of
    JAX's own bf16-vs-f32 gap (test_torch_bf16's measure; the key bias's
    gradient, zero up to round-off, left out)."""
    rng = np.random.default_rng(3)
    d = H // HEADS
    proj = [s for _ in range(4) for s in (((H, H), H ** -0.5, 0.0), ((1, H), 0.1, 0.0))]
    weights = _weights(rng, proj + [
        ((2 * WINDOW + 1, d), d ** -0.5, 0.0), ((2 * WINDOW + 1, d), d ** -0.5, 0.0),
        ((1, H), 0.1, 1.0), ((1, H), 0.1, 0.0), ((1, H), 0.1, 1.0), ((1, H), 0.1, 0.0),
        ((TAPS * H, F_ENC), (TAPS * H) ** -0.5, 0.0), ((1, F_ENC), 0.1, 0.0),
        ((TAPS * F_ENC, H), (TAPS * F_ENC) ** -0.5, 0.0), ((1, H), 0.1, 0.0)])
    bf16_idx = (0, 2, 4, 6, 8, 9, 14, 16)
    x, mask = _inputs(20, H)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    st = (HEADS, WINDOW, _offsets(TAPS, 1), None, 1.0, 1)
    with ep.force_pack(1):
        fn = ep._make_layer_fn(ep._EncKey(st, True))
        jb, jf = _jax_vjp(fn, weights, x, mask, cot, bf16_idx)

    def emulated(w, xx, m):
        w14 = encoder_cuda.merge_qkv(w)
        return _EmulatedLayer.apply(xx, m, (HEADS, WINDOW, 0.0, 0), *w14)

    port = _port_vjp(emulated, weights, x, mask, cot, bf16_idx)
    # [out, dx, dwq, dbq, dwk, dbk, ...]: the key bias's gradient is zero up
    # to round-off (softmax over keys is invariant to q . b_k)
    port, jb, jf = ([a for i, a in enumerate(r) if i != 5] for r in (port, jb, jf))
    assert _held_all("encoder_layer emulated", port, jb, jf) < 0.5

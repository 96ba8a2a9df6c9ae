"""The flow block's bf16 chains on the TMA-fed wgmma products (bf16 rows 10
and 12: ``gtt_block_fwd_save_bf16``, ``gtt_block_bwd_store_bf16``), on the
CPU.

* The plan (``tc_gemm.bf16_block_products``, the plain version of the
  chains' dispatch in ``csrc/bf16_gemm.cu``): at [32, 704] and [16, 704]
  at base width and at large width (h 256) every product but the folded A
  on the TMA-fed units, at narrow widths none of them (the mma.sync
  kernels); 14 and 36 device operations a call at base width (what the
  card's traces count); the ring's shared memory within a block's 232,448
  bytes.
* Rounding an f32 cotangent once where it is written (masked where its
  product has an ``a_mask``) gives the bits the mma.sync kernels' staging
  gives (``load8``: round(v * m)), for values with ties and subnormals.
* An emulation of the new chains' arithmetic (every product of bf16
  operands in 64-deep K slices summed in f32, each f32 cotangent read
  through its bf16 copy, the bias gradients f32 sums of the unrounded
  cotangents by 64-row tile, then by sample (``tc_gemm.tile_sums_plain``),
  a weight gradient's 64-row slices added split by split as the plan
  splits them) against ``block_forward_plain_bf16`` and its
  autograd at base width with dropout on (within 2e-2 of each output's
  max |ref|, the kernels' tolerance against their plain version), and,
  through ``fold_block_params``, against the JAX package's
  ``block_pallas.flow_block_fused`` with x bf16 (its Pallas kernels in
  interpret mode, store residuals: ``_block_fwd_save_kernel`` and
  ``_block_bwd_store_kernel``) within half of JAX's own bf16-vs-f32 gap
  (``tests/test_torch_bf16.py``'s measure).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import block_pallas
from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm
from glow_tts_train_tpu_torch.ops.tc_gemm import im2col_plain, transposed_weights_plain
from glow_tts_train_tpu_torch.ops.wn_cuda import drop_args, regen_keep
from glow_tts_train_tpu_torch.tree import flatten, tree_index, unflatten

from helpers import tiny_config
from test_torch_bf16 import _checkpoint, _inputs, _np, held_to_gap

BF16 = torch.bfloat16
SMS = 132  # the H100's streaming multiprocessors
MAX_BLOCK_SMEM = 232448


def _units(plan):
    return {p["name"]: p["unit"] for p in plan["products"]}


@pytest.mark.parametrize("batch", [32, 16])
@pytest.mark.parametrize("h", [192, 256])
def test_every_product_takes_the_tma_units_at_shipped_widths(batch, h):
    """Base (h 192) and large (h 256) width, c 160, 4 WN layers, taps 5, at
    [batch, 704]: the forward's 11 conv-GEMMs (the folded A's too) and the
    backward's 12 and 11 weight gradients on the TMA-fed kernels (the WN
    layers' 8 forward products on the warp-specialised one, the rest on the
    64-row one), nothing on the CUDA cores or the mma.sync kernels; the
    transposed convs' epilogues in column pairs, no other product's."""
    fwd = tc_gemm.bf16_block_products(batch, 704, 160, h, 4, 5, 1, SMS)
    bwd = tc_gemm.bf16_block_products(batch, 704, 160, h, 4, 5, 1, SMS, backward=True)
    assert fwd["counts"] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                             "bf16_tma_gemm": 3, "bf16_tma_wgrad": 0, "bf16_ws_gemm": 8}
    assert bwd["counts"] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                             "bf16_tma_gemm": 12, "bf16_tma_wgrad": 11, "bf16_ws_gemm": 0}
    assert all(u == ("ws" if k.startswith(("in_", "res_skip_")) else "tma")
               for k, u in _units(fwd).items())
    assert all(u == "tma" for u in _units(bwd).values())
    assert all(p["column_pairs"] == p["name"].startswith("transposed_")
               for p in fwd["products"] + bwd["products"] if p["kind"] == "conv_gemm")
    # the paired epilogues take one chunk of each half, the rest up to three
    chunks = {p["name"]: p["chunks"] for p in fwd["products"] + bwd["products"]}
    assert chunks["in_0"] == 2 and chunks["coupling"] == 2 and chunks["res_skip_0"] == 3
    assert chunks["transposed_0"] == 3 and chunks["dzp"] == 2 and chunks["zp"] == 3
    for p in bwd["products"]:
        if p["kind"] == "wgrad":  # one wave of one block an SM at most
            assert 1 <= p["tiles"] <= SMS, p


def test_device_operations_a_call_at_base_width():
    """14 device operations a forward call (the 11 products, z's copy, ld's
    two sums) and 36 a backward call (2 fills, 12 conv-GEMMs, 11 weight
    gradients each with one reduction of its row splits and its bias's
    tile sums; the conditioning's gradient in dW_in's, so none more with
    it), as the card's traces count them (``scripts/torch-bf16-block-ab.py``)."""
    args = (32, 704, 160, 192, 4, 5, 1, SMS)
    assert tc_gemm.bf16_block_products(*args)["launches"] == 14
    assert tc_gemm.bf16_block_products(*args, backward=True)["launches"] == 36
    assert tc_gemm.bf16_block_products(*args, backward=True, with_g=True)["launches"] == 36


@pytest.mark.parametrize("c,h", [(16, 16), (8, 32), (160, 48)])
def test_narrow_widths_decline_to_mma(c, h):
    """Below 64 channels or columns a product declines to the mma.sync
    kernel, decided by shape alone: at the tests' tiny widths every
    product; at h 48 (c 160) those that read or write h-wide operands."""
    fwd = tc_gemm.bf16_block_products(4, 96, c, h, 2, 5, 1, SMS)
    bwd = tc_gemm.bf16_block_products(4, 96, c, h, 2, 5, 1, SMS, backward=True)
    units = {**_units(fwd), **{"bwd " + k: v for k, v in _units(bwd).items()}}
    if c < 64:
        assert set(units.values()) == {"mma"}
    else:
        assert units["start"] == "mma" and units["in_0"] == "mma"  # N = 2h = 96: c_in 48
        assert units["bwd dx"] == "tma" and units["bwd dA"] == "tma"  # c x c products
        assert units["bwd gate_0"] == "mma"  # N = h


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_ring_fits_a_block(chunks):
    """The weight gradient's ring (4 stages of A's two and B's ``chunks`` 8
    KB chunks), its barriers and the room to align within one block's
    shared memory; the conv-GEMM's (96 KB of stages of A's one chunk and
    B's) twice within an SM's 233,472 bytes, two blocks an SM, and its
    epilogue tile [64, 64 chunks + 8] f32 within its stages."""
    stages, smem = tc_gemm.bf16_ring("wgrad", chunks)
    assert stages == 4 and smem <= MAX_BLOCK_SMEM
    stages, smem = tc_gemm.bf16_ring("conv_gemm", chunks)
    assert stages * (1 + chunks) * tc_gemm.BF16_CHUNK_BYTES == 96 * 1024
    assert 2 * smem <= 233472
    assert 64 * (64 * chunks + 8) * 4 <= stages * (1 + chunks) * tc_gemm.BF16_CHUNK_BYTES
    for h in (192, 256):
        for bwd in (False, True):
            plan = tc_gemm.bf16_block_products(32, 704, 160, h, 4, 5, 1, SMS, backward=bwd)
            assert all(p["smem"] <= MAX_BLOCK_SMEM for p in plan["products"])


def _rne_bf16_bits(v: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns, rounded to nearest even (what
    ``__float2bfloat16_rn`` does; NaN not handled: none here)."""
    bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    lsb = (bits >> 16) & 1
    return ((bits + 0x7FFF + lsb) >> 16).astype(np.uint16)


def test_a_copy_rounded_by_its_writer_equals_rounding_at_staging():
    """The writer's copy bf16(v * m) (the epilogue rounds the value it
    writes, masked where the product reading it has an ``a_mask``) against
    the mma.sync staging's round(v * m), and against that staging applied
    again to the copy (the mask 0 or 1, as sequence masks are): the same
    bits, for ties to even and odd, subnormals, signed zeros and large
    values."""
    rng = np.random.default_rng(0)
    upper = rng.integers(0, 1 << 16, size=4096, dtype=np.uint64)
    # and every bf16 subnormal's upper half, both signs
    upper = np.concatenate([upper, np.arange(128, dtype=np.uint64),
                            np.arange(0x8000, 0x8080, dtype=np.uint64)])
    low = np.array([0x0000, 0x7FFF, 0x8000, 0x8001, 0xFFFF], dtype=np.uint64)
    bits = (upper[:, None] << 16 | low[None, :]).ravel()
    special = np.array([0x00000001, 0x00008000, 0x00018000, 0x007F8000, 0x80008000,
                        0x80000000, 0x00000000, 0x7F7F7FFF, 0x3F808000, 0x3F818000],
                       dtype=np.uint64)
    v = np.concatenate([bits, special]).astype(np.uint32).view(np.float32)
    v = v[np.isfinite(v)]
    v = v[np.abs(v) < 3e38]  # rounding past the largest bf16 goes to inf either way
    assert (np.abs(v) < 1.2e-38).sum() > 1000  # subnormals are there
    for m in (0.0, 1.0):
        staged = _rne_bf16_bits(v * np.float32(m))
        copy = torch.from_numpy(v * np.float32(m)).to(BF16)  # the writer's rounding
        copy_bits = copy.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(copy_bits, staged)
        restaged = _rne_bf16_bits(copy.float().numpy() * np.float32(m))
        np.testing.assert_array_equal(restaged, staged)


# ---------------------------------------------------------------------------
# an emulation of the chains' arithmetic
# ---------------------------------------------------------------------------


def _r(t):
    """round to bf16, kept in f32"""
    return t.to(BF16).float()


def _prod(a, w):
    """a [..., K] @ w [K, N], both holding bf16 values: f32 sums of the
    64-deep K slices in order (a stage of the TMA-fed kernels)."""
    acc = torch.zeros(*a.shape[:-1], w.shape[1])
    for k0 in range(0, a.shape[-1], 64):
        acc = acc + a[..., k0:k0 + 64] @ w[k0:k0 + 64]
    return acc


def _wgrad(a_cols, dy):
    """sum over rows of a_cols [b, t, K]^T dy [b, t, N]: each sample's rows
    in 64-row slices, the slices in order, split as the plan splits them and
    the splits' sums added in split order; written bf16."""
    batch, t, kdim = a_cols.shape
    n = dy.shape[-1]
    slices = [(b, t0) for b in range(batch) for t0 in range(0, t, 64)]
    _, splits = tc_gemm.bf16_wgrad_plan(batch, t, kdim, 1, n, kdim, SMS)
    out = torch.zeros(kdim, n)
    for s in range(splits):
        part = torch.zeros(kdim, n)
        for b, t0 in slices[len(slices) * s // splits:len(slices) * (s + 1) // splits]:
            part = part + a_cols[b, t0:t0 + 64].T @ dy[b, t0:t0 + 64]
        out = out + part
    return out.to(BF16)


def _logs(raw, sigmoid_scale):
    return torch.log(1e-6 + torch.sigmoid(raw + 2.0)) if sigmoid_scale else raw


# a tensor-core accumulator's lean, relative, the worst measured on the
# f32 folded A (PERF.md): every output of the product alike
TC_LEAN = 1e-7


def emulate_fwd(f, x, mask, taps, dilation_rate, sigmoid_scale, p, seed, lean=0.0):
    """The forward-save chain: -> z (bf16), ld (f32), saves (bf16).  The
    folded A on wgmma as every other product; ``lean``: each of its
    products times (1 - lean), before the bias and the bf16 rounding (a
    tensor-core accumulator that rounds toward zero)."""
    f = {k: v.float() for k, v in f.items()}
    batch, t, c = x.shape
    c2, (n_layers, _, h2) = c // 2, f["W_in"].shape
    h = h2 // 2
    drop, _, scale = drop_args(p)
    seeds = seed + torch.arange(batch, dtype=torch.int64)
    zp = _r((_prod(x.float(), f["A"]) * (1.0 - lean) + f["bA"]) * mask)
    xs = [_r((_prod(zp[..., :c2], f["W_s"]) + f["b_s"]) * mask)]
    th, sg, skip = [], [], 0.0
    for l in range(n_layers):
        pre = _prod(im2col_plain(xs[l], taps, dilation_rate ** l), f["W_in"][l]) + f["b_in"][l]
        if drop:
            pre = pre * regen_keep(seeds, l, n_layers, (t, h2), p) * scale
        th.append(torch.tanh(pre[..., :h]))
        sg.append(torch.sigmoid(pre[..., h:]))
        acts = _r(th[l] * sg[l])
        rs = _r(_prod(acts, f["W_rs"][l]) + f["b_rs"][l])
        if l < n_layers - 1:
            xs.append(_r(xs[l] + rs[..., :h]) * mask)
        skip = skip + rs[..., h:]
    skipm = _r(skip) * mask
    out = _prod(skipm, f["W_e"]) + f["b_e"]
    m, logs = _r(out[..., :c2]), _logs(_r(out[..., c2:]), sigmoid_scale)
    z1 = _r((m + torch.exp(logs) * zp[..., c2:]) * mask)
    saves = {"zp": zp, "skipm": skipm, "xs": torch.stack(xs), "th": _r(torch.stack(th)),
             "sg": _r(torch.stack(sg))}
    return (torch.cat([zp[..., :c2], z1], -1).to(BF16), (logs * mask).sum((1, 2)),
            {k: v.to(BF16) for k, v in saves.items()})


def _bias(dy):
    """A bias gradient as the bf16 chains take it: the f32 cotangent's
    tile sums as its writer keeps them (4 threads a column group at base
    width), each sample's tiles in order, then the samples in order."""
    batch, t, n = dy.shape
    return tc_gemm.sums_of_tiles_plain(tc_gemm.tile_sums_plain(dy.reshape(-1, n), batch, t))[0]


def emulate_bwd(f, x, mask, saves, dz, dld, taps, dilation_rate, sigmoid_scale, p, seed):
    """The backward-store chain from the saves: -> the gradients of x and of
    the folded weights (bf16 where the weight is, the biases' f32)."""
    f = {k: v.float() for k, v in f.items()}
    sv = {k: v.float() for k, v in saves.items()}
    batch, t, c = x.shape
    c2, (n_layers, _, h2) = c // 2, f["W_in"].shape
    h = h2 // 2
    drop, _, scale = drop_args(p)
    seeds = seed + torch.arange(batch, dtype=torch.int64)
    dz, zp = dz.float(), sv["zp"]
    g = {}
    # the coupling's logs rebuilt from skipm, its backward in the epilogue
    raw = _r(_prod(sv["skipm"], f["W_e"][:, c2:]) + f["b_e"][..., c2:])
    logs = _logs(raw, sigmoid_scale)
    el = torch.exp(logs)
    dz1m = dz[..., c2:] * mask
    dlogs = dz1m * el * zp[..., c2:] + dld[:, None, None] * mask
    if sigmoid_scale:
        s = torch.sigmoid(raw + 2.0)
        dlogs = dlogs * (s * (1.0 - s)) / (1e-6 + s)
    dout = torch.cat([dz1m, dlogs], -1)
    dzp_hi = dz1m * el * mask
    g["dW_e"], g["db_e"] = _wgrad(sv["skipm"], _r(dout)), _bias(dout)
    g_rs = torch.cat([torch.zeros(batch, t, h), _r(_prod(_r(dout), f["W_e"].T) * mask)], -1)
    gx = torch.zeros(batch, t, h)
    dw_in, db_in, dw_rs, db_rs = [None] * n_layers, [None] * n_layers, [None] * n_layers, [None] * n_layers
    gx16 = None
    for l in reversed(range(n_layers)):
        th, sg = sv["th"][l], sv["sg"][l]
        da = _prod(_r(g_rs), f["W_rs"][l].T)
        d_xin = torch.cat([da * sg * (1.0 - th * th), da * th * sg * (1.0 - sg)], -1)
        if drop:
            d_xin = d_xin * regen_keep(seeds, l, n_layers, (t, h2), p) * scale
        dw_rs[l], db_rs[l] = _wgrad(_r(th * sg), _r(g_rs)), _bias(g_rs)
        dil = dilation_rate ** l
        dw_in[l] = _wgrad(im2col_plain(sv["xs"][l], taps, dil), _r(d_xin))
        db_in[l] = _bias(d_xin)
        tconv = _prod(im2col_plain(_r(d_xin), taps, dil, -1),
                      transposed_weights_plain(f["W_in"][l], taps))
        gx = gx * mask + tconv
        if l > 0:
            g_rs = torch.cat([gx * mask, g_rs[..., h:]], -1)
        else:
            gx16 = _r(gx * mask)
    g["dW_in"], g["db_in"] = torch.stack(dw_in), torch.stack(db_in)
    g["dW_rs"], g["db_rs"] = torch.stack(dw_rs), torch.stack(db_rs)
    g["dW_s"], g["db_s"] = _wgrad(zp[..., :c2], gx16), _bias(gx * mask)
    dzp = torch.cat([(dz[..., :c2] + _prod(gx16, f["W_s"].T)) * mask, dzp_hi], -1)
    g["dA"], g["dbA"] = _wgrad(x.float(), _r(dzp)), _bias(dzp)
    g["dx"] = _prod(_r(dzp), f["A"].T).to(BF16)
    for k in ("db_e", "db_s", "dbA"):
        g[k] = g[k][None]
    return g


def _base_block(seed=0):
    gen = torch.Generator().manual_seed(seed)
    c, h, n_layers, taps, b, t = 160, 192, 4, 5, 2, 96
    mask = (torch.arange(t)[None, :] < torch.tensor([t, t - 23])[:, None]).float()[..., None]
    x = (torch.randn(b, t, c, generator=gen) * mask).to(BF16)

    def r(*shape, s=1.0, off=None):
        v = torch.randn(*shape, generator=gen) * s
        return v + off if off is not None else v

    f32 = {"A": r(c, c, s=0.05, off=torch.eye(c)), "bA": r(1, c, s=0.1),
           "W_s": r(c // 2, h, s=(c // 2) ** -0.5), "b_s": r(1, h, s=0.1),
           "W_e": r(h, c, s=0.05), "b_e": r(1, c, s=0.05),
           "W_in": r(n_layers, taps * h, 2 * h, s=(taps * h) ** -0.5),
           "b_in": r(n_layers, 2 * h, s=0.1), "W_rs": r(n_layers, h, 2 * h, s=h ** -0.5),
           "b_rs": r(n_layers, 2 * h, s=0.1)}
    f32["W_rs"][-1, :, :h] = 0.0
    folded = {k: v.to(BF16 if k in block_cuda.BF16_OPERANDS else torch.float32)
              for k, v in f32.items()}
    dz = torch.randn(b, t, c, generator=gen).to(BF16)
    dld = torch.randn(b, generator=gen)
    return folded, x, mask, dz, dld, (taps, 1)


def _held(name, got, ref, rtol=2e-2):
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    assert scale > 0, name
    err = (got - ref).abs().max().item()
    assert err <= rtol * scale, f"{name}: {err} vs max |ref| {scale}"


@pytest.mark.parametrize("sigmoid_scale", [False, True])
def test_emulated_chains_match_the_plain_bf16_block(sigmoid_scale):
    """The emulation at base width (c 160, h 192, 4 WN layers, taps 5; [2,
    96], one sample ragged; dropout on) against block_forward_plain_bf16
    and its autograd: z, ld and dx and every folded weight's gradient within
    2e-2 of its max |ref|, in the plain version's dtypes."""
    folded, x, mask, dz, dld, (taps, dil) = _base_block()
    cfg = (taps, dil, sigmoid_scale, 0.05, 21)
    z, ld, saves = emulate_fwd(folded, x, mask, *cfg)
    leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
    xl = x.detach().requires_grad_(True)
    plain_saves = {}
    z_p, ld_p = block_cuda.block_forward_plain_bf16(leaves, None, xl, mask, *cfg,
                                                    saves=plain_saves)
    _held("z", z, z_p)
    _held("ld", ld, ld_p)
    assert z.dtype == z_p.dtype == BF16
    ref = dict(zip(["dx"] + ["d" + k for k in leaves],
                   torch.autograd.grad((z_p, ld_p), [xl, *leaves.values()], (dz, dld))))
    grads = emulate_bwd(folded, x, mask, saves, dz, dld, *cfg)
    for name, r in ref.items():
        assert grads[name].dtype == r.dtype, name
        _held(name, grads[name], r)


class _EmulatedBlock(torch.autograd.Function):
    """The emulated chains as the store-mode block's autograd Function."""

    @staticmethod
    def forward(ctx, x, mask, cfg, *weights):
        folded = dict(zip(block_cuda.FOLD_KEYS, weights))
        z, ld, saves = emulate_fwd(folded, x, mask, *cfg)
        ctx.cfg, ctx.folded, ctx.saves = cfg, folded, saves
        ctx.save_for_backward(x, mask)
        return z, ld

    @staticmethod
    def backward(ctx, dz, dld):
        x, mask = ctx.saved_tensors
        g = emulate_bwd(ctx.folded, x, mask, ctx.saves, dz, dld, *ctx.cfg[:5])
        return (g["dx"], None, None,
                *(g["d" + k].to(ctx.folded[k].dtype) for k in block_cuda.FOLD_KEYS))


@pytest.fixture(scope="module")
def jax_block(tmp_path_factory):
    """JAX ``flow_block_fused`` (tiny config, no dropout, interpret mode,
    store residuals) in bf16 and in f32 on one block of random weights: its
    outputs and the gradients of x and of every raw block parameter, with
    the inputs and cotangents that made them."""
    config = tiny_config()
    jparams, tmodel, hp = _checkpoint(tmp_path_factory.mktemp("ckpt"), config)
    n_layers, h = hp.n_block_layers, hp.h_dec
    c = hp.out_channels * hp.n_sqz
    x, mask = _inputs(20, c, seed=5)
    rng = np.random.default_rng(6)
    bp_j = jax.tree_util.tree_map(lambda a: a[1], jparams["decoder"]["blocks"])
    res = {}
    for dt in (jnp.bfloat16, jnp.float32):
        def f(bp, xx):
            return block_pallas.flow_block_fused(
                bp, xx, jnp.asarray(mask, dt), None, hidden_channels=h,
                dilation_rate=hp.dilation_rate, n_layers=n_layers, n_split=hp.n_split,
                sigmoid_scale=hp.sigmoid_scale, interpret=True, residuals="store",
            )

        (z, ld), vjp = jax.vjp(f, bp_j, jnp.asarray(x, dt))
        if dt == jnp.bfloat16:
            dz = rng.standard_normal(z.shape).astype(np.float32)
            dld = rng.standard_normal(ld.shape).astype(np.float32)
        d_bp, d_x = vjp((jnp.asarray(dz, z.dtype), jnp.asarray(dld, ld.dtype)))
        res[dt] = {"z": z, "ld": ld, "x": d_x, **flatten(jax.tree_util.tree_map(np.asarray, d_bp))}
    return {"res": res, "tmodel": tmodel, "hp": hp, "x": x, "mask": mask, "dz": dz, "dld": dld}


def _emulated_gaps(jb, lean):
    """The emulation through ``fold_block_params`` on ``jax_block``'s
    inputs -> per output and raw parameter gradient, |port - JAX bf16| over
    |JAX bf16 - JAX f32| (each held within half)."""
    hp, res = jb["hp"], jb["res"]
    flat_t = {k: v.clone().requires_grad_(True)
              for k, v in flatten(tree_index(jb["tmodel"].tree()["decoder"]["blocks"], 1)).items()}
    xt = torch.from_numpy(jb["x"]).to(BF16).requires_grad_(True)
    folded = block_cuda.fold_block_params(unflatten(flat_t), hp.n_block_layers, hp.n_split, BF16)
    cfg = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale, 0.0, 0, lean)
    z_t, ld_t = _EmulatedBlock.apply(xt, torch.from_numpy(jb["mask"]), cfg,
                                     *(folded[k] for k in block_cuda.FOLD_KEYS))
    grads = torch.autograd.grad((z_t, ld_t), [*flat_t.values(), xt],
                                (torch.from_numpy(jb["dz"]).to(BF16), torch.from_numpy(jb["dld"])))
    port = {"z": z_t, "ld": ld_t, "x": grads[-1], **dict(zip(flat_t, grads))}
    return {k: held_to_gap(k, _np(port[k]), res[jnp.bfloat16][k], res[jnp.float32][k])
            for k in port}


def test_emulated_chains_within_half_of_jax_gap(jax_block):
    """The emulation through ``fold_block_params`` (tiny config, no dropout)
    against JAX ``flow_block_fused`` with x bf16 (interpret mode, store
    residuals): z, ld and the gradients of x and of every raw block
    parameter within half of JAX's own bf16-vs-f32 gap."""
    assert max(_emulated_gaps(jax_block, 0.0).values()) < 0.5


def test_emulated_chains_with_a_leaning_zp_within_half_of_jax_gap(jax_block):
    """The check that lets the bf16 folded A onto wgmma: the emulation with
    every zp product leaning low by a tensor-core accumulator's worst
    measured amount (TC_LEAN, all outputs alike, before the bf16 rounding)
    still within half of JAX's bf16-vs-f32 gap for z, ld, dx and every raw
    block parameter's gradient, the ActNorm's ``logs`` and ``bias`` and the
    InvConvNear's weight (the leaves the folded A carries) included."""
    gaps = _emulated_gaps(jax_block, TC_LEAN)
    carried = [k for k in gaps if k.startswith(("actnorm", "invconv"))]
    assert {k.split("/")[-1] for k in carried} >= {"logs", "bias"}, sorted(gaps)
    assert max(gaps.values()) < 0.5, gaps

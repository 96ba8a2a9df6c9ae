"""The 3xTF32 arithmetic and the weight layouts of the tensor-core kernels
(glow_tts_train_tpu_torch ``ops/tc_gemm.py``, ``csrc/tc_gemm.cu``) on the
CPU: the plain emulation of the split against float64, the layout helpers
against the products of ``block_forward_plain`` and of the transposed
(backward) convs, and the bare products' plain versions against the JAX
package's conv and its gradients.  Every input is made from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import conv as jax_conv
from glow_tts_train_tpu_torch.ops import block_cuda, conv, tc_gemm

# a 3xTF32 product against float64, relative to the largest output: each
# term loses what lies below 2^-21 of it
SPLIT_RTOL = 5e-6
# the plain versions against JAX on the CPU, both f32: summation order
PLAIN_RTOL = 1e-5


def _randn(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _rel_err(got, ref):
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


@pytest.mark.parametrize("k", [960, 1920])
def test_3xtf32_matches_float64_and_one_pass_does_not(k):
    """Three passes stay within SPLIT_RTOL of float64; a single TF32 pass
    errs more than 100 times as much on the same inputs."""
    a, b = _randn(k, 96, k), _randn(k + 1, k, 80) / np.sqrt(k)
    ref = a.double() @ b.double()
    three = _rel_err(tc_gemm.matmul_3xtf32_plain(a, b), ref)
    one = _rel_err(tc_gemm.matmul_1xtf32_plain(a, b), ref)
    assert three <= SPLIT_RTOL, three
    assert one > 100 * three, (one, three)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e18])
def test_tf32_split_parts(scale):
    """big and small are exact TF32 values (13 low bits clear), big is v
    rounded to nearest, and big + small equals v to within 2^-21 relative."""
    v = _randn(3, 4096) * scale
    big, small = tc_gemm.tf32_split(v)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.all((v - big).abs() <= v.abs() * 2.0 ** -11)
    # to nearest, not toward zero: about half of the values round up
    assert 0.4 < (big.abs() > v.abs()).float().mean().item() < 0.6
    assert torch.all(((big.double() + small.double()) - v.double()).abs() <= v.double().abs() * 2.0 ** -21)


def test_split_weights_layout_round_trips():
    """[K, N] -> [2, N, K]: the parts add up to the transpose, and the
    K-major layout reproduces the product."""
    w = _randn(4, 40, 24)
    split = tc_gemm.split_weights_plain(w)
    assert split.shape == (2, 24, 40)
    assert split.is_contiguous()
    assert _rel_err(split[0] + split[1], w.T) <= 2.0 ** -21
    assert torch.equal(split[0], tc_gemm.tf32_split(w)[0].T)
    a = _randn(5, 16, 40)
    a_big, a_small = tc_gemm.tf32_split(a)
    got = (a_small.double() @ split[0].double().T + a_big.double() @ split[1].double().T
           + a_big.double() @ split[0].double().T)
    assert torch.equal(got.float(), tc_gemm.matmul_3xtf32_plain(a, w))


@pytest.mark.parametrize("n,split", [(8, 4), (32, 16), (384, 192)])
def test_physical_cols_pairs_neighbours(n, split):
    """Tile rows 2j and 2j + 1 read the pair (j, j + split); the order is a
    permutation of the columns, inverted by gathering back."""
    cols = tc_gemm.physical_cols(n, split)
    assert sorted(cols.tolist()) == list(range(n))
    assert torch.equal(cols[0::2], torch.arange(split))
    assert torch.equal(cols[1::2], torch.arange(split) + split)
    w = _randn(6, 12, n)
    paired = w[:, cols]  # the tile's column order
    restored = torch.empty_like(w)
    restored[:, cols] = paired
    assert torch.equal(restored, w)


def _block_folds(seed, c, h, n_layers, taps):
    def w(i, *shape):
        return _randn(seed + i, *shape) / np.sqrt(shape[-2])

    return {
        "A": w(0, c, c), "bA": _randn(seed + 1, 1, c), "W_s": w(2, c // 2, h),
        "b_s": _randn(seed + 3, 1, h), "W_e": w(4, h, c), "b_e": _randn(seed + 5, 1, c),
        "W_in": w(6, n_layers, taps * h, 2 * h), "b_in": _randn(seed + 7, n_layers, 2 * h),
        "W_rs": w(8, n_layers, h, 2 * h), "b_rs": _randn(seed + 9, n_layers, 2 * h),
    }


@pytest.mark.parametrize("dilation_rate", [1, 2])
def test_split_layouts_reproduce_block_forward_plain(dilation_rate):
    """The block's forward built from 3xTF32 products over the K-major split
    weights (gate pairs read in paired order) agrees with
    ``block_forward_plain`` within the split's error."""
    b, t, c, h, n_layers, taps = 2, 24, 8, 16, 3, 5
    f = _block_folds(10, c, h, n_layers, taps)
    x = _randn(30, b, t, c)
    lengths = torch.tensor([t, t - 5])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = x * mask

    def product(a, w, taps=1, dilation=1):
        """im2col(a) @ w from the K-major split, as the kernel lays it out."""
        cols = tc_gemm.im2col_plain(a, taps, dilation)
        big, small = tc_gemm.split_weights_plain(w)
        c_big, c_small = tc_gemm.tf32_split(cols)
        return (c_small.double() @ big.double().T + c_big.double() @ small.double().T
                + c_big.double() @ big.double().T).float()

    c2 = c // 2
    zp = (product(x, f["A"]) + f["bA"]) * mask
    xs = (product(zp[..., :c2].contiguous(), f["W_s"]) + f["b_s"]) * mask
    skip = torch.zeros_like(xs)
    pair_order = tc_gemm.physical_cols(2 * h, h)
    for l in range(n_layers):
        pre = product(xs, f["W_in"][l], taps, dilation_rate ** l) + f["b_in"][l]
        paired = pre[..., pair_order]  # (u_j, v_j) side by side, as a fragment holds them
        acts = torch.tanh(paired[..., 0::2]) * torch.sigmoid(paired[..., 1::2])
        rs = product(acts, f["W_rs"][l]) + f["b_rs"][l]
        xs, skip = (xs + rs[..., :h]) * mask, skip + rs[..., h:]
    out = product(skip * mask, f["W_e"]) + f["b_e"]
    z1 = (out[..., :c2] + torch.exp(out[..., c2:]) * zp[..., c2:]) * mask
    z = torch.cat([zp[..., :c2], z1], dim=-1)
    z_p, ld_p = block_cuda.block_forward_plain(f, None, x, mask, taps, dilation_rate)
    assert _rel_err(z, z_p) <= 1e-5
    assert _rel_err(torch.sum(out[..., c2:] * mask, dim=(1, 2)), ld_p) <= 1e-5


def test_per_tap_transposed_w_in_is_the_input_gradient():
    """The backward's transposed conv: d_xin through the per-tap transposed
    W_in at negated tap offsets equals autograd's input gradient of the
    forward conv, read from W_in as it lies (``w_t``, as the WN walk reads
    it), and its K-major split is W_in's own rows regrouped."""
    b, t, h, taps, dilation = 2, 20, 8, 5, 2
    w_in = _randn(40, 1, taps * h, 2 * h) / np.sqrt(taps * h)
    w_rs = _randn(41, 1, h, 2 * h)
    x = _randn(42, b, t, h).requires_grad_(True)
    d_xin = _randn(43, b, t, 2 * h)
    y = conv.conv_taps(x, w_in[0], torch.zeros(2 * h), taps, dilation)
    (ref,) = torch.autograd.grad((y * d_xin).sum(), x)
    w_in_t = tc_gemm.transposed_weights_plain(w_in[0], taps)[None]
    w_rs_t = tc_gemm.transposed_weights_plain(w_rs[0], 1)[None]
    got = tc_gemm.conv_product_plain(d_xin, w_in_t[0], taps, dilation, tap_sign=-1)
    assert _rel_err(got, ref) <= PLAIN_RTOL
    assert torch.equal(tc_gemm.conv_product(d_xin, w_in[0], taps, dilation, -1, w_t=True), got)
    assert torch.equal(w_rs_t[0], w_rs[0].T)
    # K-major of the transposed weights: row n (an input channel), column
    # tap * 2h + j is W_in[tap * h + n, j]
    k_major = tc_gemm.split_weights_plain(w_in_t[0])
    regrouped = w_in[0].reshape(taps, h, 2 * h).permute(1, 0, 2).reshape(h, taps * 2 * h)
    assert torch.equal(k_major[0], tc_gemm.tf32_split(regrouped)[0])
    got3 = tc_gemm.matmul_3xtf32_plain(
        tc_gemm.im2col_plain(d_xin, taps, dilation, -1).reshape(b * t, -1), w_in_t[0]
    ).reshape(b, t, h)
    assert _rel_err(got3, ref) <= SPLIT_RTOL


@pytest.mark.parametrize("taps,dilation", [(1, 1), (5, 1), (5, 2), (3, 4)])
def test_bare_products_plain_match_jax_conv_and_its_gradients(taps, dilation):
    """``conv_product`` and ``weight_gradient`` on CPU tensors (their plain
    versions) against the JAX package's conv1d and jax.grad of it."""
    b, t, c, n = 2, 19, 12, 8
    a, w, dy = _randn(50, b, t, c), _randn(51, taps * c, n), _randn(52, b, t, n)
    a_mask = (torch.arange(t)[None, :] < torch.tensor([t, t - 6])[:, None]).float()[..., None]
    params = {"w": jnp.asarray(w.numpy()).reshape(taps, c, n), "b": jnp.zeros((n,))}

    def loss(p, x):
        return jnp.sum(jax_conv.conv1d(x, p, dilation=dilation) * jnp.asarray(dy.numpy()))

    y = jax_conv.conv1d(jnp.asarray(a.numpy()), params, dilation=dilation)
    got = tc_gemm.conv_product(a, w, taps, dilation)
    assert _rel_err(got, torch.from_numpy(np.array(y))) <= PLAIN_RTOL
    g_w, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(a.numpy()))
    dw = tc_gemm.weight_gradient(a, dy, taps, dilation)
    assert _rel_err(dw, torch.from_numpy(np.array(g_w["w"])).reshape(taps * c, n)) <= PLAIN_RTOL
    # the input gradient is the transposed product at negated offsets
    w_t = w.reshape(taps, c, n).transpose(1, 2).reshape(taps * n, c)
    dx = tc_gemm.conv_product(dy, w_t, taps, dilation, tap_sign=-1)
    assert _rel_err(dx, torch.from_numpy(np.array(g_x))) <= PLAIN_RTOL
    # row masks multiply the source rows
    masked = tc_gemm.conv_product(a, w, taps, dilation, a_mask=a_mask)
    assert torch.equal(masked, tc_gemm.conv_product(a * a_mask, w, taps, dilation))
    dw_masked = tc_gemm.weight_gradient(a, dy, taps, dilation, dy_mask=a_mask)
    assert torch.equal(dw_masked, tc_gemm.weight_gradient(a, dy * a_mask, taps, dilation))


def test_split_weights_takes_the_plain_version_on_the_cpu():
    w = _randn(60, 20, 12)
    assert torch.equal(tc_gemm.split_weights(w), tc_gemm.split_weights_plain(w))


def test_weight_gradient_from_transposed_split_slices():
    """The weight gradient as the tensor-core kernel builds it: per 32-row
    slice, dY (row masks multiplied in) laid out K-major and split as a
    weight matrix is, the im2col columns as the other operand, the slices'
    products added in order; it agrees with ``weight_gradient_plain``
    within the split's error."""
    b, t, c, n, taps, dilation = 2, 50, 12, 8, 3, 2
    a, dy = _randn(70, b, t, c), _randn(71, b, t, n)
    dy_mask = (torch.arange(t)[None, :] < torch.tensor([t, t - 9])[:, None]).float()[..., None]
    cols = tc_gemm.im2col_plain(a, taps, dilation).reshape(b * t, taps * c)
    rows = (dy * dy_mask).reshape(b * t, n)
    out = torch.zeros(taps * c, n, dtype=torch.float64)
    for m in range(0, b * t, 32):
        big, small = tc_gemm.split_weights_plain(rows[m:m + 32])  # [n, rows of the slice]
        c_big, c_small = (p.double().T for p in tc_gemm.tf32_split(cols[m:m + 32]))
        out += c_small @ big.double().T + c_big @ small.double().T + c_big @ big.double().T
    ref = tc_gemm.weight_gradient_plain(a.double(), dy.double(), taps, dilation, dy_mask=dy_mask.double())
    assert _rel_err(out, ref) <= SPLIT_RTOL
    assert _rel_err(tc_gemm.weight_gradient(a, dy, taps, dilation, dy_mask=dy_mask), ref) <= PLAIN_RTOL

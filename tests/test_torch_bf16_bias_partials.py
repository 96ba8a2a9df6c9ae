"""The bf16 flow chains' bias and conditioning gradients from tile sums, on
the CPU.

In a bf16 call of the flow block's and the WN stack's backwards
(``gtt_block_bwd_store_bf16``, ``gtt_block_bwd_bf16``,
``gtt_wn_bwd_store_bf16``, ``gtt_wn_bwd_bf16``) the epilogue that writes a
cotangent keeps its f32 column sums per sample and 64-row tile instead of
writing the f32 cotangent, and each weight gradient's reduction adds them:
each sample's tiles in order, then the samples in order (``dg`` is the
per-sample part).  ``tc_gemm.tile_sums_plain`` and
``tc_gemm.sums_of_tiles_plain`` are that arithmetic in plain PyTorch.

* Against a float64 column sum within 1e-6 of max |sum| (f32 sums of a few
  thousand rows), at t 704, 700, 37 and 1,408, batch 1 and 3, masked rows.
* Against the JAX kernels' own sums (``wn_pallas._reverse_walk``'s
  ``dbin_ref[l] += jnp.sum(d_xin, axis=0)`` a sample a grid step, and
  ``dg_ref[0, l] = jnp.sum(d_in_act, axis=0).astype(bf16)``): the bias
  within 1e-6 of max |sum|, dg within one bf16 step.
* The tiles partition the rows: every row in exactly one tile, no tile
  across two samples, a tile 64 rows but the last of each sample.
* The products' wrappers on CPU tensors (``tc_gemm.bf16_conv_product`` with
  ``sums``, ``tc_gemm.bf16_weight_gradient`` with ``bias_sums`` and
  ``g_sums``) give the plain versions of what their kernels keep and
  reduce: the masked product's tile sums, and from them the bias within
  1e-6 of max |sum| of a float64 column sum and dg within one bf16 step.

The kernels themselves are held to these functions on a GPU in
``tests/test_torch_cuda.py`` (``test_bf16_product_tile_sums_and_reduction``,
``test_bf16_flow_bias_gradients_from_tile_sums``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch.ops import tc_gemm

SMS = 132  # the H100's streaming multiprocessors
SUM_RTOL = 1e-6


def _values(batch: int, t: int, n: int, seed: int) -> np.ndarray:
    """[batch, t, n] f32 cotangent-like values (an offset so that the sums
    are far from zero), zero past each sample's length."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((batch, t, n)).astype(np.float32) + 0.5
    lengths = [t - (13 * b) % max(t // 2, 1) for b in range(batch)]
    mask = (np.arange(t)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    return v * mask[..., None]


def _held(name: str, got: torch.Tensor, want: np.ndarray) -> None:
    scale = np.abs(want).max()
    err = np.abs(got.double().numpy() - want).max()
    assert err <= SUM_RTOL * scale, f"{name}: {err} against {SUM_RTOL} of {scale}"


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("t", [704, 700, 37, 1408])
def test_tile_sums_hold_a_float64_column_sum(t, batch):
    """The bias (all rows) and the per-sample parts (dg's) from the tile
    sums within 1e-6 of max |sum| of the float64 sums."""
    n = 96
    v = _values(batch, t, n, seed=t + batch)
    sums = tc_gemm.tile_sums_plain(torch.from_numpy(v).reshape(-1, n), batch, t)
    assert sums.shape == (batch, -(-t // 64), n) and sums.dtype == torch.float32
    total, per = tc_gemm.sums_of_tiles_plain(sums)
    _held("bias", total, v.astype(np.float64).sum((0, 1)))
    _held("per sample", per, v.astype(np.float64).sum(1))


@pytest.mark.parametrize("t", [704, 37])
def test_tile_sums_hold_the_jax_kernels_sums(t):
    """A sample at a time as the JAX kernels' grid adds their bias sums
    (``jnp.sum`` over a sample's rows, accumulated over the samples) and
    their dg (a sample's ``jnp.sum`` in bf16), on the same numpy inputs."""
    batch, n = 3, 384
    v = _values(batch, t, n, seed=7)
    acc = jnp.zeros((n,), jnp.float32)
    dg_jax = []
    for b in range(batch):
        acc = acc + jnp.sum(jnp.asarray(v[b]), axis=0)
        dg_jax.append(np.asarray(jnp.sum(jnp.asarray(v[b]), axis=0).astype(jnp.bfloat16)
                                 .astype(jnp.float32)))
    total, per = tc_gemm.sums_of_tiles_plain(
        tc_gemm.tile_sums_plain(torch.from_numpy(v).reshape(-1, n), batch, t))
    _held("bias against the JAX kernels' sum", total, np.asarray(acc, np.float64))
    dg = per.to(torch.bfloat16).float().numpy()
    step = np.abs(np.stack(dg_jax)) * 2.0 ** -7  # one bf16 step at each value
    assert np.all(np.abs(dg - np.stack(dg_jax)) <= step), "dg beyond one bf16 step of JAX's"


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("t", [704, 700, 37, 1408, 64, 65])
def test_tiles_cover_every_row_once_within_its_sample(t, batch):
    """Tile sums of one-hot rows: each row lands in exactly one tile, that
    tile belongs to the row's sample and holds rows 64 i .. 64 i + 63 of it
    (the last one of a sample fewer), so no tile crosses a sample."""
    rows = batch * t
    hits = tc_gemm.tile_sums_plain(torch.eye(rows), batch, t)  # [b, tile, row]
    assert torch.equal(hits.sum((0, 1)), torch.ones(rows))
    b_of, tile_of, row_of = torch.nonzero(hits, as_tuple=True)
    assert torch.equal(b_of, row_of // t)
    assert torch.equal(tile_of, (row_of % t) // 64)
    per_tile = hits.sum(-1)
    tiles = -(-t // 64)
    assert torch.all(per_tile[:, :-1] == 64) and torch.all(per_tile[:, -1] == t - 64 * (tiles - 1))


@pytest.mark.parametrize("t", [100, 37])
def test_product_wrappers_keep_and_reduce_tile_sums_on_the_cpu(t):
    """One masked bf16 product with its tile sums and one weight gradient
    that reduces them, on CPU tensors (the wrappers' plain versions): the
    product masked, its sums those of its rows, the bias from the sums
    split at column 64 (the reduction's lo and hi) within 1e-6 of max |sum|
    of a float64 column sum, dg within one bf16 step of each sample's,
    the weight gradient the plain one's."""
    batch, c_in, n = 3, 48, 96
    rng = np.random.default_rng(t)
    a = torch.from_numpy(rng.standard_normal((batch, t, c_in)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((c_in, n)).astype(np.float32) * 0.2).bfloat16()
    lengths = torch.tensor([t, t - 11, t // 3])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    out, sums = tc_gemm.bf16_conv_product(a, w, mask=mask, sums=True)
    want = (a.double() @ w.double()) * mask.double()
    assert (out.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(sums, tc_gemm.tile_sums_plain(out.reshape(-1, n), batch, t))
    dy = out.bfloat16()
    dw, bias, dg = tc_gemm.bf16_weight_gradient(
        a, dy, bias_sums=(sums[..., :64].contiguous(), sums[..., 64:].contiguous()), g_sums=sums)
    assert torch.equal(dw, tc_gemm.bf16_weight_gradient_plain(a, dy))
    _held("bias", bias, out.double().sum((0, 1)).numpy())
    per = out.double().sum(1).numpy()
    assert dg.dtype == torch.bfloat16 and dg.shape == (batch, n)
    assert np.all(np.abs(dg.double().numpy() - per) <= np.abs(per) * 2.0 ** -7)

"""bf16 training (``fp16_run: true``) in the decoder's three other modes on
the CPU: the WN stack alone in bf16 (the op-by-op decoder's kernels, bf16
rows 5-8) and the fused flow block in recompute mode (bf16 rows 9 and
11), their plain bf16 versions against the JAX package's kernels with
dtype bf16, and the plan of the six bf16 entry points.

As in ``tests/test_torch_bf16.py``: the same numpy-seeded inputs go
through the JAX function in bf16 and in f32 (its Pallas kernels in
interpret mode) and through the port in bf16 (its CPU route: the plain
bf16 versions), dropout off, and every output and gradient of the port is
held within half of JAX's own bf16-vs-f32 gap of JAX bf16, in the 2-norm
per tensor (``held_to_gap``).  ``forward_train`` and the 3-step trajectory
in the four decoder modes are parametrised cases of the tests in
``tests/test_torch_bf16.py``.

The plan (``tc_gemm.bf16_block_products``, the plain version of the
chains' dispatch): the forward that saves nothing runs the forward-save's
products, a recompute backward the forward-save chain's (the block's up to
skipm) and then the store backward's, on the same units; the device
operations a call at base width.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import block_pallas, wn_pallas
from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm, wn_cuda
from glow_tts_train_tpu_torch.tree import flatten, tree_index, unflatten

from helpers import tiny_config
from test_torch_bf16 import BF16, _checkpoint, _inputs, _np, held_to_gap

REPO = Path(__file__).resolve().parents[1]
H, L, TAPS, DILATION = 32, 3, 5, 2
SMS = 132  # the H100's streaming multiprocessors


def _wn_weights(rng):
    """Folded WN weights (``fold_wn_weights``' layout): W_in [L, K h, 2h],
    b_in, W_rs [L, h, 2h] with the last layer's residual half zero, b_rs."""
    w_in = (rng.standard_normal((L, TAPS * H, 2 * H)) * (TAPS * H) ** -0.5).astype(np.float32)
    w_rs = (rng.standard_normal((L, H, 2 * H)) * H ** -0.5).astype(np.float32)
    w_rs[-1, :, :H] = 0.0
    b_in = (0.1 * rng.standard_normal((L, 2 * H))).astype(np.float32)
    b_rs = (0.1 * rng.standard_normal((L, 2 * H))).astype(np.float32)
    b_rs[-1, :H] = 0.0
    return w_in, b_in, w_rs, b_rs


@pytest.mark.parametrize("gin", [False, True], ids=["no_g", "g"])
@pytest.mark.parametrize("residuals", ["store", "recompute"])
def test_wn_stack_bf16_within_half_of_jax_gap(residuals, gin):
    """The WN stack's plain bf16 version (``wn_stack_train`` on bf16 CPU
    tensors: the plain version of the bf16 rows 5-8) against JAX
    ``wn_stack_fused`` with x, W_in, W_rs and the conditioning bf16
    (interpret mode, the ``residuals`` mode's kernels) times the mask, as
    ``wn_apply_pallas`` returns it: the output, dx, the four weight and
    bias gradients and, conditioned, dg."""
    rng = np.random.default_rng(7)
    weights = _wn_weights(rng)
    x, mask = _inputs(20, H, seed=8)
    g_all = (0.5 * rng.standard_normal((3, L, 2 * H))).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    res = {}
    for dt in (jnp.bfloat16, jnp.float32):
        m = jnp.asarray(mask, dt)

        def f(w_in, b_in, w_rs, b_rs, xx, gg):
            out = wn_pallas.wn_stack_fused(
                w_in, b_in, w_rs, b_rs, xx, m, gg if gin else jnp.zeros_like(gg), jnp.int32(0),
                kernel_size=TAPS, dilation_rate=DILATION, n_layers=L, p_dropout=0.0,
                deterministic=True, interpret=True, residuals=residuals,
            )
            return out * m

        args = [jnp.asarray(a, dt if i in (0, 2) else jnp.float32) for i, a in enumerate(weights)]
        args += [jnp.asarray(x, dt), jnp.asarray(g_all, dt)]
        out, vjp = jax.vjp(f, *args)
        res[dt] = [out, *vjp(jnp.asarray(cot, out.dtype))]
    for r in res.values():  # as the port orders them: out, dx, the weights', dg
        r[1:] = [r[5], *r[1:5], r[6]]

    tw = [torch.from_numpy(a).to(BF16 if i in (0, 2) else torch.float32).requires_grad_(True)
          for i, a in enumerate(weights)]
    tx = torch.from_numpy(x).to(BF16).requires_grad_(True)
    tg = torch.from_numpy(g_all).to(BF16).requires_grad_(True) if gin else None
    out = wn_cuda.wn_stack_train(tuple(tw), tg, tx, torch.from_numpy(mask), TAPS, DILATION,
                                 residuals=residuals)
    assert out.dtype == BF16
    inputs = [tx, *tw] + ([tg] if gin else [])
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(cot).to(BF16))
    for g, a in zip(grads, inputs):
        assert g.dtype == a.dtype  # bf16 gradients of bf16 operands, as JAX returns them
    port = [out, *grads]
    names = ["out", "dx", "dW_in", "db_in", "dW_rs", "db_rs", "dg"][: len(port)]
    worst = max(held_to_gap(n, _np(p), b, f)
                for n, p, b, f in zip(names, port, res[jnp.bfloat16], res[jnp.float32]))
    assert worst < 0.5


def test_flow_block_bf16_recompute_within_half_of_jax_gap(tmp_path):
    """One flow block in bf16 in recompute mode (``block_forward`` with
    ``residuals="recompute"`` on CPU tensors: the plain version of bf16
    rows 9 and 11) against JAX ``flow_block_fused(residuals="recompute")``
    with x bf16 (interpret mode: ``_block_fwd_kernel`` and
    ``_block_bwd_kernel``): z, ld and the gradients of x and of every raw
    block parameter within half of JAX's gap; and bit for bit the port's
    own store mode (the JAX package's bf16 recompute equals its store bit
    for bit too)."""
    config = tiny_config()
    jparams, tmodel, hp = _checkpoint(tmp_path, config)
    c = hp.out_channels * hp.n_sqz
    x, mask = _inputs(20, c, seed=5)
    rng = np.random.default_rng(6)
    bp_j = jax.tree_util.tree_map(lambda a: a[1], jparams["decoder"]["blocks"])
    dz = rng.standard_normal((3, 20, c)).astype(np.float32)
    dld = rng.standard_normal((3,)).astype(np.float32)
    res = {}
    for dt in (jnp.bfloat16, jnp.float32):
        def f(bp, xx):
            return block_pallas.flow_block_fused(
                bp, xx, jnp.asarray(mask, dt), None, hidden_channels=hp.h_dec,
                dilation_rate=hp.dilation_rate, n_layers=hp.n_block_layers, n_split=hp.n_split,
                sigmoid_scale=hp.sigmoid_scale, interpret=True, residuals="recompute",
            )

        (z, ld), vjp = jax.vjp(f, bp_j, jnp.asarray(x, dt))
        d_bp, d_x = vjp((jnp.asarray(dz, z.dtype), jnp.asarray(dld, ld.dtype)))
        res[dt] = {"z": z, "ld": ld, "x": d_x, **flatten(jax.tree_util.tree_map(np.asarray, d_bp))}

    port = {}
    for residuals in ("recompute", "store"):
        flat_t = {k: v.clone().requires_grad_(True)
                  for k, v in flatten(tree_index(tmodel.tree()["decoder"]["blocks"], 1)).items()}
        xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
        folded = block_cuda.fold_block_params(unflatten(flat_t), hp.n_block_layers, hp.n_split,
                                              BF16)
        z_t, ld_t = block_cuda.block_forward(
            folded, None, xt, torch.from_numpy(mask), hp.kernel_size_dec, hp.dilation_rate,
            hp.sigmoid_scale, residuals=residuals,
        )
        assert z_t.dtype == BF16 and ld_t.dtype == torch.float32
        grads = torch.autograd.grad((z_t, ld_t), [*flat_t.values(), xt],
                                    (torch.from_numpy(dz).to(BF16), torch.from_numpy(dld)))
        port[residuals] = {"z": z_t, "ld": ld_t, "x": grads[-1], **dict(zip(flat_t, grads))}
    for k, v in port["recompute"].items():
        assert torch.equal(v, port["store"][k]), k
    recompute = port["recompute"]
    assert max(held_to_gap(k, _np(recompute[k]), res[jnp.bfloat16][k], res[jnp.float32][k])
               for k in recompute) < 0.5


def _corpus_batches(tmp_path, t_x=50, t_y=320):
    """Four batches of two utterances of ``scripts/make-synthetic-corpus.py``
    (seed 0: log-mels of mean about -7), cut to t_x phonemes and t_y
    frames."""
    out = tmp_path / "corpus"
    subprocess.run([sys.executable, str(REPO / "scripts" / "make-synthetic-corpus.py"), str(out),
                    "8", "0"], check=True, capture_output=True)
    rows = (out / "phonemes.csv").read_text().splitlines()
    ids = [[int(t) for t in row.split("|")[1].split()][:t_x] for row in rows]
    mels = [np.load(out / "mels" / f"{row.split('|')[0]}.npy")[:, :t_y].T for row in rows]
    return [{"x": np.array(ids[i:i + 2], np.int32), "x_lengths": np.full(2, t_x, np.int32),
             "y": np.stack(mels[i:i + 2]).astype(np.float32),
             "y_lengths": np.full(2, t_y, np.int32)} for i in range(0, 8, 2)]


def test_op_by_op_against_fused_bf16_as_jax(tmp_path):
    """The bf16 losses of ``forward_train`` with the decoder op by op
    against the fused block's, at the width of ``configs/base.json``
    (dropout off) from a DDI'd init (the zero-initialised end convs and
    prenet projection moved, as a step moves them), on four batches of two
    corpus utterances.  Op by op, ActNorm's bias and scale of a log-mel's
    large mean cancel in bf16, where the fused block folds them into one
    product summed in f32, and the alignment's near-ties move the duration
    loss with z.  The port's relative difference of the MLE loss is JAX's
    own within a tenth on every batch (JAX's: 9.6e-4 to 2.6e-3), the
    loss's, on the batch where it is largest, within half of JAX's largest
    (JAX's at most 1.5e-2, the port's 9.3e-3: the near-ties fall apart
    differently).  Three times JAX's largest bound the smoke's op-by-op
    losses on the card (``chip_smoke.MODE_LOSS_RTOL_BF16`` 4.5e-2,
    ``MODE_MLE_RTOL_BF16`` 8e-3)."""
    from glow_tts_train_tpu import checkpoint as jax_checkpoint
    from glow_tts_train_tpu.config import TrainingConfig
    from glow_tts_train_tpu.models import glow_tts as jax_model
    from glow_tts_train_tpu.models.losses import duration_loss as jax_duration_loss
    from glow_tts_train_tpu.models.losses import mle_loss as jax_mle_loss
    from glow_tts_train_tpu_torch import checkpoint, training
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import glow_tts as model
    from glow_tts_train_tpu_torch.models.losses import duration_loss, mle_loss

    base = REPO / "configs" / "base.json"
    batches = _corpus_batches(tmp_path)

    def configs(fuse):
        out = (load_config([base]), TrainingConfig.load_and_merge(TrainingConfig(), [base]))
        for c in out:
            c.model.p_dropout = c.model.p_dropout_dec = 0.0
            c.encoder_fuse, c.wn_impl, c.wn_residuals = True, "pallas", "store"
            c.flow_block_fuse = fuse
        return out

    def port_batch(batch):
        return training.batch_to({k: v.astype(np.int64) if v.dtype == np.int32 else v
                                  for k, v in batch.items()}, "cpu")

    flat = {k: v.detach() for k, v in training.initialize_model(
        configs(True)[0], port_batch(batches[0]), "cpu").flat().items()}
    g = torch.Generator().manual_seed(0)
    for k in flat:
        if "coupling/end" in k or "prenet/proj" in k:
            flat[k] = flat[k] + 0.02 * torch.randn(flat[k].shape, generator=g)
    path = tmp_path / "checkpoint.npz"
    checkpoint.save_npz(path, {checkpoint.PREFIX + k: v.numpy() for k, v in flat.items()})
    jparams = jax_checkpoint.load_checkpoint(path, configs(True)[1], load_optimizer=False).params
    hyper = {fuse: (model.hyper_from_config(configs(fuse)[0]),
                    jax_model.hyper_from_config(configs(fuse)[1])) for fuse in (True, False)}
    gaps = {"jax": [], "port": []}
    for batch in batches:
        tb = port_batch(batch)
        losses = {}
        for fuse, (hp, jhp) in hyper.items():
            (z, zm, zl, ld, zmask), _, (_, logw, logw_) = jax_model.forward_train(
                jparams, jhp, batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
                compute_dtype=jnp.bfloat16,
            )
            losses["jax", fuse] = (float(jax_mle_loss(z, zm, zl, ld, zmask)),
                                   float(jax_duration_loss(logw, logw_, batch["x_lengths"])))
            with torch.no_grad():
                (z, zm, zl, ld, zmask), _, (_, logw, logw_) = model.forward_train(
                    unflatten(flat), hp, tb["x"], tb["x_lengths"], tb["y"], tb["y_lengths"],
                    compute_dtype=BF16,
                )
            losses["port", fuse] = (float(mle_loss(z, zm, zl, ld, zmask)),
                                    float(duration_loss(logw, logw_, tb["x_lengths"])))
        for who in gaps:
            (mf, df), (mu, du) = losses[who, True], losses[who, False]
            gaps[who].append((abs(mu + du - mf - df) / abs(mf + df), abs(mu - mf) / abs(mf)))
    for (port_loss, port_mle), (jax_loss, jax_mle) in zip(gaps["port"], gaps["jax"]):
        assert abs(port_mle - jax_mle) <= 0.1 * jax_mle, (port_mle, jax_mle)
    worst = {who: [max(g[i] for g in gaps[who]) for i in (0, 1)] for who in gaps}
    assert abs(worst["port"][0] - worst["jax"][0]) <= 0.5 * worst["jax"][0], worst
    for i, chip_rtol in ((0, 4.5e-2), (1, 8e-3)):  # the loss, the MLE loss
        assert 0.0 < 3 * worst["jax"][i] <= chip_rtol, worst


def _products(plan):
    return [(p["name"], p["kind"], p["shape"], p["unit"], p["chunks"]) for p in plan["products"]]


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
def test_plan_of_the_six_entry_points(with_g):
    """``tc_gemm.bf16_block_products`` at base width (c 160, h 192, 4 WN
    layers, taps 5, [32, 704]): row 9 runs row 10's products, one device
    operation fewer (no copy of zp into z); row 11 the forward-save's
    products but the coupling, then row 12's; the WN stack's rows 5 and 6
    the block forward's WN products after one copy of x, rows 7 and 8 the
    walk (row 7 after rows 6's products), with one launch that takes the
    output's cotangent into g_rs; every product on the TMA-fed kernels, the folded A's too (the WN
    layers' forward products on the warp-specialised one); the device operations a call."""
    base = (32, 704, 160, 192, 4, 5, 1, SMS)
    wn = (32, 704, 0, 192, 4, 5, 1, SMS)
    plan = {
        10: tc_gemm.bf16_block_products(*base),
        9: tc_gemm.bf16_block_products(*base, saves=False),
        12: tc_gemm.bf16_block_products(*base, backward=True, with_g=with_g),
        11: tc_gemm.bf16_block_products(*base, backward=True, with_g=with_g, recompute=True),
        6: tc_gemm.bf16_block_products(*wn),
        5: tc_gemm.bf16_block_products(*wn, saves=False),
        8: tc_gemm.bf16_block_products(*wn, backward=True, with_g=with_g),
        7: tc_gemm.bf16_block_products(*wn, backward=True, with_g=with_g, recompute=True),
    }
    assert _products(plan[9]) == _products(plan[10])
    assert plan[9]["launches"] == plan[10]["launches"] - 1 == 13
    forward_save = [p for p in _products(plan[10]) if p[0] != "coupling"]
    assert _products(plan[11]) == forward_save + _products(plan[12])
    assert plan[11]["launches"] == plan[12]["launches"] + 10
    wn_fwd = [p for p in forward_save if p[0].startswith(("in_", "res_skip_"))]
    assert _products(plan[5]) == _products(plan[6]) == wn_fwd
    assert plan[5]["launches"] == plan[6]["launches"] == 9
    walk = [p for p in _products(plan[12]) if p[0].split("_")[0] in ("gate", "dW", "transposed")
            and p[0] not in ("dW_e", "dW_s")]
    assert _products(plan[8]) == walk
    assert _products(plan[7]) == wn_fwd + walk
    assert plan[7]["launches"] == plan[8]["launches"] + 9
    # two launches a weight gradient (the product, one reduction with its
    # bias's and dg's sums): the conditioning adds none
    assert plan[12]["launches"] == 36 and plan[11]["launches"] == 46
    assert plan[8]["launches"] == 26 and plan[7]["launches"] == 35
    for r in (12, 11, 8, 7):
        assert all(p["launches"] == 2 for p in plan[r]["products"] if p["kind"] == "wgrad")
    counts = {r: p["counts"] for r, p in plan.items()}
    assert counts[9] == counts[10] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                                       "bf16_tma_gemm": 3, "bf16_tma_wgrad": 0,
                                       "bf16_ws_gemm": 8}
    assert counts[11] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                          "bf16_tma_gemm": 14, "bf16_tma_wgrad": 11, "bf16_ws_gemm": 8}
    assert counts[5] == counts[6] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                                      "bf16_tma_gemm": 0, "bf16_tma_wgrad": 0,
                                      "bf16_ws_gemm": 8}
    assert counts[8] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                         "bf16_tma_gemm": 8, "bf16_tma_wgrad": 8, "bf16_ws_gemm": 0}
    assert counts[7] == {"core_gemm": 0, "bf16_gemm": 0, "bf16_wgrad": 0,
                         "bf16_tma_gemm": 8, "bf16_tma_wgrad": 8, "bf16_ws_gemm": 8}


def test_plan_declines_narrow_widths_in_every_row():
    """At narrow widths (h 48, c 16) the six rows' products take the
    mma.sync kernels, as rows 10 and 12 do."""
    for c in (16, 0):
        for kw in ({}, {"saves": False}, {"backward": True},
                   {"backward": True, "recompute": True}):
            plan = tc_gemm.bf16_block_products(4, 96, c, 48, 2, 5, 1, SMS, **kw)
            assert (plan["counts"]["bf16_tma_gemm"] == plan["counts"]["bf16_tma_wgrad"]
                    == plan["counts"]["bf16_ws_gemm"] == 0)
            assert all(p["unit"] in ("mma", "core") for p in plan["products"]), (c, kw)

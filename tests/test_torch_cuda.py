"""The CUDA kernels of glow_tts_train_tpu_torch on a GPU, against their
plain PyTorch versions on the same inputs, the kernel path of
``forward_gen`` against the plain path on the CPU, and the training
kernels (the WN stack forward with dropout, forward-save, backward-store
and recompute backward; the flow block forward, forward-save,
backward-store and recompute backward; MAS; and the text side's forward
kernels with dropout and backward kernels: prenet, encoder layer, duration
stack) against their plain versions and autograd, a recompute backward's
gradients equal to the store backward's bit for bit, and the training
graph in every decoder mode against the same graph on the CPU.

Every test here needs an NVIDIA GPU (the kernels have no CPU mode) and
skips without one.  The file imports no jax, so on a GPU machine without
the JAX package's dependencies it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: kernel vs plain version 1e-5 max abs error on O(1) outputs
(f32 both, summation order only; TF32 off for the plain version's cuBLAS
and cuDNN calls); the whole mel 1e-4 (two inverse flow blocks each
scaling by exp(-logs)); block gradients 1e-4 of the gradient's max
magnitude (reductions over all rows in another order); MAS paths exactly.
The text kernels with dropout on: outputs 1e-5 of the output's max (the
keep masks are equal bit for bit, so no element differs by a dropped
value), every gradient 1e-4 of its own max at equal ReLU gates (a ReLU
input within rounding of zero may open in one version only; the gates
themselves are compared, see ``ops/text_cuda.py``); two runs of a backward
kernel give the same bits (fixed-order reductions, no atomics).
"""

import contextlib

import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch import checkpoint, kernels, training
from glow_tts_train_tpu_torch.config import AudioConfig, ModelConfig, TrainingConfig
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import (
    block_cuda, encoder_cuda, flows, mas_cuda, text_cuda, wn_cuda,
)
from glow_tts_train_tpu_torch.ops.conv import conv1d
from glow_tts_train_tpu_torch.tree import tree_index, tree_map

pytestmark = pytest.mark.cuda


def tiny_config(**model_overrides) -> TrainingConfig:
    """The tests' tiny model (the widths of tests/helpers.py, which imports
    the JAX package's config and so is not used here)."""
    model_config = ModelConfig(
        num_symbols=20, hidden_channels=16, filter_channels=32, filter_channels_dp=16,
        kernel_size=3, p_dropout=0.1, n_blocks_dec=2, n_layers_enc=2, n_heads=2,
        p_dropout_dec=0.05, dilation_rate=1, kernel_size_dec=5, n_block_layers=2, n_sqz=2,
        prenet=True, mean_only=True, hidden_channels_enc=16, hidden_channels_dec=16,
        window_size=4, n_speakers=1, n_split=4,
    )
    for k, v in model_overrides.items():
        setattr(model_config, k, v)
    return TrainingConfig(
        model=model_config, audio=AudioConfig(mel_channels=8), batch_size=4,
        bucket_size_text=1, bucket_size_mel=1,
    )

ATOL = 1e-5
MEL_ATOL = 1e-4

# tiny widths (h = 16: every GEMM narrower than one 64-column tile), and
# the base widths of configs/base.json (h = 192, f = 768, f_dp = 256,
# 80 mel channels) with 2 layers and 2 blocks
TINY = {}
BASE = dict(
    hidden_channels=192, hidden_channels_enc=192, hidden_channels_dec=192,
    filter_channels=768, filter_channels_dp=256, n_block_layers=4,
)
VARIANTS = {
    "tiny": (TINY, 8),
    "tiny_sigmoid_gin_dilation2": (
        dict(sigmoid_scale=True, n_speakers=3, gin_channels=8, dilation_rate=2), 8
    ),
    "base_width": (BASE, 80),
    "base_width_sigmoid_gin_dilation2": (
        dict(BASE, sigmoid_scale=True, n_speakers=3, gin_channels=256, dilation_rate=2),
        80,
    ),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config(over, n_mel):
    config = tiny_config(**over)
    config.audio.mel_channels = n_mel
    return config


def _tree(hp, seed=0):
    """The torch param tree of one random checkpoint (all leaves non-zero)."""
    tree: dict = {}
    for key, a in checkpoint.random_params(hp, seed).items():
        *parents, leaf = key[len("model/"):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(a)
    return tree


def _inputs(b, t, c, dev, seed=1):
    """x [b, t, c] and a ragged mask [b, t, 1] (sample 0 full length, one
    sample of length 1: fully masked query rows)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(dev)
    lengths = torch.tensor([t, max(1, t // 2), 1][:b], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()[..., None]
    return x, mask


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_kernels_match_plain(dev, name):
    """Each of the four kernels against its plain version on the same CUDA
    inputs; t = 37 is no multiple of any tile; each wrapper launches once."""
    over, n_mel = VARIANTS[name]
    hp = model.hyper_from_config(_config(over, n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp))
    x, mask = _inputs(3, 37, hp.h_enc, dev)
    before = kernels.launch_counts()

    pw = text_cuda.prenet_weights(tt["prenet"])
    _close(text_cuda.prenet(pw, x, mask), text_cuda.prenet_plain(pw, x, mask))
    ew = encoder_cuda.fold_encoder_layer(tree_index(tt["encoder"], 0))
    _close(
        encoder_cuda.encoder_layer(ew, x, mask, hp.n_heads, hp.window_size),
        encoder_cuda.encoder_layer_plain(ew, x, mask, hp.n_heads, hp.window_size),
    )
    dw = text_cuda.dp_weights(tt["proj_w"])
    xd = torch.cat([x, torch.ones(3, 37, hp.gin_channels, device=dev)], -1)
    _close(text_cuda.duration_stack(dw, xd, mask), text_cuda.duration_stack_plain(dw, xd, mask))
    L, h = hp.n_block_layers, hp.h_dec
    bw = block_cuda.split_inverse_weights(block_cuda.fold_block_params_inverse(
        tree_index(tt["decoder"]["blocks"], 0), L, hp.n_split
    ))
    xb = torch.randn(3, 37, 2 * hp.out_channels, device=dev) * mask
    g_all = torch.randn(3, L, 2 * h, device=dev) if hp.gin_channels else None
    args = (bw, g_all, xb, mask, hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale)
    _close(block_cuda.block_inverse(*args), block_cuda.block_inverse_plain(*args))

    after = kernels.launch_counts()
    serving = ("prenet", "encoder_layer", "duration_stack", "block_inverse")
    assert {k: after[k] - before[k] for k in serving} == {k: 1 for k in serving}


@pytest.mark.parametrize(
    "over",
    [{}, {"mean_only": False, "n_speakers": 3, "gin_channels": 8, "sigmoid_scale": True},
     {"prenet": False, "dilation_rate": 2}],
    ids=["base", "multispeaker_mean_sigmoid", "no_prenet_dilation2"],
)
def test_forward_gen_kernel_path_matches_plain_path(dev, over):
    """forward_gen with the kernels (CUDA tensors) against the plain path
    (CPU tensors): same weights, ids and eps; y_lengths identical."""
    hp = model.hyper_from_config(tiny_config(**over))
    w_cpu = model.store_inverse(checkpoint.params_from_numpy(
        checkpoint.random_params(hp, 0), hp), hp)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(1, hp.n_vocab, size=(3, 11)))
    xl = torch.tensor([11, 6, 9])
    x[1, 6:] = 0
    x[2, 9:] = 0
    g_ids = torch.tensor([0, 2, 1]) if hp.n_speakers > 1 else None
    eps = torch.from_numpy(rng.standard_normal((3, 72, hp.out_channels)).astype(np.float32))
    outs = []
    for d, w in ((dev, w_cpu.to(dev)), (torch.device("cpu"), w_cpu)):
        out = model.forward_gen(
            w, hp, x.to(d), xl.to(d), 72, noise_scale=0.667, length_scale=1.1,
            g_ids=None if g_ids is None else g_ids.to(d), eps=eps.to(d),
        )
        outs.append(out)
    (cu, cpu) = outs
    # a duration within 1e-4 of an integer could ceil differently
    dur = (torch.exp(cpu[2][1]) * 1.1)[:, :, 0]
    valid = torch.arange(11)[None] < xl[:, None]
    assert (dur - dur.round()).abs()[valid].min() > 1e-4, "pick another seed"
    assert torch.equal(cu[3].cpu(), cpu[3])
    _close(cu[2][1], cpu[2][1])  # logw
    _close(cu[0][0], cpu[0][0], MEL_ATOL)  # mel
    assert torch.isfinite(cu[0][0]).all()


def test_cuda_serves_configs_the_encoder_kernel_does_not_take_op_by_op(dev):
    """``window_size: null``, which the encoder kernel does not take, serves
    on the card with its encoder layers op by op (no encoder-layer launch;
    the prenet, duration stack and inverse blocks through their kernels),
    equal to the CPU path: logw, y_lengths and the mel."""
    hp = model.hyper_from_config(tiny_config(window_size=None))
    assert not hp.encoder_kernel_fits
    w_cpu = model.store_inverse(checkpoint.params_from_numpy(
        checkpoint.random_params(hp, 0), hp), hp)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(1, hp.n_vocab, size=(2, 11)))
    xl = torch.tensor([11, 7])
    x[1, 7:] = 0
    eps = torch.from_numpy(rng.standard_normal((2, 72, hp.out_channels)).astype(np.float32))
    outs = []
    for d, w in ((dev, w_cpu.to(dev)), (torch.device("cpu"), w_cpu)):
        before = kernels.launch_counts()
        outs.append(model.forward_gen(w, hp, x.to(d), xl.to(d), 72, noise_scale=0.667,
                                      eps=eps.to(d)))
        if d.type == "cuda":
            after = kernels.launch_counts()
            launched = {k: after[k] - before[k]
                        for k in ("prenet", "encoder_layer", "duration_stack", "block_inverse")}
            assert launched == {"prenet": 1, "encoder_layer": 0, "duration_stack": 1,
                                "block_inverse": hp.n_blocks_dec}
    (cu, cpu) = outs
    assert torch.equal(cu[3].cpu(), cpu[3])
    _close(cu[2][1], cpu[2][1])  # logw
    _close(cu[0][0], cpu[0][0], MEL_ATOL)  # mel
    assert torch.isfinite(cu[0][0]).all()


def test_wrappers_check_their_operands(dev):
    hp = model.hyper_from_config(tiny_config())
    pw = text_cuda.prenet_weights(tree_map(lambda a: a.to(dev), _tree(hp))["prenet"])
    x, mask = _inputs(2, 9, hp.h_enc, dev)
    with pytest.raises(ValueError, match="not contiguous"):
        text_cuda.prenet(pw, x.transpose(0, 1).contiguous().transpose(0, 1), mask)
    with pytest.raises(ValueError, match="float32"):
        text_cuda.prenet(pw, x.double(), mask)
    with pytest.raises(ValueError, match="x_mask"):
        text_cuda.prenet(pw, x, mask[:, :5].contiguous())


def _rel_close(name, port, ref, rtol, floor=1e-6):
    """max abs err within rtol of max |ref| (or of ``floor``, for a gradient
    that is zero but for rounding)."""
    err = (port - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= rtol * max(scale, floor), f"{name}: max abs err {err} vs max |ref| {scale}"


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("p_dropout", [0.0, 0.3])
def test_training_block_kernels_match_plain(dev, name, p_dropout):
    """The WN forward against its plain version; the block forward-save
    (z, ld and every saved residual) against the plain forward and the
    backward-store (every gradient) against autograd of the plain forward,
    with the same dropout seed; the autograd Function end to end."""
    over, n_mel = VARIANTS[name]
    hp = model.hyper_from_config(_config(over, n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp))
    L, h, c = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels
    folded = {
        k: v.detach().contiguous()
        for k, v in block_cuda.fold_block_params(
            tree_index(tt["decoder"]["blocks"], 0), L, hp.n_split
        ).items()
    }
    x, mask = _inputs(3, 37, c, dev)
    x = (x * mask).contiguous()
    g_all = torch.randn(3, L, 2 * h, device=dev) if hp.gin_channels else None
    args = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale, p_dropout, 2 ** 31 - 3)
    before = kernels.launch_counts()

    wn = (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"])
    xh = (torch.randn(3, 37, h, device=dev) * mask).contiguous()
    _close(
        wn_cuda.wn_stack(wn, g_all, xh, mask, hp.kernel_size_dec, hp.dilation_rate),
        wn_cuda.wn_stack_plain(wn, g_all, xh, mask, hp.kernel_size_dec, hp.dilation_rate),
    )

    z, ld, saves = block_cuda.block_fwd_save(folded, g_all, x, mask, *args)
    ref_saves: dict = {}
    z_p, ld_p = block_cuda.block_forward_plain(folded, g_all, x, mask, *args, saves=ref_saves)
    _rel_close("z", z, z_p, 1e-5)
    _rel_close("ld", ld, ld_p, 1e-5)
    for k in ("zp", "skipm"):
        _rel_close(k, saves[k], ref_saves[k], 1e-5)
    for k in ("xs", "th", "sg"):
        _rel_close(k, saves[k], torch.stack(ref_saves[k]), 1e-5)

    fp = {k: v.clone().requires_grad_(True) for k, v in folded.items()}
    xp = x.clone().requires_grad_(True)
    gp = None if g_all is None else g_all.clone().requires_grad_(True)
    zz, ll = block_cuda.block_forward_plain(fp, gp, xp, mask, *args)
    dz = torch.randn_like(zz)
    dld = torch.randn_like(ll)
    inputs = [xp] + [fp[k] for k in block_cuda.FOLD_KEYS] + ([gp] if gp is not None else [])
    ref = torch.autograd.grad((zz * dz).sum() + (ll * dld).sum(), inputs)
    grads = block_cuda.block_bwd_store(folded, g_all is not None, x, mask, saves, dz, dld, *args)
    names = ["dx"] + ["d" + k for k in block_cuda.FOLD_KEYS] + (["dg"] if gp is not None else [])
    for n, r in zip(names, ref):
        _rel_close(n, grads[n], r, 1e-4)

    fk = {k: v.clone().requires_grad_(True) for k, v in folded.items()}
    xk = x.clone().requires_grad_(True)
    zk, lk = block_cuda.block_forward(fk, g_all, xk, mask, *args)
    gk = torch.autograd.grad((zk * dz).sum() + (lk * dld).sum(), [xk, fk["W_in"]])
    _rel_close("fn dx", gk[0], ref[0], 1e-4)
    _rel_close("fn dW_in", gk[1], ref[1 + block_cuda.FOLD_KEYS.index("W_in")], 1e-4)

    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in ("wn_forward", "block_fwd_save", "block_bwd_store")} == {
        "wn_forward": 1, "block_fwd_save": 2, "block_bwd_store": 2
    }


def _block_inputs(dev, name, requires_g=True):
    over, n_mel = VARIANTS[name]
    hp = model.hyper_from_config(_config(over, n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp))
    L, h, c = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels
    folded = {
        k: v.detach().contiguous()
        for k, v in block_cuda.fold_block_params(
            tree_index(tt["decoder"]["blocks"], 0), L, hp.n_split
        ).items()
    }
    x, mask = _inputs(3, 37, c, dev)
    g_all = torch.randn(3, L, 2 * h, device=dev) if hp.gin_channels else None
    return hp, folded, (x * mask).contiguous(), mask, g_all


def _launched(before, names):
    after = kernels.launch_counts()
    return {k: after[k] - before[k] for k in names}


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("p_dropout", [0.0, 0.3])
def test_wn_train_kernels_match_plain(dev, name, p_dropout):
    """The WN stack's kernels: the forward with dropout and the
    forward-save (skip sum and every saved residual) against the plain
    stack; the backward-store (dx, dW_in, db_in, dW_rs, db_rs, dg) against
    autograd of the plain stack with the same seed; the recompute backward
    equal to it bit for bit; and the autograd Function in both modes."""
    hp, folded, _, mask, g_all = _block_inputs(dev, name)
    L, h = hp.n_block_layers, hp.h_dec
    wn = (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"])
    x = (torch.randn(3, 37, h, device=dev) * mask).contiguous()
    args = (hp.kernel_size_dec, hp.dilation_rate, p_dropout, 2 ** 31 - 3)
    before = kernels.launch_counts()

    ref_saves: dict = {}
    skip_p = wn_cuda.wn_stack_plain(wn, g_all, x, mask, *args, saves=ref_saves)
    _rel_close("skip", wn_cuda.wn_stack(wn, g_all, x, mask, *args), skip_p, 1e-5)
    skip, saves = wn_cuda.wn_fwd_save(wn, g_all, x, mask, *args)
    _rel_close("skip (save)", skip, skip_p, 1e-5)
    for k in ("xs", "th", "sg"):
        _rel_close(k, saves[k], torch.stack(ref_saves[k]), 1e-5)

    wp = [w.clone().requires_grad_(True) for w in wn]
    xp = x.clone().requires_grad_(True)
    gp = None if g_all is None else g_all.clone().requires_grad_(True)
    dout = torch.randn_like(x)
    inputs = [xp, *wp] + ([gp] if gp is not None else [])
    ref = torch.autograd.grad(
        (wn_cuda.wn_stack_plain(tuple(wp), gp, xp, mask, *args) * dout).sum(), inputs
    )
    store = wn_cuda.wn_bwd_store(wn[0], wn[2], g_all is not None, mask, saves, dout, *args)
    names = ["dx", "dW_in", "db_in", "dW_rs", "db_rs"] + (["dg"] if gp is not None else [])
    for n, r in zip(names, ref):
        _rel_close(n, store[n], r, 1e-4)
    recompute = wn_cuda.wn_bwd(wn, g_all, x, mask, dout, *args)
    for n in names:
        assert torch.equal(recompute[n], store[n]), f"{n}: recompute differs from store"
    assert recompute["dg"] is None or gp is not None

    for residuals in ("store", "recompute"):
        wk = [w.clone().requires_grad_(True) for w in wn]
        xk = x.clone().requires_grad_(True)
        out = wn_cuda.wn_stack_train(tuple(wk), g_all, xk, mask, *args, residuals)
        gk = torch.autograd.grad((out * dout).sum(), [xk, *wk])
        for n, g in zip(names, gk):
            assert torch.equal(g, store[n]), f"{residuals} {n}"
    with torch.no_grad():  # nothing to differentiate: the forward kernel alone
        wn_cuda.wn_stack_train(wn, g_all, x, mask, *args, "store")
    assert _launched(before, ("wn_forward", "wn_fwd_save", "wn_bwd_store", "wn_bwd")) == {
        "wn_forward": 3, "wn_fwd_save": 2, "wn_bwd_store": 2, "wn_bwd": 2}


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("p_dropout", [0.0, 0.3])
def test_block_recompute_kernels_match_store(dev, name, p_dropout):
    """The block forward that saves nothing gives the forward-save kernel's
    z and ld bit for bit (and the plain version's within 1e-5); the
    recompute backward gives the backward-store kernel's gradients bit for
    bit (same launches on the same inputs); the autograd Function in
    recompute mode, and a forward with gradients off, launch those two."""
    hp, folded, x, mask, g_all = _block_inputs(dev, name)
    args = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale, p_dropout, 2 ** 31 - 3)
    before = kernels.launch_counts()
    z_s, ld_s, saves = block_cuda.block_fwd_save(folded, g_all, x, mask, *args)
    z, ld = block_cuda.block_fwd(folded, g_all, x, mask, *args)
    assert torch.equal(z, z_s) and torch.equal(ld, ld_s)
    z_p, ld_p = block_cuda.block_forward_plain(folded, g_all, x, mask, *args)
    _rel_close("z", z, z_p, 1e-5)
    _rel_close("ld", ld, ld_p, 1e-5)
    dz, dld = torch.randn_like(z), torch.randn_like(ld)
    store = block_cuda.block_bwd_store(folded, g_all is not None, x, mask, saves, dz, dld, *args)
    recompute = block_cuda.block_bwd(folded, g_all, x, mask, dz, dld, *args)
    assert set(store) == set(recompute)
    for n, g in store.items():
        if g is None:
            assert recompute[n] is None and g_all is None, n
        else:
            assert torch.equal(recompute[n], g), f"{n}: recompute differs from store"

    fk = {k: v.clone().requires_grad_(True) for k, v in folded.items()}
    xk = x.clone().requires_grad_(True)
    zk, lk = block_cuda.block_forward(fk, g_all, xk, mask, *args, "recompute")
    gk = torch.autograd.grad((zk * dz).sum() + (lk * dld).sum(), [xk, *fk.values()])
    assert torch.equal(gk[0], store["dx"])
    for k, g in zip(fk, gk[1:]):
        assert torch.equal(g, store["d" + k]), k
    with torch.no_grad():
        zn, _ = block_cuda.block_forward(fk, g_all, xk, mask, *args, "store")
    assert torch.equal(zn, z)
    assert _launched(before, ("block_fwd", "block_fwd_save", "block_bwd", "block_bwd_store")) == {
        "block_fwd": 3, "block_fwd_save": 1, "block_bwd": 2, "block_bwd_store": 1}


def test_recompute_holds_one_blocks_residuals(dev):
    """Peak memory of forward + backward through 6 blocks at base width:
    store mode holds every block's xs/th/sg (3 L b t h floats each) until
    its backward; recompute mode holds them inside one backward call only."""
    hp, folded, _, _, _ = _block_inputs(dev, "base_width")
    b, t, c, n_blocks = 8, 256, 2 * hp.out_channels, 6
    x0 = torch.randn(b, t, c, device=dev)
    mask = torch.ones(b, t, 1, device=dev)
    args = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale, 0.05, 5)
    residual_bytes = 3 * hp.n_block_layers * b * t * hp.h_dec * 4
    peaks = {}
    for residuals in ("store", "recompute"):
        fk = {k: v.clone().requires_grad_(True) for k, v in folded.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        x = x0
        for _ in range(n_blocks):
            x, _ = block_cuda.block_forward(fk, None, x, mask, *args, residuals)
        torch.autograd.grad(x.sum(), list(fk.values()))
        torch.cuda.synchronize()
        peaks[residuals] = torch.cuda.max_memory_allocated() - base
    assert peaks["store"] >= n_blocks * residual_bytes
    assert peaks["store"] - peaks["recompute"] >= (n_blocks - 2) * residual_bytes, peaks


@pytest.mark.parametrize("shape", [
    (4, 7, 13), (3, 16, 16), (2, 25, 80), (1, 1, 1), (16, 60, 300), (2, 1100, 2300),
    (3, 31, 40), (3, 33, 50), (2, 65, 90), (2, 512, 600), (2, 513, 600),
])
def test_mas_kernel_matches_plain(dev, shape):
    """Paths equal bit for bit, ragged lengths and integer (tied) logp
    included, the extreme-negative case, text widths around a warp's 32
    lanes, one warp's 512 rows (16 a lane) and 513 (two warps' bands), and
    t_x 1100 (three bands, the stay bits in device memory)."""
    b, t_x, t_y = shape
    rng = np.random.default_rng(t_x)
    for case in ("normal", "ties", "extreme"):
        logp = rng.standard_normal((b, t_x, t_y)).astype(np.float32) * 3.0
        if case == "ties":
            logp = np.round(logp)
        if case == "extreme":
            logp = logp - np.float32(2e8)
        t_xs = rng.integers(1, t_x + 1, size=b)
        t_ys = np.maximum(rng.integers(1, t_y + 1, size=b), t_xs)
        t_ys[0], t_xs[0] = t_y, min(t_x, t_y)
        mask = np.zeros((b, t_x, t_y), np.float32)
        for i in range(b):
            mask[i, : t_xs[i], : t_ys[i]] = 1.0
        lp, mk = torch.from_numpy(logp), torch.from_numpy(mask)
        got = mas_cuda.maximum_path(lp.to(dev), mk.to(dev)).cpu()
        if t_x * t_y <= 513 * 600:
            expected = mas_cuda.maximum_path_plain(lp, mk)
        else:  # the plain loop is slow at this size; the kernel's own structure
            expected = None
            p = got.numpy()
            for i in range(b):
                rows = p[i, : t_xs[i], : t_ys[i]].argmax(0)
                assert (p[i].sum(0)[: t_ys[i]] == 1).all()
                assert rows[0] == 0 and rows[-1] == t_xs[i] - 1
                assert ((np.diff(rows) >= 0) & (np.diff(rows) <= 1)).all()
        if expected is not None:
            assert torch.equal(got, expected), case


def _mas_numpy(logp: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The column scan of ``glow_tts_train_tpu/ops/mas.py`` (:193) in numpy
    f32, vectorised over the text, one sample at a time: v[x] = max(v[x],
    v[x - 1]) + logp[x, y] for x <= y (-1e9 above the diagonal and as
    v[-1]), ties stay, forced to stay outside the mask; the backtrace moves
    up a row unless the cell stays, never at row 0, always where row ==
    column."""
    b, t_x, t_y = logp.shape
    neg = np.float32(-1e9)
    rows = np.arange(t_x)
    path = np.zeros((b, t_x, t_y), np.float32)
    for i in range(b):
        value = (logp[i] * mask[i]).astype(np.float32)
        tx, ty = int(mask[i, :, 0].sum()), int(mask[i, 0, :].sum())
        v = np.zeros(t_x, np.float32)
        stay = np.ones((t_y, t_x), bool)
        for y in range(t_y):
            v0 = np.concatenate([[neg], v[:-1]])
            s = v >= v0
            v = np.where(rows <= y, np.where(s, v, v0) + value[:, y], neg).astype(np.float32)
            stay[y] = np.where(mask[i, :, y] > 0, s, True)
        index = max(tx - 1, 0)
        for y in range(t_y - 1, -1, -1):
            if y >= ty:
                continue
            path[i, index, y] = 1.0
            move = index != 0 and (index == y or not stay[y, index])
            index -= int(move)
    return path * mask


@pytest.mark.parametrize("shape", [(2, 1344, 1400), (2, 1345, 1400), (2, 2600, 2700),
                                   (1, 4096, 4200)])
def test_mas_kernel_takes_long_texts(dev, shape):
    """Texts past the short path's shared-memory ring (from t_x 1,345 on
    the H100) take the long path, rows in passes through device memory: the
    paths equal the numpy oracle bit for bit, ragged (sample 1) and tied
    scores included, and a sample with fewer frames than phonemes, and
    only device memory bounds the shape."""
    b, t_x, t_y = shape
    rng = np.random.default_rng(t_x)
    words = kernels.mas_bits_words(b, t_x, t_y, torch.device(dev))
    assert words > 0 if t_x >= 1345 else words >= 0, words
    for case in ("normal", "ties", "fewer frames than phonemes"):
        logp = rng.standard_normal(shape).astype(np.float32) * 3.0
        if case == "ties":
            logp = np.round(logp)
        mask = np.zeros(shape, np.float32)
        mask[0] = 1.0
        if b > 1:  # the last case's sample 1 starts its backtrace above the diagonal
            mask[1, : t_x - 37, : t_y - 11 if case != "fewer frames than phonemes" else t_x // 2] = 1.0
        got = mas_cuda.maximum_path(torch.from_numpy(logp).to(dev), torch.from_numpy(mask).to(dev))
        np.testing.assert_array_equal(got.cpu().numpy(), _mas_numpy(logp, mask), err_msg=case)


def _gates_agree(name, kernel_gates, plain_saves):
    """The kernel's ReLU gates against the plain version's: they may differ
    only where the ReLU's input is within rounding of zero (1e-5 of its
    max), and at no more than a handful of elements."""
    assert len(kernel_gates) == len(plain_saves["gates"])
    for l, (gk, gp, pre) in enumerate(zip(kernel_gates, plain_saves["gates"], plain_saves["pre"])):
        differ = gk != gp
        assert int(differ.sum()) <= 8, f"{name} layer {l}: {int(differ.sum())} gates differ"
        if differ.any():
            assert pre[differ].abs().max() <= 1e-5 * pre.abs().max(), f"{name} layer {l}"


def _check_text_kernel(name, fwd, fwd_plain, bwd, bwd_plain, weights, x, mask, dout, cfg):
    """Forward kernel vs plain (1e-5 of max); the backward's gates vs the
    plain version's; every gradient vs autograd of the plain version at the
    kernel's gates (1e-4 of its max); and the backward's bits twice."""
    _rel_close(f"{name} out", fwd(weights, x, mask, *cfg), fwd_plain(weights, x, mask, *cfg), 1e-5)
    saves, plain_saves = {}, {}
    grads = bwd(weights, x, mask, dout, *cfg, saves=saves)
    bwd_plain(weights, x, mask, dout, *cfg, saves=plain_saves)
    _gates_agree(name, saves["gates"], plain_saves)
    ref = bwd_plain(weights, x, mask, dout, *cfg, gates=saves["gates"])
    assert len(grads) == len(ref) == 1 + len(weights)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g.shape == r.shape
        # the key bias shifts every score of a row alike, so its gradient
        # is zero but for rounding: held to the query bias's scale
        floor = ref[2].abs().max().item() if (name, i) == ("encoder_layer", 4) else 1e-6
        _rel_close(f"{name} grad {i}", g, r, 1e-4, floor)
    again = bwd(weights, x, mask, dout, *cfg)
    for i, (g, r) in enumerate(zip(grads, again)):
        assert torch.equal(g, r), f"{name} grad {i} differs between two runs"


@pytest.mark.parametrize("t", [37, 64])
@pytest.mark.parametrize("p_dropout", [0.0, 0.5])
@pytest.mark.parametrize("name", ["tiny", "base_width", "base_width_sigmoid_gin_dilation2"])
def test_text_train_kernels_match_plain(dev, name, p_dropout, t):
    """Prenet, encoder layer and duration stack: forward with dropout and
    the backward kernels against their plain versions, and each
    autograd.Function end to end (raw-tree gradients through the folds)."""
    over, n_mel = VARIANTS[name]
    hp = model.hyper_from_config(_config(over, n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp))
    x, mask = _inputs(3, t, hp.h_enc, dev)  # the last sample is one frame long
    rng = np.random.default_rng(5)
    seed = 2 ** 31 - 5

    def cot(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    before = kernels.launch_counts()
    pw = text_cuda.prenet_weights(tt["prenet"])
    _check_text_kernel(
        "prenet", text_cuda.prenet, lambda w, a, m, p, s: text_cuda.prenet_plain(w, a, m, p, seed=s),
        text_cuda.prenet_bwd, text_cuda.prenet_bwd_plain, pw, x, mask, cot(*x.shape),
        (p_dropout, seed),
    )
    ew = encoder_cuda.fold_encoder_layer(tree_index(tt["encoder"], 1))
    _check_text_kernel(
        "encoder_layer",
        lambda w, a, m, *c: encoder_cuda.encoder_layer(w, a, m, hp.n_heads, hp.window_size, *c),
        lambda w, a, m, *c: encoder_cuda.encoder_layer_plain(w, a, m, hp.n_heads, hp.window_size, *c),
        lambda w, a, m, d, *c, **k: encoder_cuda.encoder_layer_bwd(
            w, a, m, d, hp.n_heads, hp.window_size, *c, **k),
        lambda w, a, m, d, *c, **k: encoder_cuda.encoder_layer_bwd_plain(
            w, a, m, d, hp.n_heads, hp.window_size, *c, **k),
        ew, x, mask, cot(*x.shape), (p_dropout, seed),
    )
    dw = text_cuda.dp_weights(tt["proj_w"])
    xd = torch.cat([x, torch.ones(3, t, hp.gin_channels, device=dev)], -1).contiguous()
    _check_text_kernel(
        "duration_stack", text_cuda.duration_stack,
        lambda w, a, m, p, s: text_cuda.duration_stack_plain(w, a, m, p, seed=s),
        text_cuda.duration_stack_bwd, text_cuda.duration_stack_bwd_plain, dw, xd, mask,
        cot(3, t, hp.filter_channels_dp), (p_dropout, seed),
    )
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in (
        "prenet", "prenet_bwd", "encoder_layer", "encoder_layer_bwd",
        "duration_stack", "duration_stack_bwd")} == {
        "prenet": 1, "prenet_bwd": 2, "encoder_layer": 1, "encoder_layer_bwd": 2,
        "duration_stack": 1, "duration_stack_bwd": 2}


def _forward_train_on_both(dev, config, p_dropout):
    """forward_train on the card and on the CPU from the same params, batch
    and seeds -> (hp, card outputs, CPU outputs, launches on the card)."""
    hp = model.hyper_from_config(config)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(1, hp.n_vocab, size=(3, 11)))
    xl = torch.tensor([11, 6, 9])
    y = torch.from_numpy(rng.standard_normal((3, 40, hp.out_channels)).astype(np.float32))
    yl = torch.tensor([40, 26, 34])
    g_ids = torch.tensor([0, 2, 1]) if hp.n_speakers > 1 else None
    outs = []
    launches = None
    for d in (dev, torch.device("cpu")):
        before = kernels.launch_counts()
        tt = tree_map(lambda a: a.to(d).requires_grad_(True), _tree(hp))
        (z, z_m, z_logs, logdet, z_mask), _, (attn, logw, logw_) = model.forward_train(
            tt, hp, x.to(d), xl.to(d), y.to(d), yl.to(d),
            g_ids=None if g_ids is None else g_ids.to(d),
            seed_generator=torch.Generator().manual_seed(7) if p_dropout else None,
        )
        loss = (z * z).mean() + (z_m * z_m).mean() + logdet.mean() + ((logw - logw_) ** 2).mean()
        flat = dict(_flatten(tt))
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        outs.append((z, z_m, logw, attn, dict(zip(flat, grads))))
        if launches is None:
            after = kernels.launch_counts()
            launches = {k: after[k] - before[k] for k in after}
    cu, cpu = outs
    assert torch.equal(cu[3].cpu(), cpu[3])
    for i in range(3):
        _rel_close(f"output {i}", cu[i].cpu(), cpu[i], 1e-4)
    for k, g in cpu[4].items():
        if g is None:
            assert cu[4][k] is None, k
        else:  # attn/k/b: zero but for rounding, see _check_text_kernel
            floor = cpu[4]["encoder/attn/q/b"].abs().max().item() if k == "encoder/attn/k/b" else 1e-6
            _rel_close(k, cu[4][k].cpu(), g, 1e-3, floor)
    return hp, launches


@pytest.mark.parametrize("p_dropout", [0.0, 0.1])
def test_forward_train_fused_text_side_matches_cpu(dev, p_dropout):
    """forward_train with encoder_fuse on the card (text kernels, block
    kernels, MAS) against the same graph on the CPU (plain versions), same
    seeds: outputs and every raw-param gradient of a scalar of them."""
    hp, launches = _forward_train_on_both(
        dev, tiny_config(p_dropout=p_dropout, p_dropout_dec=p_dropout), p_dropout
    )
    assert hp.encoder_fuse
    n = hp.n_layers_enc
    text = ("prenet", "prenet_bwd", "encoder_layer", "encoder_layer_bwd",
            "duration_stack", "duration_stack_bwd")
    assert {k: launches[k] for k in text} == {
        "prenet": 1, "prenet_bwd": 1, "encoder_layer": n, "encoder_layer_bwd": n,
        "duration_stack": 1, "duration_stack_bwd": 1}


DECODER_MODES = {
    "fused_store": ({}, {"block_fwd_save": 1, "block_bwd_store": 1}),
    "fused_recompute": ({"wn_residuals": "recompute"}, {"block_fwd": 1, "block_bwd": 1}),
    "unfused_store": ({"flow_block_fuse": False}, {"wn_fwd_save": 1, "wn_bwd_store": 1}),
    "unfused_recompute": (
        {"flow_block_fuse": False, "wn_residuals": "recompute"}, {"wn_forward": 1, "wn_bwd": 1}),
}


@pytest.mark.parametrize("over", [{}, {"n_speakers": 3, "gin_channels": 8, "sigmoid_scale": True}],
                         ids=["base", "gin_sigmoid"])
@pytest.mark.parametrize("mode", sorted(DECODER_MODES))
def test_forward_train_decoder_modes_match_cpu(dev, mode, over):
    """forward_train in each decoder mode on the card against the same
    graph on the CPU, dropout on with the same seeds; the mode's kernels
    launch once per block and the other modes' kernels not at all."""
    keys, per_block = DECODER_MODES[mode]
    config = tiny_config(p_dropout=0.1, p_dropout_dec=0.1, **over)
    for key, value in keys.items():
        setattr(config, key, value)
    hp, launches = _forward_train_on_both(dev, config, 0.1)
    decoder = ("wn_forward", "wn_fwd_save", "wn_bwd_store", "wn_bwd",
               "block_fwd", "block_fwd_save", "block_bwd_store", "block_bwd")
    assert {k: launches[k] for k in decoder} == {
        k: per_block.get(k, 0) * hp.n_blocks_dec for k in decoder}


@pytest.mark.parametrize("over", [{}, {"n_speakers": 3, "gin_channels": 8, "dilation_rate": 2}],
                         ids=["base", "gin_dilation2"])
def test_decoder_inv_inverts_the_op_by_op_forward_on_the_card(dev, over):
    """The inverse block kernels give back y from the z of the op-by-op
    decoder_fwd (gradients off: the WN forward kernel, once per block)."""
    hp = model.hyper_from_config(tiny_config(**over))
    tree = checkpoint.params_from_numpy(checkpoint.random_params(hp, 0), hp).to(dev).tree()
    blocks = tree["decoder"]["blocks"]
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal((2, 64, hp.out_channels)).astype(np.float32)).to(dev)
    mask = (torch.arange(64, device=dev)[None, :] < torch.tensor([64, 40], device=dev)[:, None])
    mask = mask.to(torch.float32)[..., None]
    y = y * mask
    g = None
    if hp.gin_channels:
        g = torch.from_numpy(rng.standard_normal((2, 1, hp.gin_channels)).astype(np.float32)).to(dev)
    n, L, h = hp.n_blocks_dec, hp.n_block_layers, hp.h_dec
    before = kernels.launch_counts()
    with torch.inference_mode():
        z, _ = flows.decoder_fwd(blocks, y, mask, g=g, n_split=hp.n_split, block_fuse=False,
                                 **model._decoder_kwargs(hp))
        folded, cond = flows.decoder_store_inverse(blocks, L, hp.n_split)
        g_all = None
        if g is not None:
            g_all = [conv1d(g, c).reshape(2, L, 2 * h).contiguous() for c in cond]
        y_back = flows.decoder_inv(
            folded, z, mask, kernel_size=hp.kernel_size_dec, dilation_rate=hp.dilation_rate,
            n_sqz=hp.n_sqz, sigmoid_scale=hp.sigmoid_scale, g_all=g_all,
        )
    assert _launched(before, ("block_inverse", "wn_forward", "wn_fwd_save")) == {
        "block_inverse": n, "wn_forward": n, "wn_fwd_save": 0}
    _close(y_back, y, MEL_ATOL)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# the tensor-core conv-GEMM and weight-gradient GEMM (csrc/tc_gemm.cu)
# ---------------------------------------------------------------------------

# a 3xTF32 product against float64 of the same operands, relative to the
# largest output (each term loses what lies below 2^-20 of it)
PRODUCT_RTOL = 5e-6

# (batch, t, c_in, taps, dilation, tap_sign, n, a_mask): tiny and ragged
# shapes (rows not a multiple of 64, widths below and off the tile sizes,
# K not a multiple of the 32-deep slice), then the base width's products
CONV_CASES = {
    "tiny": (2, 50, 8, 1, 1, 1, 8, False),
    "ragged_rows": (3, 37, 16, 3, 1, 1, 24, False),
    "n80": (2, 75, 192, 1, 1, 1, 80, False),
    "k80_masked": (2, 131, 80, 1, 1, 1, 192, True),
    "dilation2": (2, 90, 12, 5, 2, 1, 40, False),
    "transposed": (2, 90, 24, 5, 2, -1, 12, False),
    "base_in_conv": (4, 704, 192, 5, 1, 1, 384, False),
    "base_in_conv_dilation4": (4, 704, 192, 5, 4, 1, 384, False),
    "base_res_skip": (4, 704, 192, 1, 1, 1, 384, False),
    "base_transposed": (4, 704, 384, 5, 1, -1, 192, False),
    "base_fold": (4, 704, 160, 1, 1, 1, 160, False),
    "base_end_masked": (4, 704, 192, 1, 1, 1, 160, True),
}


def _product_inputs(dev, seed, batch, t, c_in, n, k):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((batch, t, c_in)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)).to(dev)
    lengths = torch.tensor([t, max(1, t // 2), 1, t - 3][:batch], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()[..., None].contiguous()
    return a, w, mask


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_tc_conv_product_matches_float64(dev, name):
    """The tensor-core conv-GEMM alone against float64 of the same operands
    and against the CUDA-core kernel."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, taps, dilation, tap_sign, n, masked = CONV_CASES[name]
    a, w, mask = _product_inputs(dev, 7, batch, t, c_in, n, taps * c_in)
    a_mask = mask if masked else None
    ref = tc_gemm.im2col_plain(a, taps, dilation, tap_sign, a_mask).double() @ w.double()
    kernels.product_counts(reset=True)
    got = tc_gemm.conv_product(a, w, taps, dilation, tap_sign, a_mask, mode="tc")
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_gemm"], counts["core_gemm"]) == (1, 0)
    core = tc_gemm.conv_product(a, w, taps, dilation, tap_sign, a_mask, mode="core")
    assert kernels.product_counts(reset=True)["core_gemm"] == 1
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale
    assert (got - core).abs().max().item() <= 1e-5 * scale
    emulated = tc_gemm.matmul_3xtf32_plain(
        tc_gemm.im2col_plain(a, taps, dilation, tap_sign, a_mask).reshape(batch * t, -1), w
    ).reshape(batch, t, n)
    assert (got - emulated).abs().max().item() <= 2e-6 * scale


def test_tc_dispatch_by_shape(dev):
    """As the chains dispatch: the tensor-core kernel at the base width's
    products from a few thousand rows on, the CUDA-core kernel for a width
    below one tile and for a few hundred rows; a shape the tensor-core
    kernel cannot take (channels not a multiple of 4) is refused when
    asked for outright."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    def counts_of(fn):
        kernels.product_counts(reset=True)
        fn()
        c = kernels.product_counts(reset=True)
        return c["tc_gemm"] + c["tc_wgrad"], c["declined_gemm"] + c["declined_wgrad"]

    a, w, _ = _product_inputs(dev, 8, 4, 704, 192, 384, 192)
    assert counts_of(lambda: tc_gemm.conv_product(a, w)) == (1, 0)
    assert counts_of(lambda: tc_gemm.weight_gradient(a, a)) == (1, 0)
    narrow = w[:, :16].contiguous()
    assert counts_of(lambda: tc_gemm.conv_product(a, narrow)) == (0, 1)
    assert counts_of(lambda: tc_gemm.weight_gradient(a, a[..., :16].contiguous())) == (0, 1)
    few = a[:1, :300].contiguous()
    assert counts_of(lambda: tc_gemm.conv_product(few, w)) == (0, 1)
    assert counts_of(lambda: tc_gemm.weight_gradient(few[:, :200].contiguous(), few[:, :200].contiguous())) == (0, 1)
    odd_a, odd_w, _ = _product_inputs(dev, 9, 2, 40, 6, 8, 6)
    with pytest.raises(RuntimeError):
        tc_gemm.conv_product(odd_a, odd_w, mode="tc")
    np.testing.assert_allclose(
        tc_gemm.conv_product(odd_a, odd_w).cpu().numpy(), (odd_a @ odd_w).cpu().numpy(), atol=1e-5
    )


# (batch, t, c_in, taps, dilation, n, a_mask, dy_mask)
WGRAD_CASES = {
    "tiny": (2, 50, 8, 1, 1, 8, False, False),
    "ragged_rows_dy_mask": (3, 37, 16, 3, 1, 24, False, True),
    "n80_both_masks": (2, 300, 192, 1, 1, 80, True, True),
    "dilation2": (2, 90, 12, 5, 2, 40, False, False),
    "base_dW_in": (4, 704, 192, 5, 1, 384, False, False),
    "base_dW_rs": (4, 704, 192, 1, 1, 384, False, False),
    "base_dW_s_dy_mask": (4, 704, 80, 1, 1, 192, False, True),
    "base_dA": (4, 704, 160, 1, 1, 160, False, False),
}


@pytest.mark.parametrize("name", sorted(WGRAD_CASES))
def test_tc_weight_gradient_matches_float64_and_repeats(dev, name):
    """The tensor-core weight-gradient GEMM alone against float64 and the
    CUDA-core kernel; two runs give the same bits (fixed split order, no
    atomics)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, taps, dilation, n, a_masked, dy_masked = WGRAD_CASES[name]
    a, _, mask = _product_inputs(dev, 11, batch, t, c_in, n, taps * c_in)
    dy = torch.from_numpy(
        np.random.default_rng(12).standard_normal((batch, t, n)).astype(np.float32)
    ).to(dev)
    a_mask, dy_mask = (mask if a_masked else None), (mask if dy_masked else None)
    cols = tc_gemm.im2col_plain(a, taps, dilation, 1, a_mask).reshape(batch * t, -1)
    dym = dy if dy_mask is None else dy * dy_mask
    ref = cols.double().T @ dym.reshape(batch * t, n).double()
    kernels.product_counts(reset=True)
    got = tc_gemm.weight_gradient(a, dy, taps, dilation, a_mask, dy_mask, mode="tc")
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_wgrad"], counts["core_wgrad"]) == (1, 0)
    again = tc_gemm.weight_gradient(a, dy, taps, dilation, a_mask, dy_mask, mode="tc")
    assert torch.equal(got, again)
    core = tc_gemm.weight_gradient(a, dy, taps, dilation, a_mask, dy_mask, mode="core")
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale
    assert (got - core).abs().max().item() <= 1e-5 * scale


def test_split_weights_kernel_matches_plain(dev):
    from glow_tts_train_tpu_torch.ops import tc_gemm

    for k, n in ((960, 384), (80, 192), (37, 50)):
        w = torch.randn(k, n, device=dev)
        assert torch.equal(tc_gemm.split_weights(w), tc_gemm.split_weights_plain(w))


@pytest.mark.parametrize("name", ["base_width", "base_width_sigmoid_gin_dilation2"])
def test_block_kernels_on_the_tensor_cores_match_plain(dev, name):
    """The flow block's kernels at a shape whose every product runs on the
    tensor cores ([4, 704, 160], dropout on): forward-save and the inverse
    against their plain versions, backward-store against autograd of the
    plain forward, the recompute backward equal to store's bits, and the
    product counters."""
    over, n_mel = VARIANTS[name]
    hp = model.hyper_from_config(_config(over, n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp))
    L, h, c = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels
    block = tree_index(tt["decoder"]["blocks"], 0)
    folded = {k: v.detach().contiguous()
              for k, v in block_cuda.fold_block_params(block, L, hp.n_split).items()}
    x, mask = _inputs(4, 704, c, dev)
    lengths = torch.tensor([704, 352, 1, 701], device=dev)
    mask = (torch.arange(704, device=dev)[None, :] < lengths[:, None]).float()[..., None].contiguous()
    x = (x * mask).contiguous()
    g_all = torch.randn(4, L, 2 * h, device=dev) if hp.gin_channels else None
    args = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale, 0.3, 12345)

    kernels.product_counts(reset=True)
    z, ld, saves = block_cuda.block_fwd_save(folded, g_all, x, mask, *args)
    counts = kernels.product_counts(reset=True)
    # all but the folded A's product, which stays on the CUDA cores
    assert (counts["tc_gemm"], counts["core_gemm"], counts["declined_gemm"]) == (2 + 2 * L, 1, 0)
    ref_saves: dict = {}
    z_p, ld_p = block_cuda.block_forward_plain(folded, g_all, x, mask, *args, saves=ref_saves)
    _rel_close("z", z, z_p, 1e-5)
    _rel_close("ld", ld, ld_p, 1e-5)
    for k in ("zp", "skipm"):
        _rel_close(k, saves[k], ref_saves[k], 1e-5)
    for k in ("xs", "th", "sg"):
        _rel_close(k, saves[k], torch.stack(ref_saves[k]), 1e-5)

    fp = {k: v.clone().requires_grad_(True) for k, v in folded.items()}
    xp = x.clone().requires_grad_(True)
    gp = None if g_all is None else g_all.clone().requires_grad_(True)
    zz, ll = block_cuda.block_forward_plain(fp, gp, xp, mask, *args)
    dz, dld = torch.randn_like(zz), torch.randn_like(ll)
    inputs = [xp] + [fp[k] for k in block_cuda.FOLD_KEYS] + ([gp] if gp is not None else [])
    ref = torch.autograd.grad((zz * dz).sum() + (ll * dld).sum(), inputs)
    kernels.product_counts(reset=True)
    grads = block_cuda.block_bwd_store(folded, g_all is not None, x, mask, saves, dz, dld, *args)
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_gemm"], counts["tc_wgrad"]) == (4 + 2 * L, 3 + 2 * L)
    assert counts["core_gemm"] + counts["core_wgrad"] == 0
    names = ["dx"] + ["d" + k for k in block_cuda.FOLD_KEYS] + (["dg"] if gp is not None else [])
    for n, r in zip(names, ref):
        _rel_close(n, grads[n], r, 1e-4)
    recomputed = block_cuda.block_bwd(folded, g_all, x, mask, dz, dld, *args)
    for n in names:
        assert torch.equal(recomputed[n], grads[n]), n

    inv = block_cuda.fold_block_params_inverse(block, L, hp.n_split)
    inv = block_cuda.split_inverse_weights({k: v.detach().contiguous() for k, v in inv.items()})
    inv_args = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale)
    kernels.product_counts(reset=True)
    y = block_cuda.block_inverse(inv, g_all, x, mask, *inv_args)
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_gemm"], counts["core_gemm"]) == (3 + 2 * L, 0)
    _rel_close("inverse", y, block_cuda.block_inverse_plain(inv, g_all, x, mask, *inv_args), 1e-5)


# ---------------------------------------------------------------------------
# the text side's products and the encoder layer on the tensor cores
# ---------------------------------------------------------------------------

# the encoder layer's products at t_x < 256: (batch, t, c_in, taps, n, w_t);
# w_t: the transposed product reads the forward conv's weights as they lie
SHORT_CONV_CASES = {
    "ffn1_t64": (16, 64, 192, 3, 768, False),
    "ffn2_t100_ragged": (16, 100, 768, 3, 192, False),
    "ffn2_t192": (16, 192, 768, 3, 192, False),
    "ffn1_t192_transposed": (16, 192, 192, 3, 768, True),
    "qkv_t192": (16, 192, 192, 1, 576, False),
    "dx_t100_transposed": (16, 100, 576, 1, 192, True),
}
# the tensor cores over the whole K walk; as the text chains dispatch
# (split-K where it makes fewer waves)
SHORT_MODES = ("tc", "text")
# the lean of a product: its error along the sign of float64's output,
# relative to the mean magnitude (the tensor cores' accumulator rounds
# toward zero, so a long chain shrinks every output alike): the 3xTF32
# recipe (32-deep slices from zero, big rounded to nearest, small terms
# first) keeps it near 1e-7 (PERF.md)
LEAN_RTOL = 5e-7


def _lean(got, ref):
    return ((got.double() - ref) * ref.sign()).mean().item() / ref.abs().mean().item()


@pytest.mark.parametrize("name", sorted(SHORT_CONV_CASES))
def test_tc_short_conv_variants_match_float64(dev, name):
    """The tensor-core conv-GEMM at the encoder's short, deep shapes, over
    the whole K walk and as the text chains take it (on the unit and with
    the K shares ``text_product_plan`` gives), against float64 of the same
    operands within PRODUCT_RTOL of max |ref|, its lean within LEAN_RTOL,
    and the text chains' bits the same twice (split-K's shares are added in
    a fixed order)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, taps, n, w_t = SHORT_CONV_CASES[name]
    a, _, _ = _product_inputs(dev, 21, batch, t, c_in, n, taps * c_in)
    rng = np.random.default_rng(22)
    shape = (taps * n, c_in) if w_t else (taps * c_in, n)
    w = (rng.standard_normal(shape) / np.sqrt(taps * c_in)).astype(np.float32)
    w = torch.from_numpy(w).to(dev)
    tap_sign = -1 if w_t else 1
    b = tc_gemm.transposed_weights_plain(w, taps) if w_t else w
    ref = tc_gemm.im2col_plain(a, taps, 1, tap_sign).double() @ b.double()
    scale = ref.abs().max().item()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    on_tc, splits = tc_gemm.text_product_plan(batch * t, taps * c_in, n, sms)
    assert on_tc
    outs = {}
    for mode in SHORT_MODES:
        kernels.product_counts(reset=True)
        outs[mode] = got = tc_gemm.conv_product(a, w, taps, 1, tap_sign, mode=mode, w_t=w_t)
        counts = kernels.product_counts(reset=True)
        assert (counts["tc_gemm"], counts["core_gemm"]) == (1, 0), (mode, counts)
        assert (got.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale, mode
        assert abs(_lean(got, ref)) <= LEAN_RTOL, mode
    if splits == 1:
        assert torch.equal(outs["text"], outs["tc"])
    assert torch.equal(outs["text"],
                       tc_gemm.conv_product(a, w, taps, 1, tap_sign, mode="text", w_t=w_t))
    core = tc_gemm.conv_product(a, w, taps, 1, tap_sign, mode="core", w_t=w_t)
    assert (core.double() - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("t", [64, 100, 192])
@pytest.mark.parametrize("c_in,n", [(192, 768), (768, 192)])
def test_tc_short_weight_gradients_match_float64(dev, t, c_in, n):
    """The FFN's weight gradients (K 576 and 2304) over 16 x t rows on the
    tensor cores: within PRODUCT_RTOL of float64, the lean within
    LEAN_RTOL, the same bits twice."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    a, _, _ = _product_inputs(dev, 23, 16, t, c_in, n, 3 * c_in)
    dy = np.random.default_rng(24).standard_normal((16, t, n)).astype(np.float32)
    dy = torch.from_numpy(dy).to(dev)
    cols = tc_gemm.im2col_plain(a, 3, 1).reshape(16 * t, -1)
    ref = cols.double().T @ dy.reshape(16 * t, n).double()
    kernels.product_counts(reset=True)
    got = tc_gemm.weight_gradient(a, dy, 3, 1)
    assert kernels.product_counts(reset=True)["tc_wgrad"] == 1
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale
    assert abs(_lean(got, ref)) <= LEAN_RTOL
    assert torch.equal(got, tc_gemm.weight_gradient(a, dy, 3, 1))


def _base_layer(dev, batch, t, seed=4):
    """Base-width encoder layer weights (the kernels' merged layout), x and
    a ragged mask (one sample at full length, one of a single frame)."""
    hp = model.hyper_from_config(_config(BASE, 80))
    tt = tree_map(lambda a: a.to(dev), _tree(hp, seed))
    weights = encoder_cuda.merge_qkv(encoder_cuda.fold_encoder_layer(tree_index(tt["encoder"], 1)))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, t, hp.h_enc)).astype(np.float32)).to(dev)
    lengths = rng.integers(t // 3, t + 1, size=batch)
    lengths[0], lengths[-1] = t, 1
    mask = (torch.arange(t, device=dev)[None, :] < torch.from_numpy(lengths).to(dev)[:, None])
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(dev)
    return hp, weights, x, mask.float()[..., None].contiguous(), dout


def test_encoder_layer_on_the_tensor_cores_matches_plain(dev):
    """The encoder layer at the training shape [16, 192, 192] (f 768,
    dropout 0.1): every product of the forward (4) and of the backward (4
    recomputed, 4 more and 4 weight gradients) on the tensor cores, none
    declined; the forward within 1e-5 of the plain version's max; the
    backward's recompute equal to the forward bit for bit; every gradient
    within 1e-4 of its max of autograd of the plain version at the kernel's
    ReLU gates; the same bits twice."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    hp, weights, x, mask, dout = _base_layer(dev, 16, 192)
    cfg = (hp.n_heads, hp.window_size, 0.1, 2 ** 31 - 7)
    kernels.product_counts(reset=True)
    out = encoder_cuda.encoder_layer(weights, x, mask, *cfg)
    fwd_counts = kernels.product_counts(reset=True)
    assert fwd_counts == dict(tc_gemm=4, tc_wgrad=0, core_gemm=0, core_wgrad=0,
                              declined_gemm=0, declined_wgrad=0, **tc_gemm.WALK_MODES_NONE)
    plain = encoder_cuda.encoder_layer_plain(weights, x, mask, *cfg)
    _rel_close("encoder_layer out", out, plain, 1e-5)
    saves, plain_saves = {}, {}
    grads = encoder_cuda.encoder_layer_bwd(weights, x, mask, dout, *cfg, saves=saves)
    bwd_counts = kernels.product_counts(reset=True)
    assert bwd_counts == dict(tc_gemm=8, tc_wgrad=4, core_gemm=0, core_wgrad=0,
                              declined_gemm=0, declined_wgrad=0, **tc_gemm.WALK_MODES_NONE)
    assert torch.equal(saves["out"], out)
    encoder_cuda.encoder_layer_bwd_plain(weights, x, mask, dout, *cfg, saves=plain_saves)
    _gates_agree("encoder_layer", saves["gates"], plain_saves)
    ref = encoder_cuda.encoder_layer_bwd_plain(weights, x, mask, dout, *cfg, gates=saves["gates"])
    assert len(grads) == len(ref) == 15
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g.shape == r.shape
        _rel_close(f"encoder_layer grad {i}", g, r, 1e-4)
    again = encoder_cuda.encoder_layer_bwd(weights, x, mask, dout, *cfg)
    for i, (g, r) in enumerate(zip(grads, again)):
        assert torch.equal(g, r), f"grad {i} differs between two runs"


# ---------------------------------------------------------------------------
# the serving flow block and the duration stack on the tensor cores
# ---------------------------------------------------------------------------

# (batch, t): a lone 48-phoneme request, a lone 250-phoneme one, an odd
# length, and four requests at the longest one's length (ragged)
SERVE_BLOCK_CASES = {
    "b1_t160": (1, 160), "b1_t832": (1, 832), "b1_t417": (1, 417), "b4_t832_ragged": (4, 832),
}


def _base_inverse_fold(dev, seed=0):
    hp = model.hyper_from_config(_config(BASE, 80))
    tt = tree_map(lambda a: a.to(dev), _tree(hp, seed))
    folded = block_cuda.fold_block_params_inverse(
        tree_index(tt["decoder"]["blocks"], 0), hp.n_block_layers, hp.n_split)
    return hp, block_cuda.split_inverse_weights({k: v.contiguous() for k, v in folded.items()})


@pytest.mark.parametrize("g", [False, True], ids=["no_g", "g_all"])
@pytest.mark.parametrize("name", sorted(SERVE_BLOCK_CASES))
def test_serving_block_inverse_takes_its_plan(dev, name, g):
    """The serving flow block at base width: each product on the tile and
    K shares the serving plan gives it (``tc_gemm.inverse_product_plan``),
    no weight split at call time (the weights were split at load), the
    output within 1e-4 of the plain version's max, the same bits twice."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    hp, folded = _base_inverse_fold(dev)
    L, h, c = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels
    batch, t = SERVE_BLOCK_CASES[name]
    rng = np.random.default_rng(31)
    lengths = torch.tensor([t, t // 2 + 1, 37, t - 5][:batch], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()[..., None].contiguous()
    x = torch.from_numpy(rng.standard_normal((batch, t, c)).astype(np.float32)).to(dev)
    x = (x * mask).contiguous()
    g_all = None
    if g:
        g_all = torch.from_numpy(
            rng.standard_normal((batch, L, 2 * h)).astype(np.float32)).to(dev)
    args = (hp.kernel_size_dec, hp.dilation_rate, hp.sigmoid_scale)
    kernels.product_counts(reset=True)
    kernels.product_splits(reset=True)
    y = block_cuda.block_inverse(folded, g_all, x, mask, *args)
    counts = kernels.product_counts(reset=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = tc_gemm.block_inverse_products(batch * t, c, h, L, hp.kernel_size_dec, sms)
    want = tc_gemm.plan_counts(plan)
    assert {k: counts[k] for k in want} == want
    assert kernels.product_splits(reset=True) == 0
    _rel_close("block_inverse", y, block_cuda.block_inverse_plain(folded, g_all, x, mask, *args),
               1e-4)
    assert torch.equal(y, block_cuda.block_inverse(folded, g_all, x, mask, *args))


def test_inverse_weight_splits_at_load_equal_the_kernels(dev):
    """The serving weights' splits as ``store_inverse`` makes them on the
    CPU (the plain split, then moved to the card) equal the split kernel's
    own on the card, bit for bit, for each of the block's products."""
    hp = model.hyper_from_config(_config(BASE, 80))
    folded = block_cuda.fold_block_params_inverse(
        tree_index(_tree(hp)["decoder"]["blocks"], 1), hp.n_block_layers, hp.n_split)
    on_cpu = block_cuda.split_inverse_weights(folded)
    on_card = block_cuda.split_inverse_weights({k: v.to(dev) for k, v in folded.items()})
    for key in block_cuda.INVERSE_SPLIT_KEYS:
        assert torch.equal(on_cpu[key + "_split"].to(dev), on_card[key + "_split"]), key


# the serving chain's products alone, as it takes them: (batch, t, c_in,
# taps, n); a lone sentence's (160 and 832 rows, an odd count) in 64- and
# 128-row tiles and K shares as short as 64 deep
SERVE_CONV_CASES = {
    "start_t160": (1, 160, 80, 1, 192),
    "in_conv_t160": (1, 160, 192, 5, 384),
    "in_conv_t832": (1, 832, 192, 5, 384),
    "res_skip_t832": (1, 832, 192, 1, 384),
    "end_t417": (1, 417, 192, 1, 160),
    "fold_t832": (1, 832, 160, 1, 160),
}


@pytest.mark.parametrize("name", sorted(SERVE_CONV_CASES))
def test_tc_serving_products_match_float64(dev, name):
    """The conv-GEMM as the serving chain dispatches it (``mode="serve"``)
    on the unit and tile ``inverse_product_plan`` gives, against float64 of
    the same operands within PRODUCT_RTOL of max |ref|, its lean within
    LEAN_RTOL on the tensor cores, the bits of the same tile and shares
    forced (``conv_product_tiled``), the same bits twice."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, taps, n = SERVE_CONV_CASES[name]
    a, w, _ = _product_inputs(dev, 33, batch, t, c_in, n, taps * c_in)
    ref = tc_gemm.im2col_plain(a, taps, 1).double() @ w.double()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_rows, shares = tc_gemm.inverse_product_plan(batch * t, taps * c_in, n, sms)
    kernels.product_counts(reset=True)
    got = tc_gemm.conv_product(a, w, taps, mode="serve")
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_gemm"], counts["core_gemm"]) == ((1, 0) if tile_rows else (0, 1))
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale
    if tile_rows:
        assert abs(_lean(got, ref)) <= LEAN_RTOL
        # the forced tile and share count the plan sweep runs: the same bits
        assert torch.equal(got, tc_gemm.conv_product_tiled(a, w, taps, tile_rows, shares))
    assert torch.equal(got, tc_gemm.conv_product(a, w, taps, mode="serve"))


@pytest.mark.parametrize("gin", [0, 256])
def test_duration_stack_on_the_tensor_cores_matches_plain(dev, gin):
    """The duration stack at the training shape [16, 192] (f 256, dropout
    0.1; with a 256-channel speaker input the first conv is [3072, 1344,
    256]): the forward's 2 products and the backward's 4 and 2 weight
    gradients on the tensor cores by ``tc_gemm.duration_products``; the
    forward within 1e-5 of the plain version's max; the backward's
    recompute equal to the forward bit for bit; every gradient within 1e-4
    of its max of autograd of the plain version at the kernel's ReLU
    gates; the same bits twice."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    over = dict(BASE, n_speakers=3, gin_channels=gin) if gin else BASE
    hp = model.hyper_from_config(_config(over, 80))
    tt = tree_map(lambda a: a.to(dev), _tree(hp, 6))
    dw = text_cuda.dp_weights(tt["proj_w"])
    rng = np.random.default_rng(6)
    c, f, taps = hp.h_enc + gin, dw[0].shape[1], dw[0].shape[0] // (hp.h_enc + gin)
    lengths = rng.integers(64, 193, size=16)
    lengths[0], lengths[-1] = 192, 1
    mask = (torch.arange(192, device=dev)[None, :] < torch.from_numpy(lengths).to(dev)[:, None])
    mask = mask.float()[..., None].contiguous()
    x = torch.from_numpy(rng.standard_normal((16, 192, c)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((16, 192, f)).astype(np.float32)).to(dev)
    cfg = (0.1, 2 ** 31 - 9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels.product_counts(reset=True)
    out = text_cuda.duration_stack(dw, x, mask, *cfg)
    assert kernels.product_counts(reset=True) == tc_gemm.duration_products(
        16 * 192, c, f, taps, sms, forward=1, backward=0)
    saves = {}
    text_cuda.duration_stack_bwd(dw, x, mask, dout, *cfg, saves=saves)
    assert kernels.product_counts(reset=True) == tc_gemm.duration_products(
        16 * 192, c, f, taps, sms, forward=0, backward=1)
    assert torch.equal(saves["out"], out)
    _check_text_kernel(
        "duration_stack", text_cuda.duration_stack,
        lambda w, a, m, p, s: text_cuda.duration_stack_plain(w, a, m, p, seed=s),
        text_cuda.duration_stack_bwd, text_cuda.duration_stack_bwd_plain, dw, x, mask, dout, cfg,
    )


# ---------------------------------------------------------------------------
# the WN reverse walk (rows 7, 8, 11, 12): its plan and its new modes
# ---------------------------------------------------------------------------


def _device_op_names(fn) -> list:
    """The names of the kernels, fills and copies one call of ``fn`` puts on
    the device, in launch order, by torch.profiler, from a trace in which 16
    spin kernels (``torch.cuda._sleep``) stand on each side of the call.  A
    trace can come back short of records at an edge, or empty, so a trace
    counts only where a spin kernel is left on each side of the call's
    operations (up to 4 are taken)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(1000)
            fn()
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        spin = ["spin" in e.name for e in ops]
        inner = [i for i, is_spin in enumerate(spin) if not is_spin]
        if (inner and any(spin[:inner[0]]) and any(spin[inner[-1]:])
                and not any(spin[inner[0]:inner[-1]])):
            return [ops[i].name for i in inner]
    raise AssertionError("no trace of 4 held a spin kernel on each side of the call's operations")


def _device_operations(fn) -> int:
    """Kernels, fills and copies one call of ``fn`` puts on the device."""
    return len(_device_op_names(fn))


# (config variant, dilation rate, rows: batch x t)
WALK_CASES = {
    "narrow": ("tiny", 1, (3, 37)),
    "narrow_dilation2": ("tiny", 2, (3, 37)),
    "base": ("base_width", 1, (4, 704)),
    "base_dilation2": ("base_width", 2, (4, 701)),
}


@pytest.mark.parametrize("g", [False, True], ids=["no_g", "g_all"])
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_wn_walk_backwards_take_their_plan(dev, name, g):
    """``wn_bwd_store``, ``wn_bwd``, ``block_bwd_store`` and ``block_bwd``
    at narrow and base width, dilation 1 and 2, with and without g
    (dropout on): every gradient within 1e-4 of its max of autograd of the
    plain forward; the recompute backward equal to the store backward bit
    for bit and the same bits twice; the device operations of a call and
    its product counts (the tap-staged transposed convs, the bias rows, dW_in
    from d_xin's split) as ``tc_gemm.walk_products`` plans them."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    variant, rate, (b, t) = WALK_CASES[name]
    over, n_mel = VARIANTS[variant]
    hp = model.hyper_from_config(_config(dict(over, dilation_rate=rate), n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp, 3))
    L, h, c, taps = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels, hp.kernel_size_dec
    folded = {k: v.detach().contiguous() for k, v in block_cuda.fold_block_params(
        tree_index(tt["decoder"]["blocks"], 0), L, hp.n_split).items()}
    x, mask = _inputs(b, t, c, dev, seed=5)
    lengths = torch.tensor([t, t // 2, 1, t - 3][:b], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()[..., None].contiguous()
    x = (x * mask).contiguous()
    g_all = torch.randn(b, L, 2 * h, device=dev) if g else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wn = (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"])
    xw = (torch.randn(b, t, h, device=dev) * mask).contiguous()
    dout = torch.randn_like(xw)
    wcfg = (taps, rate, 0.3, 2 ** 31 - 3)
    bcfg = (taps, rate, hp.sigmoid_scale, 0.3, 2 ** 31 - 3)
    names = ["dx", "dW_in", "db_in", "dW_rs", "db_rs"] + (["dg"] if g else [])

    # the WN stack alone
    _, saves = wn_cuda.wn_fwd_save(wn, g_all, xw, mask, *wcfg)
    wp = [w.clone().requires_grad_(True) for w in wn]
    xp = xw.clone().requires_grad_(True)
    gp = None if g_all is None else g_all.clone().requires_grad_(True)
    ref = torch.autograd.grad(
        (wn_cuda.wn_stack_plain(tuple(wp), gp, xp, mask, *wcfg) * dout).sum(),
        [xp, *wp] + ([gp] if gp is not None else []))
    calls = {
        "wn_bwd_store": (False, lambda: wn_cuda.wn_bwd_store(wn[0], wn[2], g, mask, saves, dout,
                                                             *wcfg)),
        "wn_bwd": (True, lambda: wn_cuda.wn_bwd(wn, g_all, xw, mask, dout, *wcfg)),
    }
    results = {}
    for call, (recompute, fn) in calls.items():
        plan = tc_gemm.walk_products(b * t, 0, h, L, taps, rate, sms, recompute, g)
        kernels.product_counts(reset=True)
        kernels.product_splits(reset=True)
        results[call] = fn()
        assert kernels.product_counts(reset=True) == plan["counts"], call
        assert kernels.product_splits(reset=True) == 0, call
        assert _device_operations(fn) == plan["launches"], call
        again = fn()
        for n in names:
            assert torch.equal(results[call][n], again[n]), f"{call} {n}: different bits twice"
    for n, r in zip(names, ref):
        _rel_close(f"wn {n}", results["wn_bwd_store"][n], r, 1e-4)
        assert torch.equal(results["wn_bwd"][n], results["wn_bwd_store"][n]), n

    # the flow block
    bargs = (folded, g_all, x, mask)
    _, _, bsaves = block_cuda.block_fwd_save(*bargs, *bcfg)
    fp = {k: v.clone().requires_grad_(True) for k, v in folded.items()}
    xq = x.clone().requires_grad_(True)
    gq = None if g_all is None else g_all.clone().requires_grad_(True)
    zz, ll = block_cuda.block_forward_plain(fp, gq, xq, mask, *bcfg)
    dz, dld = torch.randn_like(zz), torch.randn_like(ll)
    bnames = ["dx"] + ["d" + k for k in block_cuda.FOLD_KEYS] + (["dg"] if g else [])
    bref = torch.autograd.grad((zz * dz).sum() + (ll * dld).sum(),
                               [xq] + [fp[k] for k in block_cuda.FOLD_KEYS] + ([gq] if g else []))
    bcalls = {
        "block_bwd_store": (False, lambda: block_cuda.block_bwd_store(
            folded, g, x, mask, bsaves, dz, dld, *bcfg)),
        "block_bwd": (True, lambda: block_cuda.block_bwd(folded, g_all, x, mask, dz, dld, *bcfg)),
    }
    for call, (recompute, fn) in bcalls.items():
        plan = tc_gemm.walk_products(b * t, c, h, L, taps, rate, sms, recompute, g)
        kernels.product_counts(reset=True)
        kernels.product_splits(reset=True)
        results[call] = fn()
        assert kernels.product_counts(reset=True) == plan["counts"], call
        assert kernels.product_splits(reset=True) == 0, call
        assert _device_operations(fn) == plan["launches"], call
        again = fn()
        for n in bnames:
            assert torch.equal(results[call][n], again[n]), f"{call} {n}: different bits twice"
    for n, r in zip(bnames, bref):
        _rel_close(f"block {n}", results["block_bwd_store"][n], r, 1e-4)
        assert torch.equal(results["block_bwd"][n], results["block_bwd_store"][n]), n


# (batch, t, c_in, taps, dilation, n): the walk's transposed conv
WALK_CONV_CASES = {
    "base": (16, 704, 384, 5, 1, 192),
    "base_ragged_dilation4": (3, 701, 384, 5, 4, 192),
    "large": (8, 704, 512, 5, 2, 256),
}


@pytest.mark.parametrize("name", sorted(WALK_CONV_CASES))
def test_tap_staged_transposed_conv_matches_float64(dev, name):
    """The tap-staged conv-GEMM in 128- and 64-row tiles against float64 of
    the same operands (samples that do not fill a tile, a halo across
    sample edges), against the plain emulation of its K order, and the
    walk's dispatch taking it (product counters)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, taps, dilation, n = WALK_CONV_CASES[name]
    a, _, _ = _product_inputs(dev, 21, batch, t, c_in, n, taps * c_in)
    w = torch.from_numpy((np.random.default_rng(22).standard_normal((taps * n, c_in))
                          / np.sqrt(taps * c_in)).astype(np.float32)).to(dev)
    b = tc_gemm.transposed_weights_plain(w, taps)
    cols = tc_gemm.im2col_plain(a, taps, dilation, -1).reshape(batch * t, -1)
    ref = (cols.double() @ b.double()).reshape(batch, t, n)
    scale = ref.abs().max().item()
    order = torch.tensor([tap * c_in + cs * 32 + j for cs in range(c_in // 32)
                          for tap in range(taps) for j in range(32)], device=dev)
    emulated = tc_gemm.matmul_3xtf32_plain(cols[:, order], b[order], slice_k=32)
    for tile in (128, 64):
        got = tc_gemm.conv_product_walk(a, w, taps, dilation, tile, True)
        assert (got.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale, tile
        assert (got.reshape(batch * t, n) - emulated).abs().max().item() <= 2e-6 * scale, tile
    by_tap = tc_gemm.conv_product_walk(a, w, taps, dilation, 128, False)
    assert (by_tap.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale
    kernels.product_counts(reset=True)
    walked = tc_gemm.conv_product(a, w, taps, dilation, -1, mode="walk", w_t=True)
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_gemm"], counts["tap_staged_gemm"]) == (1, 1)
    assert torch.equal(walked, tc_gemm.conv_product_walk(a, w, taps, dilation,
                                                         tc_gemm.TAP_TILE_ROWS, True))


# (batch, t, c_in, taps, dilation, n, dy_mask)
BIAS_WGRAD_CASES = {
    "dW_in": (4, 704, 192, 5, 1, 384, False),
    "dW_in_ragged_dilation2": (3, 701, 192, 5, 2, 384, False),
    "dW_rs": (4, 704, 192, 1, 1, 384, False),
    "dW_s_dy_mask": (4, 704, 80, 1, 1, 192, True),
    "large_dW_rs": (4, 704, 256, 1, 1, 512, False),
    "narrow": (3, 37, 16, 5, 1, 32, True),
}


@pytest.mark.parametrize("name", sorted(BIAS_WGRAD_CASES))
def test_weight_gradient_bias_row_and_split_dy_match_float64(dev, name):
    """The weight gradient with its bias row (the column sums of dY times
    its mask) and, where dY has no mask, reading dY's K-major split: both
    against float64, the same bits twice, and the weight gradient without
    the bias row within the same tolerance (its second pass may add the
    splits in another order, and the bias row may change the split count);
    the product counters."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, taps, dilation, n, masked = BIAS_WGRAD_CASES[name]
    a, _, mask = _product_inputs(dev, 31, batch, t, c_in, n, taps * c_in)
    dy = torch.from_numpy(
        np.random.default_rng(32).standard_normal((batch, t, n)).astype(np.float32)).to(dev)
    dy_mask = mask if masked else None
    cols = tc_gemm.im2col_plain(a, taps, dilation).reshape(batch * t, -1).double()
    dym = (dy if dy_mask is None else dy * dy_mask).reshape(batch * t, n).double()
    ref, ref_b = cols.T @ dym, dym.sum(0)
    on_tc = batch * t >= 256 and n >= 32
    kernels.product_counts(reset=True)
    got, got_b = tc_gemm.weight_gradient(a, dy, taps, dilation, dy_mask=dy_mask, bias=True)
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_wgrad"], counts["bias_wgrad"]) == ((1, 1) if on_tc else (0, 0))
    for out, want in ((got, ref), (got_b, ref_b)):
        assert (out.double() - want).abs().max().item() <= PRODUCT_RTOL * want.abs().max().item()
    plain = tc_gemm.weight_gradient(a, dy, taps, dilation, dy_mask=dy_mask)
    assert (plain.double() - ref).abs().max().item() <= PRODUCT_RTOL * ref.abs().max().item()
    again = tc_gemm.weight_gradient(a, dy, taps, dilation, dy_mask=dy_mask, bias=True)
    assert torch.equal(again[0], got) and torch.equal(again[1], got_b)
    if masked:
        return
    # the K-major split with its rows padded to a multiple of 4, as the gate
    # backward lays d_xin out
    rows = batch * t
    padded = torch.zeros(-(-rows // 4) * 4, n, device=dev)
    padded[:rows] = dy.reshape(rows, n)
    dy_split = tc_gemm.split_weights(padded)
    kernels.product_counts(reset=True)
    got2, got2_b = tc_gemm.weight_gradient(a, dy, taps, dilation, bias=True, dy_split=dy_split)
    counts = kernels.product_counts(reset=True)
    assert counts["split_dy_wgrad"] == (1 if on_tc else 0)
    for out, want in ((got2, ref), (got2_b, ref_b)):
        assert (out.double() - want).abs().max().item() <= PRODUCT_RTOL * want.abs().max().item()
    again = tc_gemm.weight_gradient(a, dy, taps, dilation, bias=True, dy_split=dy_split)
    assert torch.equal(again[0], got2) and torch.equal(again[1], got2_b)


# ---------------------------------------------------------------------------
# the WN forward chains: one weight split a call, the TMA-fed in-layer conv
# ---------------------------------------------------------------------------


def _held_to_forward_plan(call, fn, plan):
    """One forward call against its plan: the product counts, no product
    splitting its own weights, the device operations of a call with the
    one weight-split launch first (none where nothing takes the tensor
    cores), and the same bits twice."""
    kernels.product_counts(reset=True)
    kernels.product_splits(reset=True)
    out = fn()
    assert kernels.product_counts(reset=True) == plan["counts"], call
    assert kernels.product_splits(reset=True) == 0, call
    names = _device_op_names(fn)
    assert len(names) == plan["launches"], (call, names)
    splits = [i for i, n in enumerate(names) if "split_weights_kernel" in n]
    assert splits == ([0] if plan["splits"] else []), (call, splits)
    again = fn()
    for got, want in zip(torch.utils._pytree.tree_leaves(out),
                         torch.utils._pytree.tree_leaves(again)):
        assert torch.equal(got, want), f"{call}: different bits twice"
    return out


@pytest.mark.parametrize("g", [False, True], ids=["no_g", "g_all"])
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_forward_chains_take_their_plan(dev, name, g):
    """``wn_stack``, ``wn_fwd_save``, ``block_fwd`` and ``block_fwd_save`` at
    narrow and base width, dilation 1 and 2, with and without g (dropout
    on): outputs and saves within 1e-4 of the plain version's max; the
    product counts (at base width the in-layer convs TMA-fed), the device
    operations of a call (its one weight-split launch first) as
    ``tc_gemm.forward_products`` plans them; the same bits twice; the
    forward that saves nothing equal to the saving one bit for bit."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    variant, rate, (b, t) = WALK_CASES[name]
    over, n_mel = VARIANTS[variant]
    hp = model.hyper_from_config(_config(dict(over, dilation_rate=rate), n_mel))
    tt = tree_map(lambda a: a.to(dev), _tree(hp, 3))
    L, h, c, taps = hp.n_block_layers, hp.h_dec, 2 * hp.out_channels, hp.kernel_size_dec
    folded = {k: v.detach().contiguous() for k, v in block_cuda.fold_block_params(
        tree_index(tt["decoder"]["blocks"], 0), L, hp.n_split).items()}
    x, mask = _inputs(b, t, c, dev, seed=6)
    lengths = torch.tensor([t, t // 2, 1, t - 3][:b], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()[..., None].contiguous()
    x = (x * mask).contiguous()
    g_all = torch.randn(b, L, 2 * h, device=dev) if g else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wn = (folded["W_in"], folded["b_in"], folded["W_rs"], folded["b_rs"])
    xw = (torch.randn(b, t, h, device=dev) * mask).contiguous()
    wcfg = (taps, rate, 0.3, 2 ** 31 - 5)
    bcfg = (taps, rate, hp.sigmoid_scale, 0.3, 2 ** 31 - 5)

    plan = tc_gemm.forward_products(b * t, 0, h, L, taps, rate, sms)
    tma = 2 * L if tc_gemm.TMA_ONE_TAP else L
    if variant == "base_width":
        assert plan["counts"]["tma_gemm"] == tma and plan["launches"] == 10
    skip = _held_to_forward_plan("wn_stack", lambda: wn_cuda.wn_stack(wn, g_all, xw, mask, *wcfg),
                                 plan)
    save_skip, saves = _held_to_forward_plan(
        "wn_fwd_save", lambda: wn_cuda.wn_fwd_save(wn, g_all, xw, mask, *wcfg), plan)
    assert torch.equal(skip, save_skip)
    ref_saves: dict = {}
    _rel_close("wn skip", skip, wn_cuda.wn_stack_plain(wn, g_all, xw, mask, *wcfg,
                                                       saves=ref_saves), 1e-4)
    for k in ("xs", "th", "sg"):
        _rel_close(f"wn {k}", saves[k], torch.stack(ref_saves[k]), 1e-4)

    plan = tc_gemm.forward_products(b * t, c, h, L, taps, rate, sms)
    z, ld = _held_to_forward_plan(
        "block_fwd", lambda: block_cuda.block_fwd(folded, g_all, x, mask, *bcfg), plan)
    plan = tc_gemm.forward_products(b * t, c, h, L, taps, rate, sms, save=True)
    if variant == "base_width":
        assert plan["counts"]["tma_gemm"] == tma and plan["launches"] == 15
    z_s, ld_s, bsaves = _held_to_forward_plan(
        "block_fwd_save", lambda: block_cuda.block_fwd_save(folded, g_all, x, mask, *bcfg), plan)
    assert torch.equal(z, z_s) and torch.equal(ld, ld_s)
    ref_saves = {}
    z_p, ld_p = block_cuda.block_forward_plain(folded, g_all, x, mask, *bcfg, saves=ref_saves)
    _rel_close("block z", z, z_p, 1e-4)
    _rel_close("block ld", ld, ld_p, 1e-4)
    for k in ("zp", "skipm"):
        _rel_close(f"block {k}", bsaves[k], ref_saves[k], 1e-4)
    for k in ("xs", "th", "sg"):
        _rel_close(f"block {k}", bsaves[k], torch.stack(ref_saves[k]), 1e-4)


def test_tile_order_split_kernel_matches_plain(dev):
    """The weights' split in a paired epilogue's tile order, as the TMA-fed
    kernel reads it: the plain version's bits, which are the natural
    split's rows reordered."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    for k, n in ((960, 384), (1280, 512), (37, 50)):
        w = torch.randn(k, n, device=dev)
        tiled = tc_gemm.split_weights(w, n // 2)
        assert torch.equal(tiled, tc_gemm.split_weights_plain(w, n // 2))
        natural = tc_gemm.split_weights(w)
        assert torch.equal(tiled, natural[:, tc_gemm.physical_cols(n, n // 2).to(dev)])


# (batch, t, c_in, dilation): the WN forward's in-layer conv [rows, 5 c_in, 2 c_in]
FWD_CONV_CASES = {
    "base": (16, 704, 192, 1),
    "ddi": (16, 576, 192, 1),
    "base_ragged_dilation4": (3, 701, 192, 4),
    "large_dilation2": (8, 704, 256, 2),
}


@pytest.mark.parametrize("name", sorted(FWD_CONV_CASES))
def test_tma_conv_matches_float64_and_the_tap_staged_bits(dev, name):
    """The TMA-fed conv-GEMM in 128- and 64-row tiles and clusters of 1, 2
    and 4 row tiles, bare and with the gate's epilogue (its weights split
    in tile order): within PRODUCT_RTOL of float64 of the same operands
    (samples that do not fill a tile, a halo across sample edges, row tiles
    past the last row in the last cluster), equal bit for bit to the
    tap-staged kernel (the same K order and arithmetic); and the forward
    chains' dispatch taking it (product counters)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    batch, t, c_in, dilation = FWD_CONV_CASES[name]
    taps, n = 5, 2 * c_in
    a, w, _ = _product_inputs(dev, 23, batch, t, c_in, n, taps * c_in)
    pre = tc_gemm.im2col_plain(a, taps, dilation).double() @ w.double()
    for gate in (False, True):
        ref = tc_gemm.gate_plain(pre) if gate else pre
        scale = ref.abs().max().item()
        staged = tc_gemm.conv_product_fwd(a, w, taps, dilation, "tap_staged", 64, gate=gate)
        assert (staged.double() - ref).abs().max().item() <= PRODUCT_RTOL * scale
        for tile in (128, 64):
            for cluster in (1, 2, 4):
                got = tc_gemm.conv_product_fwd(a, w, taps, dilation, "tma", tile, cluster, gate)
                assert torch.equal(got, staged), (gate, tile, cluster)
    kernels.product_counts(reset=True)
    fwd = tc_gemm.conv_product(a, w, taps, dilation, mode="fwd")
    counts = kernels.product_counts(reset=True)
    assert (counts["tc_gemm"], counts["tma_gemm"]) == (1, 1)
    assert torch.equal(fwd, tc_gemm.conv_product_fwd(a, w, taps, dilation, "tma",
                                                     tc_gemm.TMA_TILE_ROWS, tc_gemm.TMA_CLUSTER))


# ---------------------------------------------------------------------------
# bf16 (fp16_run): each bf16 kernel against its plain bf16 version
# ---------------------------------------------------------------------------

# relative to max |ref| of each output and gradient: both versions round to
# bf16 where the JAX kernels do, and differ where an f32 sum in another
# order rounds to the neighbouring bf16 value (chip_smoke.BF16_KERNEL_RTOL)
BF16_RTOL = 2e-2
BF16 = torch.bfloat16
# device products of one call of each bf16 kernel at base width, as
# (bf16_gemm, bf16_wgrad, core_gemm, bf16_tma_gemm, bf16_tma_wgrad,
# bf16_ws_gemm): every one on the TMA-fed wgmma kernels, the WN forward's
# in-layer convs and res/skip products on the warp-specialised one
BF16_COUNT_KEYS = ("bf16_gemm", "bf16_wgrad", "core_gemm", "bf16_tma_gemm", "bf16_tma_wgrad",
                   "bf16_ws_gemm")
BF16_PRODUCTS = {
    "prenet": (0, 0, 0, 4, 0, 0), "prenet_bwd": (0, 0, 0, 8, 4, 0),
    "duration_stack": (0, 0, 0, 2, 0, 0), "duration_stack_bwd": (0, 0, 0, 4, 2, 0),
    "encoder_layer": (0, 0, 0, 4, 0, 0), "encoder_layer_bwd": (0, 0, 0, 8, 4, 0),
    "block_fwd_save": (0, 0, 0, 3, 0, 8), "block_bwd_store": (0, 0, 0, 12, 11, 0),
}


def _bf16_held(name, port, ref):
    port, ref = port.float(), ref.float()
    scale = ref.abs().max().item()
    assert scale > 0, f"{name}: zero in the plain version"
    err = (port - ref).abs().max().item()
    assert err <= BF16_RTOL * scale, f"{name}: {err} vs max |ref| {scale}"


def _bf16_products(fn):
    kernels.product_counts(reset=True)
    out = fn()
    torch.cuda.synchronize()
    c = kernels.product_counts(reset=True)
    return out, tuple(c[k] for k in BF16_COUNT_KEYS)


def _bf16_text_inputs(dev, width, t=64, b=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([t, t - 9, t // 2, 5])[:b]
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = (torch.randn(b, t, width, generator=g) * mask).to(BF16)
    return x.to(dev), mask.to(dev), g


@pytest.mark.parametrize("name", ["prenet", "duration_stack", "encoder_layer"])
def test_bf16_text_kernels_match_plain(dev, name):
    """The text side's bf16 kernels at base width (h 192, f 768, f_dp 256)
    against their plain bf16 versions on the card, dropout on: the
    forward's output, the backward's dx and weight gradients at the
    kernel's own ReLU gates, each within BF16_RTOL of its max; the
    gradients of bf16 weights come back bf16; every product on the bf16
    kernels (BF16_PRODUCTS)."""
    h, f, f_dp, heads, window = 192, 768, 256, 2, 4
    x, mask, g = _bf16_text_inputs(dev, h)

    def r(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale + off).to(dtype).to(dev)

    if name == "prenet":
        weights = (r(3, 5 * h, h, scale=(5 * h) ** -0.5, dtype=BF16), r(3, h, scale=0.1),
                   r(3, h, scale=0.1, off=1.0), r(3, h, scale=0.1),
                   r(h, h, scale=h ** -0.5, dtype=BF16), r(1, h, scale=0.1))
        cfg = (0.5, 11)
        fwd, plain, bwd, plain_bwd = (text_cuda.prenet, text_cuda.prenet_plain_bf16,
                                      text_cuda.prenet_bwd, text_cuda.prenet_bwd_plain)
        out_width = h
    elif name == "duration_stack":
        weights = (r(3 * h, f_dp, scale=(3 * h) ** -0.5, dtype=BF16), r(1, f_dp, scale=0.1),
                   r(1, f_dp, scale=0.1, off=1.0), r(1, f_dp, scale=0.1),
                   r(3 * f_dp, f_dp, scale=(3 * f_dp) ** -0.5, dtype=BF16),
                   r(1, f_dp, scale=0.1), r(1, f_dp, scale=0.1, off=1.0), r(1, f_dp, scale=0.1))
        cfg = (0.1, 12)
        fwd, plain, bwd, plain_bwd = (text_cuda.duration_stack, text_cuda.duration_stack_plain_bf16,
                                      text_cuda.duration_stack_bwd,
                                      text_cuda.duration_stack_bwd_plain)
        out_width = f_dp
    else:
        d = h // heads
        weights = (r(h, 3 * h, scale=h ** -0.5, dtype=BF16), r(1, 3 * h, scale=0.1),
                   r(h, h, scale=h ** -0.5, dtype=BF16), r(1, h, scale=0.1),
                   r(2 * window + 1, d, scale=d ** -0.5, dtype=BF16),
                   r(2 * window + 1, d, scale=d ** -0.5, dtype=BF16),
                   r(1, h, scale=0.1, off=1.0), r(1, h, scale=0.1),
                   r(1, h, scale=0.1, off=1.0), r(1, h, scale=0.1),
                   r(3 * h, f, scale=(3 * h) ** -0.5, dtype=BF16), r(1, f, scale=0.1),
                   r(3 * f, h, scale=(3 * f) ** -0.5, dtype=BF16), r(1, h, scale=0.1))
        cfg = (heads, window, 0.1, 13)
        fwd, plain, bwd, plain_bwd = (encoder_cuda.encoder_layer,
                                      encoder_cuda.encoder_layer_plain_bf16,
                                      encoder_cuda.encoder_layer_bwd,
                                      encoder_cuda.encoder_layer_bwd_plain)
        out_width = h
    out, products = _bf16_products(lambda: fwd(weights, x, mask, *cfg))
    assert out.dtype == BF16 and products == BF16_PRODUCTS[name]
    _bf16_held(name, out, plain(weights, x, mask, *cfg))
    dout = r(*x.shape[:2], out_width, dtype=BF16)
    saves = {}
    grads, products = _bf16_products(lambda: bwd(weights, x, mask, dout, *cfg, saves=saves))
    assert products == BF16_PRODUCTS[name + "_bwd"]
    ref = plain_bwd(weights, x, mask, dout, *cfg, gates=saves["gates"])
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert a.dtype == b.dtype, i
        _bf16_held(f"{name}_bwd [{i}]", a, b)


def _bf16_block(dev, c=160, h=192, b=4, t=96, L=4, taps=5):
    """A flow block's bf16 operands at base width (c 160, h 192, 4 WN
    layers, taps 5) over [b, t], three of four samples ragged."""
    torch.manual_seed(0)
    lengths = torch.tensor([t, t - 13, t // 2, 7])[:b]
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None].to(dev)
    x = (torch.randn(b, t, c, device=dev) * mask).to(BF16)
    f32 = {"A": torch.eye(c) + 0.05 * torch.randn(c, c), "bA": 0.1 * torch.randn(1, c),
           "W_s": torch.randn(c // 2, h) * (c // 2) ** -0.5, "b_s": 0.1 * torch.randn(1, h),
           "W_e": 0.05 * torch.randn(h, c), "b_e": 0.05 * torch.randn(1, c),
           "W_in": torch.randn(L, taps * h, 2 * h) * (taps * h) ** -0.5,
           "b_in": 0.1 * torch.randn(L, 2 * h),
           "W_rs": torch.randn(L, h, 2 * h) * h ** -0.5, "b_rs": 0.1 * torch.randn(L, 2 * h)}
    f32["W_rs"][-1, :, :h] = 0.0
    folded = {k: v.to(dev).to(BF16 if k in block_cuda.BF16_OPERANDS else torch.float32)
              for k, v in f32.items()}
    return folded, x, mask, taps


def test_bf16_flow_block_matches_plain(dev):
    """The flow block's bf16 forward-save and backward-store at base width
    (c 160, h 192, 4 WN layers, taps 5) against the plain bf16 forward and
    its autograd, dropout on: z, ld, dx and every folded weight's gradient
    within BF16_RTOL of its max; the saves bf16; the products as
    BF16_PRODUCTS says."""
    folded, x, mask, taps = _bf16_block(dev)
    cfg = (taps, 1, False, 0.05, 21)
    (z, ld, saves), products = _bf16_products(
        lambda: block_cuda.block_fwd_save(folded, None, x, mask, *cfg))
    assert products == BF16_PRODUCTS["block_fwd_save"]
    assert z.dtype == BF16 and all(s.dtype == BF16 for s in saves.values())
    z_p, ld_p = block_cuda.block_forward_plain_bf16(folded, None, x, mask, *cfg)
    _bf16_held("z", z, z_p)
    _bf16_held("ld", ld, ld_p)
    dz = torch.randn(z.shape, device=dev).to(BF16)
    dld = torch.randn(ld.shape, device=dev)
    grads, products = _bf16_products(
        lambda: block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg))
    assert products == BF16_PRODUCTS["block_bwd_store"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
    xl = x.detach().requires_grad_(True)
    zz, ll = block_cuda.block_forward_plain_bf16(leaves, None, xl, mask, *cfg)
    ref = torch.autograd.grad((zz, ll), [xl, *leaves.values()], (dz, dld))
    for name, r in zip(["dx"] + ["d" + k for k in leaves], ref):
        assert grads[name].dtype == r.dtype, name
        _bf16_held(name, grads[name], r)


def test_bf16_block_units_agree_and_repeat_bits(dev):
    """Rows 10 and 12 in bf16 at [4, 704], dropout on: on the TMA-fed
    kernels and, in the same process, on the mma.sync ones (every product
    declined by kernels.bf16_mma_only: the plan's counts both ways) within
    BF16_RTOL of each other (both round each operand once, the same bits;
    only the f32 sums' order differs); and 50 repeats of each row on the
    TMA-fed kernels give the same bits (fixed-order sums, no atomics)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    folded, x, mask, taps = _bf16_block(dev, t=704)
    b, t, c = x.shape
    h = folded["W_s"].shape[1]
    cfg = (taps, 1, False, 0.05, 21)
    dz = torch.randn(x.shape, device=dev).to(BF16)
    dld = torch.randn((b,), device=dev)
    plan = {bw: tc_gemm.bf16_block_products(b, t, c, h, 4, taps, 1, 132, backward=bw)["counts"]
            for bw in (False, True)}
    runs = {}
    for unit in ("tma", "mma"):
        kernels.product_counts(reset=True)
        if unit == "mma":
            with kernels.bf16_mma_only():
                z, ld, saves = block_cuda.block_fwd_save(folded, None, x, mask, *cfg)
                grads = block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg)
        else:
            z, ld, saves = block_cuda.block_fwd_save(folded, None, x, mask, *cfg)
            grads = block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg)
        torch.cuda.synchronize()
        counts = kernels.product_counts(reset=True)
        want = {k: plan[False][k] + plan[True][k] for k in plan[False]}
        if unit == "mma":
            want = {"core_gemm": 0, "bf16_gemm": 23, "bf16_wgrad": 11, "bf16_tma_gemm": 0,
                    "bf16_tma_wgrad": 0}
        assert {k: counts[k] for k in want} == want, (unit, counts)
        runs[unit] = {"z": z, "ld": ld, **saves, **{k: v for k, v in grads.items() if v is not None}}
    for name, ref in runs["mma"].items():
        _bf16_held(f"{name} tma vs mma", runs["tma"][name], ref)
    first = runs["tma"]
    for _ in range(50):
        z, ld, saves = block_cuda.block_fwd_save(folded, None, x, mask, *cfg)
        grads = block_cuda.block_bwd_store(folded, False, x, mask, _saves_of(first), dz, dld, *cfg)
        again = {"z": z, "ld": ld, **saves, **{k: v for k, v in grads.items() if v is not None}}
        assert all(torch.equal(again[k], v) for k, v in first.items())


def _saves_of(run):
    return {k: run[k] for k in ("zp", "skipm", "xs", "th", "sg")}


def _plan_counts(*plans):
    return tuple(sum(p["counts"][k] for p in plans) for k in BF16_COUNT_KEYS)


def _bf16_g_all(dev, b, L, h, with_g):
    if not with_g:
        return None
    return (0.3 * torch.randn(b, L, 2 * h, device=dev)).to(BF16)


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
def test_bf16_flow_block_recompute_rows_match_plain(dev, with_g):
    """bf16 rows 9 and 11 (the flow block's forward that saves nothing and
    its recompute backward) at base width, dropout on, with and without the
    conditioning: z and ld bit for bit those of row 10 (the forward-save),
    every gradient bit for bit row 12's (the backward-store on row 10's
    saves), and within BF16_RTOL of the plain bf16 forward and its
    autograd; each call's products as ``tc_gemm.bf16_block_products``
    plans them."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    folded, x, mask, taps = _bf16_block(dev)
    b, t, c = x.shape
    L, _, h2 = folded["W_in"].shape
    h = h2 // 2
    g_all = _bf16_g_all(dev, b, L, h, with_g)
    cfg = (taps, 1, False, 0.05, 21)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = {k: tc_gemm.bf16_block_products(b, t, c, h, L, taps, 1, sms, **kw) for k, kw in {
        "fwd": {"saves": False}, "bwd": {"backward": True, "recompute": True, "with_g": with_g},
    }.items()}
    (z, ld), products = _bf16_products(lambda: block_cuda.block_fwd(folded, g_all, x, mask, *cfg))
    assert products == _plan_counts(plan["fwd"])
    z_s, ld_s, saves = block_cuda.block_fwd_save(folded, g_all, x, mask, *cfg)
    assert torch.equal(z, z_s) and torch.equal(ld, ld_s)
    z_p, ld_p = block_cuda.block_forward_plain_bf16(folded, g_all, x, mask, *cfg)
    _bf16_held("z", z, z_p)
    _bf16_held("ld", ld, ld_p)
    dz = torch.randn(z.shape, device=dev).to(BF16)
    dld = torch.randn(ld.shape, device=dev)
    grads, products = _bf16_products(
        lambda: block_cuda.block_bwd(folded, g_all, x, mask, dz, dld, *cfg))
    assert products == _plan_counts(plan["bwd"])
    store = block_cuda.block_bwd_store(folded, with_g, x, mask, saves, dz, dld, *cfg)
    for k, v in store.items():
        assert (v is None) == (grads[k] is None) and (v is None or torch.equal(grads[k], v)), k
    leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
    xl = x.detach().requires_grad_(True)
    gl = g_all.detach().requires_grad_(True) if with_g else None
    zz, ll = block_cuda.block_forward_plain_bf16(leaves, gl, xl, mask, *cfg)
    inputs = [xl, *leaves.values()] + ([gl] if with_g else [])
    ref = torch.autograd.grad((zz, ll), inputs, (dz, dld))
    names = ["dx"] + ["d" + k for k in leaves] + (["dg"] if with_g else [])
    for name, r in zip(names, ref):
        assert grads[name].dtype == r.dtype, name
        _bf16_held(name, grads[name], r)


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
def test_bf16_wn_rows_match_plain(dev, with_g):
    """bf16 rows 5-8 (the WN stack alone: the forward, the forward-save, the
    backward-store and the recompute backward) at base width (h 192, 4
    layers, taps 5), dropout on, with and without the conditioning: the
    output bf16(skip) * mask and the saves against ``wn_stack_plain_bf16``,
    every gradient against its autograd with a bf16 cotangent (dx, dW_in,
    dW_rs and dg bf16, the bias gradients f32), each within BF16_RTOL; row
    5's output equal to row 6's bits and row 7's gradients to row 8's; each
    call's products as the plan says."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    folded, _, mask, taps = _bf16_block(dev)
    wn = tuple(folded[k] for k in ("W_in", "b_in", "W_rs", "b_rs"))
    L, _, h2 = wn[0].shape
    h = h2 // 2
    b, t = mask.shape[:2]
    x = (torch.randn(b, t, h, device=dev) * mask).to(BF16)
    g_all = _bf16_g_all(dev, b, L, h, with_g)
    cfg = (taps, 1, 0.05, 21)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = {k: tc_gemm.bf16_block_products(b, t, 0, h, L, taps, 1, sms, **kw) for k, kw in {
        "fwd": {}, "store": {"backward": True, "with_g": with_g},
        "recompute": {"backward": True, "recompute": True, "with_g": with_g},
    }.items()}
    out, products = _bf16_products(lambda: wn_cuda.wn_stack(wn, g_all, x, mask, *cfg))
    assert out.dtype == BF16 and products == _plan_counts(plan["fwd"])
    (out_s, saves), products = _bf16_products(
        lambda: wn_cuda.wn_fwd_save(wn, g_all, x, mask, *cfg))
    assert products == _plan_counts(plan["fwd"]) and torch.equal(out, out_s)
    ref_saves = {}
    _bf16_held("out", out, wn_cuda.wn_stack_plain_bf16(wn, g_all, x, mask, *cfg, saves=ref_saves))
    for k in ("xs", "th", "sg"):
        assert saves[k].dtype == BF16
        _bf16_held(k, saves[k], torch.stack(ref_saves[k]))
    dout = torch.randn(x.shape, device=dev).to(BF16)
    store, products = _bf16_products(
        lambda: wn_cuda.wn_bwd_store(wn[0], wn[2], with_g, mask, saves, dout, *cfg))
    assert products == _plan_counts(plan["store"])
    grads, products = _bf16_products(lambda: wn_cuda.wn_bwd(wn, g_all, x, mask, dout, *cfg))
    assert products == _plan_counts(plan["recompute"])
    for k, v in store.items():
        assert (v is None) == (grads[k] is None) and (v is None or torch.equal(grads[k], v)), k
    leaves = [w.detach().requires_grad_(True) for w in wn]
    xl = x.detach().requires_grad_(True)
    gl = g_all.detach().requires_grad_(True) if with_g else None
    o = wn_cuda.wn_stack_plain_bf16(tuple(leaves), gl, xl, mask, *cfg)
    inputs = [xl, *leaves] + ([gl] if with_g else [])
    ref = torch.autograd.grad(o, inputs, dout)
    names = ["dx", "dW_in", "db_in", "dW_rs", "db_rs"] + (["dg"] if with_g else [])
    for name, r in zip(names, ref):
        assert grads[name].dtype == r.dtype, name
        _bf16_held(name, grads[name], r)


@pytest.mark.parametrize("name,c_in,taps,dilation,tap_sign,n,w_t", [
    ("start", 80, 1, 1, 1, 192, False), ("in_conv", 192, 5, 4, 1, 384, False),
    ("res_skip", 192, 1, 1, 1, 384, False), ("coupling", 192, 1, 1, 1, 160, False),
    ("coupling_bwd", 192, 1, 1, 1, 80, False), ("dskip", 160, 1, 1, 1, 192, True),
    ("gate_bwd", 384, 1, 1, 1, 192, True), ("transposed", 384, 5, 2, -1, 192, True),
    ("dzp", 192, 1, 1, 1, 80, True), ("dx", 160, 1, 1, 1, 160, True),
])
def test_bf16_tma_conv_product_matches_plain(dev, name, c_in, taps, dilation, tap_sign, n, w_t):
    """Each conv-GEMM of bf16 rows 10 and 12 alone on the TMA-fed kernel at
    base width over [3, 200] (ragged tiles: 200 rows a sample against 128
    a tile), taps with dilation and the transposed conv's tap_sign -1, B as
    it lies or per-tap transposed: against float64 of the same bf16
    operands within 1e-5 of max |ref| (f32 sums over K up to 1,920), and
    bit for bit the same on a second call."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    g = torch.Generator().manual_seed(1)
    a = torch.randn(3, 200, c_in, generator=g).to(BF16).to(dev)
    shape = (taps * n, c_in) if w_t else (taps * c_in, n)
    w = (torch.randn(*shape, generator=g) * (taps * c_in) ** -0.5).to(BF16).to(dev)
    ref = tc_gemm.conv_product_plain(a.double(), w.double(), taps, dilation, tap_sign, w_t=w_t)
    kernels.product_counts(reset=True)
    got = tc_gemm.bf16_conv_product(a, w, taps, dilation, tap_sign, w_t, unit="tma")
    torch.cuda.synchronize()
    assert kernels.product_counts(reset=True)["bf16_tma_gemm"] == 1
    assert (got.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), name
    assert torch.equal(got, tc_gemm.bf16_conv_product(a, w, taps, dilation, tap_sign, w_t))


@pytest.mark.parametrize("name,c_in,taps,dilation,n", [
    ("dW_e", 192, 1, 1, 160), ("dW_rs", 192, 1, 1, 384), ("dW_in", 192, 5, 2, 384),
    ("dW_s", 80, 1, 1, 192), ("dA", 160, 1, 1, 160),
])
def test_bf16_tma_wgrad_matches_plain(dev, name, c_in, taps, dilation, n):
    """Each weight gradient of bf16 row 12 alone on the TMA-fed kernel at
    base width over [5, 333] (a sample's last 64-row slice partial, a tap's
    rows past the sample's edge zero): against float64 within 1e-5 of max
    |ref|, the same bits on a second call."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    g = torch.Generator().manual_seed(2)
    a = torch.randn(5, 333, c_in, generator=g).to(BF16).to(dev)
    dy = torch.randn(5, 333, n, generator=g).to(BF16).to(dev)
    ref = tc_gemm.weight_gradient_plain(a.double(), dy.double(), taps, dilation)
    kernels.product_counts(reset=True)
    got = tc_gemm.bf16_weight_gradient(a, dy, taps, dilation, unit="tma")
    torch.cuda.synchronize()
    assert kernels.product_counts(reset=True)["bf16_tma_wgrad"] == 1
    assert (got.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), name
    assert torch.equal(got, tc_gemm.bf16_weight_gradient(a, dy, taps, dilation))


@pytest.mark.parametrize("unit", ["tma", "mma"])
@pytest.mark.parametrize("t", [100, 37])
@pytest.mark.parametrize("name,c_in,taps,dilation,tap_sign,n,w_t", [
    ("in_conv", 192, 5, 4, 1, 384, False), ("coupling", 192, 1, 1, 1, 160, False),
    ("dskip", 160, 1, 1, 1, 192, True), ("transposed", 384, 5, 2, -1, 192, True),
    ("dzp", 192, 1, 1, 1, 80, True),
])
def test_bf16_product_tile_sums_and_reduction(dev, name, c_in, taps, dilation, tap_sign, n, w_t,
                                              t, unit):
    """A bf16 conv-GEMM with a row mask keeps its output's column sums per
    sample and 64-row tile (ConvGemm::sums, as the flow chains' cotangent
    epilogues keep them) on either unit, at t 100 (a ragged last tile a
    sample) and 37 (one), three samples of ragged lengths: the product
    within 1e-5 of max |ref| of float64 (masked), the tile sums within 1e-5
    of max |sum| of ``tc_gemm.tile_sums_plain`` of the kernel's own f32
    output (a masked tile's sum zero); then a weight gradient's reduction
    takes those sums (split at column 64 into its lo and hi parts, and as
    the conditioning's): the bias gradient and dg bit for bit
    ``tc_gemm.sums_of_tiles_plain`` of the same sums (tiles, then samples,
    in order; dg rounded to nearest even), the weight gradient within 1e-5
    of max |ref|; a second call the same bits."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    g = torch.Generator().manual_seed(3)
    batch = 3
    a = torch.randn(batch, t, c_in, generator=g).to(BF16).to(dev)
    shape = (taps * n, c_in) if w_t else (taps * c_in, n)
    w = (torch.randn(*shape, generator=g) * (taps * c_in) ** -0.5).to(BF16).to(dev)
    lengths = torch.tensor([t, t - 13, t // 2 - 9])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None].to(dev)

    def run():
        kernels.product_counts(reset=True)
        out, sums = tc_gemm.bf16_conv_product(a, w, taps, dilation, tap_sign, w_t, unit=unit,
                                              mask=mask, sums=True)
        torch.cuda.synchronize()
        assert kernels.product_counts(reset=True)[
            "bf16_tma_gemm" if unit == "tma" else "bf16_gemm"] == 1
        return out, sums

    out, sums = run()
    ref = tc_gemm.conv_product_plain(a.double(), w.double(), taps, dilation, tap_sign,
                                     w_t=w_t) * mask.double()
    assert (out.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), name
    tiles = -(-t // 64)
    assert sums.shape == (batch, tiles, n)
    want = tc_gemm.tile_sums_plain(out.cpu().reshape(-1, n), batch, t)
    err = (sums.cpu().double() - want.double()).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), (name, err)
    for b in range(batch):
        for i in range(tiles):
            if 64 * i >= lengths[b]:
                assert torch.all(sums[b, i] == 0), (name, b, i)
    dy = out.to(BF16)
    wg_unit = unit if n % 64 == 0 else "mma"
    lo, hi = sums[..., :64].contiguous(), sums[..., 64:].contiguous()
    dw, bias, dg = tc_gemm.bf16_weight_gradient(a, dy, unit=wg_unit, bias_sums=(lo, hi),
                                                g_sums=sums)
    want_bias, per = tc_gemm.sums_of_tiles_plain(sums.cpu())
    assert torch.equal(bias.cpu(), want_bias), name
    assert dg.dtype == BF16 and torch.equal(dg.cpu(), per.to(BF16)), name
    wref = tc_gemm.weight_gradient_plain(a.double(), dy.double())
    assert (dw.double() - wref).abs().max().item() <= 1e-5 * wref.abs().max().item(), name
    out2, sums2 = run()
    assert torch.equal(out2, out) and torch.equal(sums2, sums)
    again = tc_gemm.bf16_weight_gradient(a, dy, unit=wg_unit, bias_sums=(lo, hi), g_sums=sums)
    assert all(torch.equal(x, y) for x, y in zip(again, (dw, bias, dg)))


def _held_rel(name, got, ref, rtol):
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    assert scale > 0 and err <= rtol * scale, f"{name}: {err} against {rtol} of {scale}"


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
def test_bf16_flow_bias_gradients_from_tile_sums(dev, with_g):
    """The bias and conditioning gradients of bf16 rows 8 and 12 (and 7
    and 11, their bits) from the epilogues' tile sums, at base width over
    [4, 100] (t not a multiple of 64: each sample's last tile ragged),
    three samples masked short, dropout on, one WN layer, held within 1e-5
    of max |ref| to the column sums of the plain f32 cotangents, computed
    in float64 from the same saves and the same bf16 operands where no bf16
    copy of a cotangent lies between them and the sum (past such a copy,
    or past a gate the plain forward recomputes, one value's last bit may
    differ between the two and move a sum by more than 1e-5):
    the WN stack's db_rs (the skip half from the stack's cotangent kernel,
    the last layer's res half zero), db_in (the gate backward's d_xin sums,
    dropout's keep mask and scale) and dg (its d_in_act sums, a sample's,
    rounded to bf16: within one bf16 step); the block's db_e (the coupling
    backward's dout sums) and the second half of dbA (its dx1 sums, dzp's),
    with W_e one non-zero a column so that the coupling's recomputed logs
    are exact.  Every gradient also within BF16_RTOL of the plain bf16
    version's autograd."""
    p, seed = 0.05, 21
    folded, _, mask, taps = _bf16_block(dev, t=100, L=1)
    wn = tuple(folded[k] for k in ("W_in", "b_in", "W_rs", "b_rs"))
    L, _, h2 = wn[0].shape
    h = h2 // 2
    b, t = mask.shape[:2]
    x = (torch.randn(b, t, h, device=dev) * mask).to(BF16)
    g_all = _bf16_g_all(dev, b, L, h, with_g)
    cfg = (taps, 1, p, seed)
    _, saves = wn_cuda.wn_fwd_save(wn, g_all, x, mask, *cfg)
    dout = torch.randn(x.shape, device=dev).to(BF16)
    store = wn_cuda.wn_bwd_store(wn[0], wn[2], with_g, mask, saves, dout, *cfg)
    again = wn_cuda.wn_bwd(wn, g_all, x, mask, dout, *cfg)
    for k, v in store.items():
        assert (v is None) == (again[k] is None) and (v is None or torch.equal(again[k], v)), k
    # the walk's one layer in float64 from the saved gates: g_rs = [0, dout * mask]
    m64 = mask.double()
    d_skip = dout.double() * m64
    th, sg = saves["th"][0].double(), saves["sg"][0].double()
    d_acts = d_skip @ wn[2][0][:, h:].double().T
    d_in_act = torch.cat([d_acts * sg * (1 - th * th), d_acts * th * sg * (1 - sg)], -1)
    keep = wn_cuda.regen_keep(seed + torch.arange(b), 0, L, (t, h2), p, dev).double()
    d_xin = d_in_act * keep * wn_cuda.drop_args(p)[2]
    _held_rel("db_in", store["db_in"][0], d_xin.sum((0, 1)), 1e-5)
    _held_rel("db_rs", store["db_rs"][0, h:], d_skip.sum((0, 1)), 1e-5)
    assert torch.all(store["db_rs"][0, :h] == 0)
    if with_g:
        per = d_in_act.sum(1)
        assert store["dg"].dtype == BF16
        assert torch.all((store["dg"][:, 0].double() - per).abs() <= per.abs() * 2.0 ** -7), "dg"
    leaves = [v.detach().requires_grad_(True) for v in wn]
    gl = g_all.detach().requires_grad_(True) if with_g else None
    o = wn_cuda.wn_stack_plain_bf16(tuple(leaves), gl, x, mask, *cfg)
    inputs = leaves + ([gl] if with_g else [])
    names = ["dW_in", "db_in", "dW_rs", "db_rs"] + (["dg"] if with_g else [])
    for name, r in zip(names, torch.autograd.grad(o, inputs, dout)):
        _bf16_held(name, store[name], r)

    folded, x, mask, taps = _bf16_block(dev, t=100, L=1)
    c = x.shape[-1]
    c2 = c // 2
    gen = torch.Generator().manual_seed(4)
    w_e = torch.zeros(h, c)
    w_e[torch.randperm(h, generator=gen)[:c], torch.arange(c)] = 0.3 * torch.randn(c, generator=gen)
    folded["W_e"] = w_e.to(BF16).to(dev)
    bcfg = (taps, 1, False, p, seed)
    _, _, bsaves = block_cuda.block_fwd_save(folded, None, x, mask, *bcfg)
    dz = torch.randn(x.shape, device=dev).to(BF16)
    dld = torch.randn((b,), device=dev)
    grads = block_cuda.block_bwd_store(folded, False, x, mask, bsaves, dz, dld, *bcfg)
    again = block_cuda.block_bwd(folded, None, x, mask, dz, dld, *bcfg)
    for k, v in grads.items():
        assert (v is None) == (again[k] is None) and (v is None or torch.equal(again[k], v)), k
    # the coupling backward in float64 from the saved skipm and zp: out's
    # product exact (one term a column), its bias added and rounded as the
    # kernel does
    out = (bsaves["skipm"].float() @ folded["W_e"].float() + folded["b_e"]).to(BF16).double()
    e = torch.exp(out[..., c2:])
    m64 = mask.double()
    dz1 = dz[..., c2:].double() * m64
    x1 = bsaves["zp"][..., c2:].double()
    dout_b = torch.cat([dz1, dz1 * e * x1 + dld.double()[:, None, None] * m64], -1)
    _held_rel("db_e", grads["db_e"], dout_b.sum((0, 1)), 1e-5)
    _held_rel("dbA second half", grads["dbA"][..., c2:], (dz1 * e).sum((0, 1)), 1e-5)
    leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
    zz, ll = block_cuda.block_forward_plain_bf16(leaves, None, x, mask, *bcfg)
    ref = torch.autograd.grad((zz, ll), list(leaves.values()), (dz, dld))
    for k, r in zip(leaves, ref):
        _bf16_held("d" + k, grads["d" + k], r)


def test_bf16_tma_declines_narrow_widths(dev):
    """Below 64 channels or columns the chains' products take the mma.sync
    kernels, as the plan (``tc_gemm.bf16_block_products``) says, and the
    bare TMA-fed entry refuses the shape."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    folded, x, mask, taps = _bf16_block(dev, c=16, h=48, L=2)
    b, t, c = x.shape
    cfg = (taps, 1, False, 0.0, 0)
    kernels.product_counts(reset=True)
    z, ld, saves = block_cuda.block_fwd_save(folded, None, x, mask, *cfg)
    torch.cuda.synchronize()
    counts = kernels.product_counts(reset=True)
    plan = tc_gemm.bf16_block_products(b, t, c, 48, 2, taps, 1, 132)["counts"]
    assert {k: counts[k] for k in plan} == plan and plan["bf16_tma_gemm"] == 0
    a = torch.zeros(1, 64, 48, dtype=BF16, device=dev)
    with pytest.raises(RuntimeError, match="gtt_bf16_conv_product"):
        tc_gemm.bf16_conv_product(a, torch.zeros(48, 96, dtype=BF16, device=dev), unit="tma")


def test_bf16_refuses_what_it_does_not_take(dev):
    """A bf16 call the kernels cannot take raises (no f32 detour): an f32
    weight beside a bf16 x, in the text kernels and in either residual mode
    of the flow block and of the WN stack alone."""
    x, mask, g = _bf16_text_inputs(dev, 16)
    weights = text_cuda.prenet_weights({
        "layers": {"conv": {"w": torch.randn(3, 5, 16, 16), "b": torch.zeros(3, 16)},
                   "norm": {"gamma": torch.ones(3, 16), "beta": torch.zeros(3, 16)}},
        "proj": {"w": torch.randn(1, 16, 16), "b": torch.zeros(16)},
    })
    weights = tuple(w.to(dev) for w in weights)
    with pytest.raises(ValueError, match="bfloat16"):
        text_cuda.prenet(weights, x, mask)
    folded, xb, mb, taps = _bf16_block(dev, c=16, h=16, L=2)
    folded["W_in"] = folded["W_in"].float()
    wn = tuple(folded[k] for k in ("W_in", "b_in", "W_rs", "b_rs"))
    xw = xb[..., :16].contiguous().requires_grad_(True)
    for residuals in ("store", "recompute"):
        with pytest.raises(ValueError, match="bfloat16"):
            block_cuda.block_forward(folded, None, xb.requires_grad_(True), mb, taps, 1,
                                     residuals=residuals)
        with pytest.raises(ValueError, match="bfloat16"):
            wn_cuda.wn_stack_train(wn, None, xw, mb, taps, 1, residuals=residuals)


# ---------------------------------------------------------------------------
# the bf16 text encoder layer (bf16 rows 2 and 13): its products on the
# TMA-fed wgmma kernels by the text chains' plan, its attention cores on
# mma.sync m16n8k16 bf16
# ---------------------------------------------------------------------------

ENC_H, ENC_F, ENC_TAPS, ENC_HEADS, ENC_WINDOW = 192, 768, 3, 2, 4
# (name, c_in, taps, tap_sign, n, w_t) of the layer's conv-GEMMs at base width
ENC_CONV = [
    ("qkv", 192, 1, 1, 576, False), ("out_proj", 192, 1, 1, 192, False),
    ("ffn1", 192, 3, 1, 768, False), ("ffn2", 768, 3, 1, 192, False),
    ("dffn", 192, 3, -1, 768, True), ("dx1", 768, 3, -1, 192, True),
    ("datt", 192, 1, 1, 192, True), ("dx", 576, 1, 1, 192, True),
]
# (name, c_in, taps, n) of its weight gradients -> [taps * c_in, n]
ENC_WGRAD = [("dW2", 768, 3, 192), ("dW1", 192, 3, 768), ("dWo", 192, 1, 192),
             ("dW_qkv", 192, 1, 576)]
# the same of the prenet's and the duration stack's chains (bf16 rows 1, 14,
# 3 and 15) where their shapes are not the encoder layer's (their 1x1
# projection and its transposed product are out_proj's and datt's)
STACK_CONV = [
    ("prenet_conv", 192, 5, 1, 192, False), ("prenet_transposed", 192, 5, -1, 192, True),
    ("dp_conv_0", 192, 3, 1, 256, False), ("dp_conv_1", 256, 3, 1, 256, False),
    ("dp_transposed_1", 256, 3, -1, 256, True), ("dp_transposed_0", 256, 3, -1, 192, True),
]
STACK_WGRAD = [("dW_prenet", 192, 5, 192), ("dW_dp_0", 192, 3, 256), ("dW_dp_1", 256, 3, 256)]


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("name,c_in,taps,tap_sign,n,w_t", ENC_CONV + STACK_CONV)
def test_bf16_text_product_matches_plain(dev, name, c_in, taps, tap_sign, n, w_t):
    """Each conv-GEMM of the bf16 text rows (the encoder layer's, the
    prenet's, the duration stack's) alone at [32, 192] by the text chains'
    plan: the library's chunks and split-K shares those of
    tc_gemm.bf16_text_conv_plan, on the TMA-fed kernel (taps, tap_sign -1,
    w_t); against float64 of the same bf16 operands within 1e-5 of max
    |ref| (the shares added in split order), the same bits twice."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    plan = tc_gemm.bf16_text_conv_plan(32, 192, c_in, taps, n, _sms(), w_t=w_t)
    assert plan[0] > 0 and kernels.bf16_tma_conv_plan(32, 192, c_in, taps, n, w_t, True,
                                                      _sms()) == plan
    g = torch.Generator().manual_seed(3)
    a = torch.randn(32, 192, c_in, generator=g).to(BF16).to(dev)
    shape = (taps * n, c_in) if w_t else (taps * c_in, n)
    w = (torch.randn(*shape, generator=g) * (taps * c_in) ** -0.5).to(BF16).to(dev)
    ref = tc_gemm.conv_product_plain(a.double(), w.double(), taps, 1, tap_sign, w_t=w_t)
    kernels.product_counts(reset=True)
    got = tc_gemm.bf16_conv_product(a, w, taps, 1, tap_sign, w_t, unit="text")
    torch.cuda.synchronize()
    assert kernels.product_counts(reset=True)["bf16_tma_gemm"] == 1
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (name, plan, err)
    assert torch.equal(got, tc_gemm.bf16_conv_product(a, w, taps, 1, tap_sign, w_t, unit="text"))


@pytest.mark.parametrize("name,c_in,taps,n", ENC_WGRAD + STACK_WGRAD)
def test_bf16_text_wgrad_matches_plain(dev, name, c_in, taps, n):
    """Each weight gradient of the bf16 text rows (13, 14, 15) alone at [32,
    192] on the TMA-fed
    kernel (its row splits by tc_gemm.bf16_wgrad_plan): against float64 of
    the same bf16 operands within 1e-5 of max |ref|."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    g = torch.Generator().manual_seed(4)
    a = torch.randn(32, 192, c_in, generator=g).to(BF16).to(dev)
    dy = torch.randn(32, 192, n, generator=g).to(BF16).to(dev)
    ref = tc_gemm.weight_gradient_plain(a.double(), dy.double(), taps)
    kernels.product_counts(reset=True)
    got = tc_gemm.bf16_weight_gradient(a, dy, taps, unit="tma")
    torch.cuda.synchronize()
    assert kernels.product_counts(reset=True)["bf16_tma_wgrad"] == 1
    assert (got.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), name


def _attention_plain(qkv, mask, rel_k, rel_v, n_heads, window, p, seed):
    """encoder_layer_plain_bf16's attention core on q, k, v (bf16 values):
    the heads' outputs [b, t, h] in f32, before their rounding."""
    from glow_tts_train_tpu_torch.ops import bf16 as bf16_ops

    b, t, h3 = qkv.shape
    h = h3 // 3
    d = h // n_heads
    scale = d ** -0.5
    q, k, v = (u.reshape(b, t, n_heads, d).transpose(1, 2) for u in qkv.split(h, dim=-1))
    sc = (bf16_ops.scores(q, k, scale)
          + encoder_cuda._band_matrix(q @ rel_k.float().T, t, window) * scale)
    m = mask[:, :, 0]
    attend = (m[:, None, :, None] * m[:, None, None, :]) != 0
    sc = torch.where(attend, sc, torch.full_like(sc, -1e4))
    pd = wn_cuda.site_dropout(torch.softmax(sc, dim=-1), seed, 0, n_heads + 3, p)
    out_h = (bf16_ops.product(bf16_ops.round_fwd(pd), v)
             + encoder_cuda._band_of(pd, window) @ rel_v.float())
    return out_h.transpose(1, 2).reshape(b, t, h)


@pytest.mark.parametrize("t", [64, 192, 93])
def test_bf16_attention_kernels_match_plain(dev, t):
    """The three bf16 attention kernels alone (attention_bf16_kernel, the
    score pass and the products kernel, with rel_grads_kernel) at base
    width (2 heads of 96, window 4, dropout 0.1) over [4, t], three samples
    ragged: the heads' outputs against the plain bf16 attention core, and
    dq, dk, dv and both tables' gradients against its autograd, each within
    BF16_RTOL of its max; the bf16 copies are the f32 values rounded."""
    b, h, d = 4, ENC_H, ENC_H // ENC_HEADS
    g = torch.Generator().manual_seed(t)
    lengths = torch.tensor([t, t - 9, t // 2, 5])
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None].to(dev)
    qkv = (torch.randn(b, t, 3 * h, generator=g) * 0.7).to(BF16).to(dev)
    rel_k, rel_v = ((torch.randn(2 * ENC_WINDOW + 1, d, generator=g) * d ** -0.5).to(BF16).to(dev)
                    for _ in range(2))
    datt = torch.randn(b, t, h, generator=g).to(dev)
    p, seed = 0.1, 7
    drop, threshold, scale = wn_cuda.drop_args(p)
    att = torch.empty(b, t, h, device=dev)
    att16 = torch.empty(b, t, h, dtype=BF16, device=dev)
    stat_m = torch.empty(b, ENC_HEADS, t, device=dev)
    stat_linv = torch.empty_like(stat_m)
    kernels.BF16_ATTENTION(qkv, mask, rel_k, rel_v, att, att16, stat_m, stat_linv, b, t,
                           ENC_HEADS, d, ENC_WINDOW, drop, seed, threshold, scale)
    datt16 = datt.to(BF16)
    dqkv = torch.empty(b, t, 3 * h, device=dev)
    dqkv16 = torch.empty(b, t, 3 * h, dtype=BF16, device=dev)
    drk, drv = torch.empty_like(rel_k), torch.empty_like(rel_v)
    floats = kernels.bf16_attention_bwd_scratch_floats(b, t, ENC_HEADS, ENC_WINDOW)
    scratch = kernels.scratch(floats, qkv)
    kernels.BF16_ATTENTION_BWD(qkv, mask, rel_k, rel_v, att, stat_m, stat_linv, datt, datt16,
                               dqkv, dqkv16, drk, drv, scratch, floats, b, t, ENC_HEADS, d,
                               ENC_WINDOW, drop, seed, threshold, scale)
    torch.cuda.synchronize()
    leaves = [a.float().requires_grad_(True) for a in (qkv, rel_k, rel_v)]
    ref = _attention_plain(*leaves[:1], mask, *leaves[1:], ENC_HEADS, ENC_WINDOW, p, seed)
    _bf16_held("att", att, ref.detach())
    assert torch.equal(att16, att.to(BF16))
    grads = torch.autograd.grad(ref, leaves, datt)
    for name, got, want in zip(("dqkv", "drk", "drv"), (dqkv, drk, drv), grads):
        _bf16_held(name, got, want)
    assert torch.equal(dqkv16, dqkv.to(BF16))


def _enc_layer(dev, t, b=4, seed=0):
    """The encoder layer's bf16 weights at base width and inputs over [b, t],
    three samples ragged (as test_bf16_text_kernels_match_plain's)."""
    h, f, heads, window = ENC_H, ENC_F, ENC_HEADS, ENC_WINDOW
    d = h // heads
    x, mask, g = _bf16_text_inputs(dev, h, t=t, b=b, seed=seed)

    def r(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale + off).to(dtype).to(dev)

    weights = (r(h, 3 * h, scale=h ** -0.5, dtype=BF16), r(1, 3 * h, scale=0.1),
               r(h, h, scale=h ** -0.5, dtype=BF16), r(1, h, scale=0.1),
               r(2 * window + 1, d, scale=d ** -0.5, dtype=BF16),
               r(2 * window + 1, d, scale=d ** -0.5, dtype=BF16),
               r(1, h, scale=0.1, off=1.0), r(1, h, scale=0.1),
               r(1, h, scale=0.1, off=1.0), r(1, h, scale=0.1),
               r(ENC_TAPS * h, f, scale=(ENC_TAPS * h) ** -0.5, dtype=BF16), r(1, f, scale=0.1),
               r(ENC_TAPS * f, h, scale=(ENC_TAPS * f) ** -0.5, dtype=BF16), r(1, h, scale=0.1))
    dout = r(b, t, h, dtype=BF16)
    return weights, x, mask, dout, (heads, window, 0.1, 13)


@pytest.mark.parametrize("t", [64, 96, 192, 93])
def test_bf16_encoder_rows_match_plain(dev, t):
    """bf16 rows 2 and 13 at base width over [4, t] (three samples ragged; t
    93 leaves a sample's last tile part empty and its rows odd), dropout
    on: the forward's output and every gradient (at the kernel's own ReLU
    gates) within BF16_RTOL of the plain bf16 version's max; every product
    on the TMA-fed kernels, as tc_gemm.bf16_encoder_products counts them."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    weights, x, mask, dout, cfg = _enc_layer(dev, t)
    plan = {bw: tc_gemm.bf16_encoder_products(4, t, ENC_H, ENC_F, ENC_TAPS, _sms(), bw)["counts"]
            for bw in (False, True)}
    assert plan[True] == {"bf16_gemm": 0, "bf16_wgrad": 0, "bf16_tma_gemm": 8,
                          "bf16_tma_wgrad": 4}
    kernels.product_counts(reset=True)
    out = encoder_cuda.encoder_layer(weights, x, mask, *cfg)
    torch.cuda.synchronize()
    counts = kernels.product_counts(reset=True)
    assert {k: counts[k] for k in plan[False]} == plan[False]
    _bf16_held(f"row 2 t {t}", out, encoder_cuda.encoder_layer_plain_bf16(weights, x, mask, *cfg))
    saves = {}
    grads = encoder_cuda.encoder_layer_bwd(weights, x, mask, dout, *cfg, saves=saves)
    torch.cuda.synchronize()
    counts = kernels.product_counts(reset=True)
    assert {k: counts[k] for k in plan[True]} == plan[True]
    assert torch.equal(saves["out"], out)  # the recompute is the forward's bits
    ref = encoder_cuda.encoder_layer_bwd_plain(weights, x, mask, dout, *cfg, gates=saves["gates"])
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert a.dtype == b.dtype, i
        _bf16_held(f"row 13 t {t} [{i}]", a, b)


def test_bf16_encoder_rows_units_agree_and_repeat_bits(dev):
    """Rows 2 and 13 in bf16 at [4, 192], dropout on: on the TMA-fed kernels
    and, in the same process, on the mma.sync ones (every product declined
    by kernels.bf16_mma_only): the forward's outputs within BF16_RTOL of
    each other (both read the same bf16 operands; only the f32 sums' order
    differs), each unit's gradients within BF16_RTOL of the plain bf16
    version at that unit's own ReLU gates (a ReLU input within rounding of
    zero opens under one unit only, which moves a weight gradient by a few
    percent of its max); 50 repeats of each row on the TMA-fed kernels give
    the same bits (split-K shares and row splits added in a fixed order, no
    atomics)."""
    weights, x, mask, dout, cfg = _enc_layer(dev, 192)
    runs = {}
    for unit in ("tma", "mma"):
        with kernels.bf16_mma_only() if unit == "mma" else contextlib.nullcontext():
            kernels.product_counts(reset=True)
            out = encoder_cuda.encoder_layer(weights, x, mask, *cfg)
            saves = {}
            grads = encoder_cuda.encoder_layer_bwd(weights, x, mask, dout, *cfg, saves=saves)
            torch.cuda.synchronize()
            counts = kernels.product_counts(reset=True)
        want = (12, 4, 0, 0) if unit == "mma" else (0, 0, 12, 4)
        assert tuple(counts[k] for k in ("bf16_gemm", "bf16_wgrad", "bf16_tma_gemm",
                                         "bf16_tma_wgrad")) == want, (unit, counts)
        ref = encoder_cuda.encoder_layer_bwd_plain(weights, x, mask, dout, *cfg,
                                                   gates=saves["gates"])
        for i, (a, b) in enumerate(zip(grads, ref)):
            _bf16_held(f"{unit} row 13 [{i}]", a, b)
        runs[unit] = (out, *grads)
    _bf16_held("row 2 tma vs mma", runs["tma"][0], runs["mma"][0])
    for _ in range(50):
        again = (encoder_cuda.encoder_layer(weights, x, mask, *cfg),
                 *encoder_cuda.encoder_layer_bwd(weights, x, mask, dout, *cfg))
        assert all(torch.equal(a, b) for a, b in zip(again, runs["tma"]))


# ---------------------------------------------------------------------------
# the bf16 prenet and duration stack (bf16 rows 1, 14, 3 and 15): their
# chains' products on the TMA-fed wgmma kernels by the text chains' plan
# ---------------------------------------------------------------------------

STACK_F = 256  # the duration stack's width at base width
BF16_STACKS = {
    "prenet": (text_cuda.prenet, text_cuda.prenet_plain_bf16, text_cuda.prenet_bwd,
               text_cuda.prenet_bwd_plain),
    "duration_stack": (text_cuda.duration_stack, text_cuda.duration_stack_plain_bf16,
                       text_cuda.duration_stack_bwd, text_cuda.duration_stack_bwd_plain),
}


def _stack(dev, stack, t, b=4, seed=0):
    """A text stack's bf16 weights at base width (the prenet's 3 layers of 5
    taps at h 192; the duration stack's 2 layers of 3 taps from 192
    channels at f 256) and inputs over [b, t], three samples ragged."""
    h, f = ENC_H, STACK_F
    x, mask, g = _bf16_text_inputs(dev, h, t=t, b=b, seed=seed)

    def r(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale + off).to(dtype).to(dev)

    if stack == "prenet":
        weights = (r(3, 5 * h, h, scale=(5 * h) ** -0.5, dtype=BF16), r(3, h, scale=0.1),
                   r(3, h, scale=0.1, off=1.0), r(3, h, scale=0.1),
                   r(h, h, scale=h ** -0.5, dtype=BF16), r(1, h, scale=0.1))
        return weights, x, mask, r(b, t, h, dtype=BF16), (0.5, 11)
    weights = (r(3 * h, f, scale=(3 * h) ** -0.5, dtype=BF16), r(1, f, scale=0.1),
               r(1, f, scale=0.1, off=1.0), r(1, f, scale=0.1),
               r(3 * f, f, scale=(3 * f) ** -0.5, dtype=BF16),
               r(1, f, scale=0.1), r(1, f, scale=0.1, off=1.0), r(1, f, scale=0.1))
    return weights, x, mask, r(b, t, f, dtype=BF16), (0.1, 12)


def _stack_plan(stack, b, t, backward):
    from glow_tts_train_tpu_torch.ops import tc_gemm

    if stack == "prenet":
        return tc_gemm.bf16_prenet_products(b, t, ENC_H, 3, 5, _sms(), backward)["counts"]
    return tc_gemm.bf16_duration_products(b, t, ENC_H, STACK_F, 3, _sms(), backward)["counts"]


@pytest.mark.parametrize("stack", sorted(BF16_STACKS))
@pytest.mark.parametrize("t", [64, 96, 192, 93])
def test_bf16_stack_rows_match_plain(dev, stack, t):
    """bf16 rows 1 and 14 (the prenet) and 3 and 15 (the duration stack) at
    base width over [4, t] (three samples ragged; t 93 leaves a sample's
    last tile part empty, where the prenet's 5-tap boxes reach two rows
    past it), dropout on: the forward's output and every gradient (at the
    kernel's own ReLU gates) within BF16_RTOL of the plain bf16 version's
    max; every product on the TMA-fed kernels, as the plan counts them; the
    backward's recompute the forward's bits."""
    fwd, plain, bwd, plain_bwd = BF16_STACKS[stack]
    weights, x, mask, dout, cfg = _stack(dev, stack, t)
    plan = {bw: _stack_plan(stack, 4, t, bw) for bw in (False, True)}
    assert plan[True]["bf16_gemm"] == plan[True]["bf16_wgrad"] == 0
    kernels.product_counts(reset=True)
    out = fwd(weights, x, mask, *cfg)
    torch.cuda.synchronize()
    counts = kernels.product_counts(reset=True)
    assert {k: counts[k] for k in plan[False]} == plan[False]
    _bf16_held(f"{stack} t {t}", out, plain(weights, x, mask, *cfg))
    saves = {}
    grads = bwd(weights, x, mask, dout, *cfg, saves=saves)
    torch.cuda.synchronize()
    counts = kernels.product_counts(reset=True)
    assert {k: counts[k] for k in plan[True]} == plan[True]
    assert torch.equal(saves["out"], out)  # the recompute is the forward's bits
    ref = plain_bwd(weights, x, mask, dout, *cfg, gates=saves["gates"])
    for i, (a, b) in enumerate(zip(grads, ref)):
        assert a.dtype == b.dtype, i
        _bf16_held(f"{stack}_bwd t {t} [{i}]", a, b)


@pytest.mark.parametrize("stack", sorted(BF16_STACKS))
def test_bf16_stack_rows_units_agree_and_repeat_bits(dev, stack):
    """A stack's bf16 rows at [4, 192], dropout on, on the TMA-fed kernels
    and, in the same process, on the mma.sync ones (kernels.bf16_mma_only):
    the forward's outputs within BF16_RTOL of each other, each unit's
    gradients within BF16_RTOL of the plain bf16 version at that unit's own
    ReLU gates; 50 repeats of each row on the TMA-fed kernels give the same
    bits (split-K shares and row splits added in a fixed order)."""
    fwd, _, bwd, plain_bwd = BF16_STACKS[stack]
    weights, x, mask, dout, cfg = _stack(dev, stack, 192)
    plan = [_stack_plan(stack, 4, 192, bw) for bw in (False, True)]
    want = tuple(plan[0][k] + plan[1][k] for k in ("bf16_tma_gemm", "bf16_tma_wgrad"))
    runs = {}
    for unit in ("tma", "mma"):
        with kernels.bf16_mma_only() if unit == "mma" else contextlib.nullcontext():
            kernels.product_counts(reset=True)
            out = fwd(weights, x, mask, *cfg)
            saves = {}
            grads = bwd(weights, x, mask, dout, *cfg, saves=saves)
            torch.cuda.synchronize()
            counts = kernels.product_counts(reset=True)
        key = "bf16_" if unit == "mma" else "bf16_tma_"
        assert (counts[key + "gemm"], counts[key + "wgrad"]) == want, (unit, counts)
        ref = plain_bwd(weights, x, mask, dout, *cfg, gates=saves["gates"])
        for i, (a, b) in enumerate(zip(grads, ref)):
            _bf16_held(f"{unit} {stack}_bwd [{i}]", a, b)
        runs[unit] = (out, *grads)
    _bf16_held(f"{stack} tma vs mma", runs["tma"][0], runs["mma"][0])
    for _ in range(50):
        again = (fwd(weights, x, mask, *cfg), *bwd(weights, x, mask, dout, *cfg))
        assert all(torch.equal(a, b) for a, b in zip(again, runs["tma"]))


# encoder configurations outside the encoder kernel's limits: a head width
# over 128 (384 channels, 2 heads: 192), and a window over 16
ENCODER_LIMITS = {
    "head_width_192": dict(hidden_channels=384, hidden_channels_enc=384, n_heads=2),
    "window_20": dict(window_size=20),
}


@pytest.mark.parametrize("case", sorted(ENCODER_LIMITS))
def test_configs_past_the_encoder_kernels_limits_train_and_serve_on_the_card(dev, case):
    """A config the encoder kernel does not take resolves ``encoder_fuse:
    "auto"`` to false and trains and serves on the card with the encoder
    layers op by op (no encoder-layer launch): forward_train and every
    gradient against the CPU, dropout on; one train step with finite
    metrics; a synthesis against the CPU path (logw, lengths, the mel)."""
    config = tiny_config(**ENCODER_LIMITS[case])
    hp, launches = _forward_train_on_both(dev, config, 0.1)
    assert not hp.encoder_fuse and not hp.encoder_kernel_fits
    assert launches["encoder_layer"] == launches["encoder_layer_bwd"] == 0
    assert launches["block_fwd_save"] == launches["block_bwd_store"] == hp.n_blocks_dec
    state = training.TrainState(training.trainable_model(
        {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, 1).items()}, hp, dev))
    rng = np.random.default_rng(5)
    batch = {"x": rng.integers(1, hp.n_vocab, size=(2, 11)), "x_lengths": np.array([11, 8]),
             "y": rng.standard_normal((2, 32, hp.out_channels)).astype(np.float32),
             "y_lengths": np.array([32, 24])}
    metrics = training.make_train_step(config)(state, training.batch_to(batch, dev))
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    w_cpu = model.store_inverse(checkpoint.params_from_numpy(
        checkpoint.random_params(hp, 0), hp), hp)
    x = torch.from_numpy(rng.integers(1, hp.n_vocab, size=(2, 11)))
    xl = torch.tensor([11, 7])
    eps = torch.from_numpy(rng.standard_normal((2, 72, hp.out_channels)).astype(np.float32))
    outs = []
    for d, w in ((dev, w_cpu.to(dev)), (torch.device("cpu"), w_cpu)):
        before = kernels.launch_counts()
        outs.append(model.forward_gen(w, hp, x.to(d), xl.to(d), 72, noise_scale=0.667,
                                      eps=eps.to(d)))
        if d.type == "cuda":
            assert kernels.launch_counts()["encoder_layer"] == before["encoder_layer"]
    cu, cpu = outs
    assert torch.equal(cu[3].cpu(), cpu[3])
    _close(cu[2][1], cpu[2][1])  # logw
    _close(cu[0][0], cpu[0][0], MEL_ATOL)


def test_two_ranks_on_one_card_over_gloo_match_one_process(dev, tmp_path):
    """Two ranks on this card over gloo (``tests/torch_parallel_worker.py``;
    NCCL refuses two ranks on one device), one step each on its 4 rows of
    a ragged global batch of 8, the kernels built once before they start:
    the four metrics within 3e-4 of the one-process step on the card on
    the whole batch, every param within 3e-4 relative and 2e-6 absolute
    (``tests/test_torch_accum.py``'s accumulation tolerances), the ranks'
    params and Adam moments equal bit for bit, and each rank's launches
    those of a step of its local batch."""
    import torch_parallel_worker as worker

    config = tiny_config(p_dropout=0.0, p_dropout_dec=0.0)
    hp = model.hyper_from_config(config)
    flat = {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, 1).items()}
    np.savez(tmp_path / "params.npz", **flat)
    rng = np.random.default_rng(1)
    b, t_x, t_y = 8, 11, 26
    x_lengths = np.concatenate([[t_x], rng.integers(7, t_x + 1, size=b - 1)])
    y_lengths = np.concatenate([[t_y], rng.integers(2 * t_x, t_y + 1, size=b - 1)])
    batch = {"x": rng.integers(1, hp.n_vocab, size=(b, t_x)) * (np.arange(t_x) < x_lengths[:, None]),
             "x_lengths": x_lengths, "y_lengths": y_lengths,
             "y": rng.standard_normal((b, t_y, hp.out_channels)).astype(np.float32)
             * (np.arange(t_y) < y_lengths[:, None])[..., None]}
    np.savez(tmp_path / "batch.npz", **{f"0/{k}": v for k, v in batch.items()})
    with open(tmp_path / "config.json", "w") as f:
        config.save(f)
    kernels.build()
    worker.run_ranks(tmp_path, [{
        "kind": "steps", "name": "step", "config": str(tmp_path / "config.json"),
        "params": str(tmp_path / "params.npz"), "batches": str(tmp_path / "batch.npz"),
        "steps": 1, "dropout": False,
    }], platform="cuda", backend="gloo", local_rank=0, timeout=600)
    state = training.TrainState(training.trainable_model(flat, hp, dev))
    ref = training.make_train_step(config)(state, training.batch_to(batch, dev))
    results = []
    for r in range(2):
        with np.load(tmp_path / f"step.rank{r}.npz") as data:
            results.append({k: data[k] for k in data.files})
    per_step = {"block_fwd_save": hp.n_blocks_dec, "block_bwd_store": hp.n_blocks_dec, "mas": 1,
                "prenet": 1, "prenet_bwd": 1, "encoder_layer": hp.n_layers_enc,
                "encoder_layer_bwd": hp.n_layers_enc, "duration_stack": 1,
                "duration_stack_bwd": 1}
    for res in results:
        for j, key in enumerate(worker.METRICS):
            np.testing.assert_allclose(res["metrics"][0, j], float(ref[key]), rtol=3e-4,
                                       atol=1e-6, err_msg=key)
        assert {k: int(res[f"launches/{k}"]) for k in per_step} == per_step
    for key, p in state.model.flat().items():
        np.testing.assert_allclose(results[0][f"param/{key}"], p.detach().cpu().numpy(),
                                   rtol=3e-4, atol=2e-6, err_msg=key)
    for k in (k for k in results[0] if k.startswith(("param/", "mu/", "nu/"))):
        np.testing.assert_array_equal(results[0][k], results[1][k], err_msg=k)


@pytest.mark.parametrize("fp16", [False, True], ids=["f32", "bf16"])
def test_model_parallel_on_one_card_over_gloo_equals_data_parallel(dev, tmp_path, fp16):
    """Two ranks on this card over gloo as one model group (``--model-parallel
    2``: the gather is gloo's ``all_gather_into_tensor`` on CUDA tensors),
    2 steps with dropout on against the same two ranks' data-parallel
    steps in the same launch: the four metrics, every param and both Adam
    moments (gathered whole) bit for bit, the launch counts equal, and
    each rank's moments its half of every sharded leaf."""
    import torch_parallel_worker as worker

    from glow_tts_train_tpu_torch.parallel import partitioning

    config = tiny_config(p_dropout_dec=0.5)
    config.fp16_run = fp16
    hp = model.hyper_from_config(config)
    flat = {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, 1).items()}
    np.savez(tmp_path / "params.npz", **flat)
    rng = np.random.default_rng(3)
    b, t_x, t_y = 8, 11, 26
    batches = {}
    for i in range(2):
        x_lengths = np.concatenate([[t_x], rng.integers(7, t_x + 1, size=b - 1)])
        y_lengths = np.concatenate([[t_y], rng.integers(2 * t_x, t_y + 1, size=b - 1)])
        batch = {"x": rng.integers(1, hp.n_vocab, size=(b, t_x))
                 * (np.arange(t_x) < x_lengths[:, None]),
                 "x_lengths": x_lengths, "y_lengths": y_lengths,
                 "y": rng.standard_normal((b, t_y, hp.out_channels)).astype(np.float32)
                 * (np.arange(t_y) < y_lengths[:, None])[..., None]}
        batches.update({f"{i}/{k}": v for k, v in batch.items()})
    np.savez(tmp_path / "batches.npz", **batches)
    with open(tmp_path / "config.json", "w") as f:
        config.save(f)
    kernels.build()
    job = {"kind": "steps", "config": str(tmp_path / "config.json"),
           "params": str(tmp_path / "params.npz"), "batches": str(tmp_path / "batches.npz"),
           "steps": 2, "dropout": True}
    worker.run_ranks(tmp_path, [dict(job, name="dp", model_parallel=1),
                                dict(job, name="mp", model_parallel=2)],
                     platform="cuda", backend="gloo", local_rank=0, timeout=600, model_parallel=2)
    sharded = set(partitioning.sharded_keys({k: v.shape for k, v in flat.items()}, 2))
    assert len(sharded) > 20
    for r in range(2):
        with np.load(tmp_path / f"dp.rank{r}.npz") as d, np.load(tmp_path / f"mp.rank{r}.npz") as m:
            np.testing.assert_array_equal(m["metrics"], d["metrics"])
            launches = [k for k in d.files if k.startswith("launches/")]
            assert sum(int(d[k]) for k in launches) > 0
            assert {k: int(m[k]) for k in launches} == {k: int(d[k]) for k in launches}
            for k in (k for k in d.files if k.startswith(("param/", "mu/", "nu/"))):
                np.testing.assert_array_equal(m[k].view(np.uint8), d[k].view(np.uint8), err_msg=k)
            for key in sharded:
                c = flat[key].shape[-1] // 2
                np.testing.assert_array_equal(m[f"rank_mu/{key}"], m[f"mu/{key}"][..., r * c:(r + 1) * c])


def test_bf16_rows_8_and_9_at_the_shipped_batch(dev):
    """bf16 rows 8 (``wn_bwd_store``: its transposed convs' epilogues in
    column pairs) and 9 (``block_fwd``: the folded A on wgmma) at [32,
    704], base width, dropout on, ragged lengths: every output within
    BF16_RTOL of the plain bf16 version (row 8's gradients against the
    autograd of ``wn_stack_plain_bf16``), the products as the plan says
    (none on the CUDA cores), and 50 more calls the first call's bits."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    folded, _, _, taps = _bf16_block(dev)
    lengths = torch.randint(200, 705, (32,), generator=torch.Generator().manual_seed(7))
    lengths[0] = 704
    mask = (torch.arange(704)[None, :] < lengths[:, None]).float()[..., None].to(dev)
    x = (torch.randn(32, 704, 160, device=dev) * mask).to(BF16)
    wn = tuple(folded[k] for k in ("W_in", "b_in", "W_rs", "b_rs"))
    L, _, h2 = wn[0].shape
    h = h2 // 2
    xw = (torch.randn(32, 704, h, device=dev) * mask).to(BF16)
    dout = torch.randn(xw.shape, device=dev).to(BF16)
    wcfg, bcfg = (taps, 1, 0.05, 21), (taps, 1, False, 0.05, 21)
    _, saves = wn_cuda.wn_fwd_save(wn, None, xw, mask, *wcfg)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {
        8: (lambda: wn_cuda.wn_bwd_store(wn[0], wn[2], False, mask, saves, dout, *wcfg),
            tc_gemm.bf16_block_products(32, 704, 0, h, L, taps, 1, sms, backward=True)),
        9: (lambda: block_cuda.block_fwd(folded, None, x, mask, *bcfg),
            tc_gemm.bf16_block_products(32, 704, 160, h, L, taps, 1, sms, saves=False)),
    }
    first = {}
    for row, (fn, plan) in rows.items():
        first[row], products = _bf16_products(fn)
        assert products == _plan_counts(plan) and plan["counts"]["core_gemm"] == 0, row
    leaves = [v.detach().requires_grad_(True) for v in wn]
    xl = xw.detach().requires_grad_(True)
    ref = torch.autograd.grad(wn_cuda.wn_stack_plain_bf16(tuple(leaves), None, xl, mask, *wcfg),
                              [xl, *leaves], dout)
    for name, r in zip(["dx", "dW_in", "db_in", "dW_rs", "db_rs"], ref):
        _bf16_held(f"row 8 {name}", first[8][name], r)
    z_p, ld_p = block_cuda.block_forward_plain_bf16(folded, None, x, mask, *bcfg)
    _bf16_held("row 9 z", first[9][0], z_p)
    _bf16_held("row 9 ld", first[9][1], ld_p)
    for _ in range(50):
        grads = rows[8][0]()
        assert all((v is None and first[8][k] is None) or torch.equal(v, first[8][k])
                   for k, v in grads.items())
        z, ld = rows[9][0]()
        assert torch.equal(z, first[9][0]) and torch.equal(ld, first[9][1])


# ---------------------------------------------------------------------------
# the WN forward's two bf16 products on the warp-specialised unit (bf16 rows
# 5 and 6, and the forwards of rows 7, 9, 10 and 11): the 64-row unit's bits
# ---------------------------------------------------------------------------

# (batch, t): every 64-row tile full, ragged last tiles, one tile a sample;
# odd row-tile counts leave the in-layer conv's last unit one tile short
WS_SHAPES = [(3, 704), (5, 100), (7, 37)]
WS_GATE = {"saves": (True, False), "no_saves": (False, False), "g": (True, True),
           "g_no_saves": (False, True)}
WS_RES_SKIP = {"first": (0, False), "middle": (1, False), "last": (3, False),
               "last_skip_mask": (3, True)}
# h: the shipped base width, and two that are not a multiple of 64, whose
# last column tile reaches past h
WS_WIDTHS = [192, 160, 96]


def _ws_operands(dev, b, t, h=192, taps=5, seed=3):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None]
    x = (torch.randn(b, t, h, generator=g) * mask).to(BF16)
    w_in = (torch.randn(taps * h, 2 * h, generator=g) * (taps * h) ** -0.5).to(BF16)
    w_rs = (torch.randn(h, 2 * h, generator=g) * h ** -0.5).to(BF16)
    b_in, b_rs = 0.1 * torch.randn(2 * h, generator=g), 0.1 * torch.randn(2 * h, generator=g)
    cond = (0.3 * torch.randn(b, 2 * h, generator=g)).to(BF16)
    skip = torch.randn(b, t, h, generator=g)
    return {k: v.to(dev) for k, v in dict(x=x, mask=mask, w_in=w_in, w_rs=w_rs, b_in=b_in,
                                          b_rs=b_rs, cond=cond, skip=skip).items()}


def _ws_runs(fn):
    """fn(unit) on the 64-row unit and on the warp-specialised one, each
    counted once on its own unit."""
    got = {}
    for unit, key in (("tma", "bf16_tma_gemm"), ("ws", "bf16_ws_gemm")):
        kernels.product_counts(reset=True)
        got[unit] = fn(unit)
        torch.cuda.synchronize()
        counts = kernels.product_counts(reset=True)
        assert counts[key] == 1 and sum(counts[k] for k in BF16_COUNT_KEYS) == 1, (unit, counts)
    return got


@pytest.mark.parametrize("h", WS_WIDTHS)
@pytest.mark.parametrize("b,t", WS_SHAPES)
@pytest.mark.parametrize("case", sorted(WS_GATE))
def test_bf16_ws_in_layer_conv_equals_64_row_unit(dev, case, b, t, h):
    """The in-layer conv (5 taps at dilation 2, the gate epilogue, dropout
    on) on the warp-specialised unit: acts and, with saves, th and sg the
    64-row unit's bits, with and without the conditioning, and within
    BF16_RTOL of the plain version; at h 160 and 96 the last column tile's
    pairs past h write nothing (a write past a row would land in the next
    row's first columns, or past the tensor's end)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    saves, with_g = WS_GATE[case]
    o = _ws_operands(dev, b, t, h)
    kw = dict(taps=5, dilation=2, drop=(0.05, 1234, 1, 4), saves=saves,
              g=o["cond"] if with_g else None)
    got = _ws_runs(lambda unit: tc_gemm.bf16_wn_product("gate", o["x"], o["w_in"], o["b_in"],
                                                        unit=unit, **kw))
    for i, (w, ref) in enumerate(zip(got["ws"], got["tma"])):
        assert torch.equal(w, ref), (case, i)
    plain = tc_gemm.bf16_wn_product_plain("gate", *(v.cpu() for v in (o["x"], o["w_in"],
                                                                      o["b_in"])),
                                          **{**kw, "g": None if kw["g"] is None else
                                             kw["g"].cpu()})
    for i, (w, ref) in enumerate(zip(got["ws"], plain)):
        _bf16_held(f"{case} [{i}]", w.cpu(), ref)


@pytest.mark.parametrize("h", WS_WIDTHS)
@pytest.mark.parametrize("b,t", WS_SHAPES)
@pytest.mark.parametrize("case", sorted(WS_RES_SKIP))
def test_bf16_ws_res_skip_equals_64_row_unit(dev, case, b, t, h):
    """res/skip of the first, a middle and the last of 4 layers (the last's
    skip half only, with and without skip_mask) on the warp-specialised
    unit: the next x (in place, as the forward that saves nothing writes
    it), the f32 skip sum and skipm the 64-row unit's bits, and within
    BF16_RTOL of the plain version, at h 192, 160 and 96."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    layer, skip_mask = WS_RES_SKIP[case]
    o = _ws_operands(dev, b, t, h)

    def run(unit):
        x_l, skip = o["x"].clone(), o["skip"].clone()
        return tc_gemm.bf16_wn_product("res_skip", o["x"], o["w_rs"], o["b_rs"], x_l=x_l,
                                       skip=skip, mask=o["mask"], layer=layer, n_layers=4,
                                       skip_mask=skip_mask, unit=unit, out=x_l)

    got = _ws_runs(run)
    for i, (w, ref) in enumerate(zip(got["ws"], got["tma"])):
        assert (w is None) == (ref is None) and (w is None or torch.equal(w, ref)), (case, i)
    cpu = {k: v.cpu() for k, v in o.items()}
    x_l, skip = cpu["x"].clone(), cpu["skip"].clone()
    plain = tc_gemm.bf16_wn_product_plain("res_skip", cpu["x"], cpu["w_rs"], cpu["b_rs"],
                                          x_l=x_l, skip=skip, mask=cpu["mask"], layer=layer,
                                          n_layers=4, skip_mask=skip_mask, out=x_l)
    for i, (w, ref) in enumerate(zip(got["ws"], plain)):
        if ref is not None:
            _bf16_held(f"{case} [{i}]", w.cpu(), ref)


def test_bf16_ws_refuses_what_it_does_not_take(dev):
    """The warp-specialised unit takes the WN forward's two epilogues
    alone: a bare bias product on it raises, and so does either product
    below 64 channels (the 64-row unit's shape rules)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    a = torch.zeros(5, 100, 192, dtype=BF16, device=dev)
    with pytest.raises(ValueError, match="unit 'ws'"):
        tc_gemm.bf16_conv_product(a, torch.zeros(192, 384, dtype=BF16, device=dev), unit="ws")
    x = torch.zeros(2, 64, 48, dtype=BF16, device=dev)
    w = torch.zeros(5 * 48, 96, dtype=BF16, device=dev)
    with pytest.raises(RuntimeError, match="gtt_bf16_wn_product"):
        tc_gemm.bf16_wn_product("gate", x, w, torch.zeros(96, device=dev), taps=5, unit="ws")


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
def test_bf16_ws_wn_rows_repeat_bits(dev, with_g):
    """Rows 6 and 5 at [32, 704] (ragged), dropout on: their forward WN
    products on the warp-specialised unit only (the plan's counts), row
    5's output row 6's bits, within BF16_RTOL of the plain bf16 stack, and
    50 calls of each the first call's bits (the mbarrier hand-offs under
    load: a race shows as moved bits)."""
    from glow_tts_train_tpu_torch.ops import tc_gemm

    o = _ws_operands(dev, 32, 704)
    L, h, taps = 4, 192, 5
    g = torch.Generator().manual_seed(9)
    wn = ((torch.randn(L, taps * h, 2 * h, generator=g) * (taps * h) ** -0.5).to(BF16).to(dev),
          (0.1 * torch.randn(L, 2 * h, generator=g)).to(dev),
          (torch.randn(L, h, 2 * h, generator=g) * h ** -0.5).to(BF16).to(dev),
          (0.1 * torch.randn(L, 2 * h, generator=g)).to(dev))
    g_all = _bf16_g_all(dev, 32, L, h, with_g)
    cfg = (taps, 1, 0.05, 21)
    plan = tc_gemm.bf16_block_products(32, 704, 0, h, L, taps, 1, _sms())
    assert plan["counts"]["bf16_ws_gemm"] == 2 * L and plan["counts"]["bf16_tma_gemm"] == 0
    (out6, saves), products = _bf16_products(
        lambda: wn_cuda.wn_fwd_save(wn, g_all, o["x"], o["mask"], *cfg))
    assert products == _plan_counts(plan)
    out5, products = _bf16_products(lambda: wn_cuda.wn_stack(wn, g_all, o["x"], o["mask"], *cfg))
    assert products == _plan_counts(plan) and torch.equal(out5, out6)
    _bf16_held("row 6", out6, wn_cuda.wn_stack_plain_bf16(wn, g_all, o["x"], o["mask"], *cfg))
    for _ in range(50):
        again, again_saves = wn_cuda.wn_fwd_save(wn, g_all, o["x"], o["mask"], *cfg)
        assert torch.equal(again, out6)
        assert all(torch.equal(again_saves[k], saves[k]) for k in ("xs", "th", "sg"))
        assert torch.equal(wn_cuda.wn_stack(wn, g_all, o["x"], o["mask"], *cfg), out6)

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

import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch import checkpoint, kernels
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


def test_cuda_raises_for_configs_the_encoder_kernel_does_not_take(dev):
    hp = model.hyper_from_config(tiny_config(window_size=None))
    w = model.store_inverse(checkpoint.params_from_numpy(
        checkpoint.random_params(hp, 0), hp), hp).to(dev)
    x = torch.tensor([[3, 7, 12]], device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.encoder_forward(w, hp, x, torch.tensor([3], device=dev))


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


def _device_operations(fn) -> int:
    """Kernels, fills and copies one call of ``fn`` puts on the device, by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


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

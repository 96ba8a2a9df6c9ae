"""The model's weights, made from the seed on the device.

``shapes`` is a frozen copy of ``glow_tts_train_tpu_torch/checkpoint.py``
``param_shapes`` at commit fd792a0 (the JAX checkpoint's keys and shapes,
without the ``model/`` prefix), read from the configuration file's plain
dict.  :func:`make` draws every leaf from one generator on the device in
three large calls (uniform, normal, and the InvConvNear matrices' QR):
torch's conv init U(+-1/sqrt(fan_in)) for conv weights and biases, Xavier
for the attention projections, N(0, h^-0.5) embeddings, orthogonal
InvConvNear matrices with a positive determinant, weight norm with
g = ||v||, LayerNorm 1 and 0, ActNorm 0 (DDI sets it).  Unlike a fresh
training init the couplings' ``end`` and the prenet's projection are not
zero but a tenth of the conv init, so every layer's gradient is live from
the first step, and the duration predictor's projection is set so that
the durations average about 6 frames a phoneme (``assumed`` in the
configuration files).
"""

import math
import typing

import torch

Shapes = typing.Dict[str, typing.Tuple[int, ...]]

# the duration projection: logw ~ N(log 5.5, ~0.2), so ceil(exp(logw)) ~ 6
DURATION_BIAS = math.log(5.5)
DURATION_WEIGHT_BOUND = 0.0217
# the couplings' end and the prenet's projection: this share of the conv init
LIVE_ZERO_INIT = 0.1


def hyper(config: dict) -> dict:
    """The sizes the reference and :func:`shapes` read, from a configuration
    file's dict."""
    m, a = config["model"], config["audio"]
    return {
        "n_vocab": m["num_symbols"], "hidden_channels": m["hidden_channels"],
        "filter_channels": m["filter_channels"], "filter_channels_dp": m["filter_channels_dp"],
        "kernel_size": m["kernel_size"], "n_heads": m["n_heads"],
        "n_layers_enc": m["n_layers_enc"], "p_dropout": m["p_dropout"],
        "n_blocks_dec": m["n_blocks_dec"], "kernel_size_dec": m["kernel_size_dec"],
        "dilation_rate": m["dilation_rate"], "n_block_layers": m["n_block_layers"],
        "p_dropout_dec": m["p_dropout_dec"], "n_speakers": m["n_speakers"],
        "gin_channels": m["gin_channels"], "n_split": m["n_split"], "n_sqz": m["n_sqz"],
        "window_size": m["window_size"], "mean_only": m["mean_only"], "prenet": m["prenet"],
        "mel_channels": a["mel_channels"],
    }


def shapes(hp: dict) -> Shapes:
    h = hp["hidden_channels"]
    L, K = hp["n_layers_enc"], hp["kernel_size"]
    f, fdp, out = hp["filter_channels"], hp["filter_channels_dp"], hp["mel_channels"]
    nb, nl, kd = hp["n_blocks_dec"], hp["n_block_layers"], hp["kernel_size_dec"]
    c = out * hp["n_sqz"]
    gin = hp["gin_channels"] if hp["n_speakers"] > 1 else 0
    s: Shapes = {"emb": (hp["n_vocab"], h)}

    def conv(path, k, c_in, c_out, lead=()):
        s[f"{path}/w"] = (*lead, k, c_in, c_out)
        s[f"{path}/b"] = (*lead, c_out)

    def wn_conv(path, k, c_in, c_out, lead=()):
        s[f"{path}/v"] = (*lead, k, c_in, c_out)
        s[f"{path}/g"] = (*lead, c_out)
        s[f"{path}/b"] = (*lead, c_out)

    def norm(path, n, lead=()):
        s[f"{path}/gamma"] = (*lead, n)
        s[f"{path}/beta"] = (*lead, n)

    for name in ("q", "k", "v", "o"):
        conv(f"encoder/attn/{name}", 1, h, h, (L,))
    for name in ("emb_rel_k", "emb_rel_v"):
        s[f"encoder/attn/{name}"] = (L, 1, 2 * hp["window_size"] + 1, h // hp["n_heads"])
    norm("encoder/norm_1", h, (L,))
    conv("encoder/ffn/conv_1", K, h, f, (L,))
    conv("encoder/ffn/conv_2", K, f, h, (L,))
    norm("encoder/norm_2", h, (L,))
    conv("proj_m", 1, h, out)
    conv("proj_w/conv_1", K, h + gin, fdp)
    norm("proj_w/norm_1", fdp)
    conv("proj_w/conv_2", K, fdp, fdp)
    norm("proj_w/norm_2", fdp)
    conv("proj_w/proj", 1, fdp, 1)
    blk = "decoder/blocks"
    s[f"{blk}/actnorm/logs"] = (nb, c)
    s[f"{blk}/actnorm/bias"] = (nb, c)
    s[f"{blk}/invconv/weight"] = (nb, hp["n_split"], hp["n_split"])
    wn_conv(f"{blk}/coupling/start", 1, c // 2, h, (nb,))
    conv(f"{blk}/coupling/end", 1, h, c, (nb,))
    wn_conv(f"{blk}/coupling/wn/in_layers", kd, h, 2 * h, (nb, nl))
    if nl > 1:
        wn_conv(f"{blk}/coupling/wn/res_skip", 1, h, 2 * h, (nb, nl - 1))
    wn_conv(f"{blk}/coupling/wn/res_skip_last", 1, h, h, (nb,))
    if gin:
        wn_conv(f"{blk}/coupling/wn/cond", 1, gin, 2 * h * nl, (nb,))
    if hp["prenet"]:
        conv("prenet/layers/conv", 5, h, h, (3,))
        norm("prenet/layers/norm", h, (3,))
        conv("prenet/proj", 1, h, h)
    if not hp["mean_only"]:
        conv("proj_s", 1, h, out)
    if hp["n_speakers"] > 1:
        s["emb_g"] = (hp["n_speakers"], gin)
    return s


def _numel(shape) -> int:
    return int(math.prod(shape))


@torch.no_grad()
def make(hp: dict, seed: int, device) -> typing.Dict[str, torch.Tensor]:
    """{"a/b/c": f32 tensor on ``device``} for every leaf, from ``seed``."""
    spec = shapes(hp)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    total = sum(_numel(v) for v in spec.values())
    uniform = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    normal_keys = [k for k in spec if k == "emb" or "emb_rel" in k]
    normal = torch.randn(sum(_numel(spec[k]) for k in normal_keys), generator=gen, device=device)
    inv = spec["decoder/blocks/invconv/weight"]
    q, _ = torch.linalg.qr(torch.randn(inv, generator=gen, device=device))
    flip = torch.where(torch.linalg.det(q) < 0, -1.0, 1.0)
    q[:, :, 0] *= flip[:, None]

    out: typing.Dict[str, torch.Tensor] = {}
    u_at = n_at = 0
    for key, shape in spec.items():
        n = _numel(shape)
        u = uniform[u_at:u_at + n].view(shape)
        u_at += n
        group, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
        weight = out.get(f"{group}/w", out.get(f"{group}/v"))
        if key in normal_keys:
            a = normal[n_at:n_at + n].view(shape) * (
                hp["hidden_channels"] ** -0.5 if key == "emb" else shape[-1] ** -0.5)
            n_at += n
        elif "/actnorm/" in key:
            a = torch.zeros(shape, device=device)
        elif key.endswith("invconv/weight"):
            a = q
        elif leaf == "gamma":
            a = torch.ones(shape, device=device)
        elif leaf == "beta":
            a = torch.zeros(shape, device=device)
        elif key == "emb_g":
            a = u * 0.1
        elif leaf == "g":
            a = torch.sqrt(torch.sum(weight * weight, dim=(-3, -2)))
        elif key == "proj_w/proj/w":
            a = u * DURATION_WEIGHT_BOUND
        elif key == "proj_w/proj/b":
            a = torch.full(shape, DURATION_BIAS, device=device)
        elif leaf == "b":
            a = u * (weight.shape[-3] * weight.shape[-2]) ** -0.5
        elif group.startswith("encoder/attn") and group.split("/")[-1] in ("q", "k", "v"):
            k, c_in, c_out = shape[-3:]
            a = u * math.sqrt(6.0 / (c_in * k + c_out * k))
        else:
            a = u * (shape[-3] * shape[-2]) ** -0.5
            if group.endswith(("coupling/end", "prenet/proj")):
                a = a * LIVE_ZERO_INIT
        out[key] = a.to(torch.float32).contiguous()
    return out

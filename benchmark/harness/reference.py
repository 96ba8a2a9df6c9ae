"""Plain PyTorch Glow-TTS, the yardstick that decides ``correct``.

A frozen copy of the plain (CPU) paths of ``glow_tts_train_tpu_torch`` at
commit fd792a0, in float32 and written op by op on the raw parameter tree:

* ``ops/wn_cuda.py`` ``portable_bits``/``regen_keep``/``site_dropout``
  (the kernels' dropout hash) and ``wn_stack_plain``;
* ``ops/attention.py`` ``attention_core`` (rel-pos attention) and
  ``draw_seed``; ``ops/encoder_cuda.py`` ``encoder_layer_plain``;
  ``ops/text_cuda.py`` ``prenet_plain`` and ``duration_stack_plain``;
* ``ops/flows.py`` (squeeze, ActNorm, InvConvNear, the affine coupling,
  DDI) and the inverse block of ``ops/block_cuda.py`` as its three
  bijectors' inverses one after the other;
* ``ops/mas_cuda.py`` ``maximum_path_plain``; ``ops/masks.py``;
  ``models/losses.py``; ``optimize.py`` (value clip, Noam-scheduled Adam);
* ``training.py`` ``dropout_seed``, and ``models/glow_tts.py``
  ``forward_train``/``forward_gen``'s order of dropout seeds.

What changed in the copy: every product goes through :class:`Products`
(in the ``fp8`` control its operands rounded to e4m3 and, in the backward,
the gradient it receives to e5m2, each with a per-tensor scale, as fp8
training rounds them; TF32 allowed in the ``tf32`` control, off
otherwise); the flow block runs
its bijectors op by op instead of the kernels' folded weights; the losses
are written as numerators over the whole batch's denominators, so that
the gradient can be summed over blocks of rows; the inverse InvConvNear
takes ``torch.linalg.inv`` of its dense channel map.  Nothing here imports
the program or takes a tensor it made.
"""

import contextlib
import math
import typing

import numpy as np
import torch
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
LN_EPS = 1e-4
FP8_MAX = 448.0  # largest float8_e4m3fn
E5M2_MAX = 57344.0  # largest float8_e5m2


def _fp8(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """x through an fp8 format with a per-tensor scale, back in f32."""
    scale = largest / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 on its way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class Products:
    """How the reference computes its products: ``f32`` (the reference),
    ``tf32`` or ``fp8`` (controls one precision below what a cell
    states)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        """x as the product reads it: fp8 e4m3 in the ``fp8`` mode (the
        gradient passes straight through)."""
        if self.mode != "fp8":
            return x
        return x + (_fp8(x.detach(), torch.float8_e4m3fn, FP8_MAX) - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result: in the ``fp8`` mode the gradient it receives
        is rounded to e5m2 before the backward's products read it."""
        if self.mode != "fp8" or not y.requires_grad:
            return y
        return _GradE5M2.apply(y)

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.out(self.rnd(a) @ self.rnd(w))

    @contextlib.contextmanager
    def context(self):
        """TF32 on only in the ``tf32`` mode, restored afterwards."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# --------------------------------------------------------------------------
# dropout: the kernels' portable counter hash and the seeds' order
# --------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def portable_bits(seed: torch.Tensor, shape: typing.Tuple[int, int]) -> torch.Tensor:
    t, n = shape
    seed = seed & MASK32
    x = torch.arange(t * n, dtype=torch.int64, device=seed.device).reshape(t, n)
    x = x ^ _mul32(seed[..., None, None], 2654435761)
    x = _mul32(x ^ (x >> 13), 0x9E3779B1)
    x = _mul32(x ^ (x >> 15), 0x85EBCA6B)
    return x ^ (x >> 16)


def threshold(p: float) -> int:
    return min(round(p * 2 ** 32), 2 ** 32 - 1)


def keep_mask(seeds: torch.Tensor, site: int, n_sites: int, shape, p: float) -> torch.Tensor:
    """0/1 keep mask [b, t, n] of one dropout site; ``seeds`` [b] per sample."""
    site_seed = (_mul32(seeds & MASK32, n_sites) + site) & MASK32
    return (portable_bits(site_seed, shape) >= threshold(p)).to(torch.float32)


def site_dropout(x: torch.Tensor, seed: int, site: int, n_sites: int, p: float) -> torch.Tensor:
    """Inverted dropout of x [b, t, n] (or [b, heads, t, n], one site a
    head from ``site`` on): sample i keeps by the hash of ``seed + i``."""
    if p <= 0.0:
        return x
    seeds = seed + torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    shape = tuple(x.shape[-2:])
    if x.dim() == 4:
        keep = torch.stack([keep_mask(seeds, site + hd, n_sites, shape, p)
                            for hd in range(x.shape[1])], dim=1)
    else:
        keep = keep_mask(seeds, site, n_sites, shape, p)
    return x * keep * (1.0 / (1.0 - p))


def dropout_seed(seed: int, step: int) -> int:
    """The seed of a step's dropout draws (1-indexed global step)."""
    return (int(seed) + (int(step) - 1) * 0x9E3779B97F4A7C15) % (1 << 64)


class Seeds:
    """A step's per-site dropout seeds, drawn in the program's order from
    a CPU generator seeded with :func:`dropout_seed`; ``first_row`` offsets
    them for a block of rows of the batch (sample i draws from seed + i)."""

    def __init__(self, seed: int, step: int):
        gen = torch.Generator().manual_seed(dropout_seed(seed, step))
        # prenet, one per encoder layer, duration stack, one per flow block
        self.values = [int(torch.randint(0, 2 ** 31 - 1, (), generator=gen)) for _ in range(64)]
        self.next = 0

    def draw(self) -> int:
        value = self.values[self.next]
        self.next += 1
        return value


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def time_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    pos = torch.arange(t, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(torch.float32)[:, :, None]


def layer_norm(x, gamma, beta):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * gamma.reshape(-1) + beta.reshape(-1)


def weight_norm(p) -> torch.Tensor:
    """w = g v / ||v||, the norm over (k, c_in) of a [k, c_in, c_out] weight."""
    v = p["v"]
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True))
    return v * (p["g"][None, None, :] / torch.clamp(norm, min=1e-12))


def weight(p) -> torch.Tensor:
    return weight_norm(p) if "v" in p else p["w"]


def shifted(x: torch.Tensor, off: int) -> torch.Tensor:
    t = x.shape[1]
    if off >= 0:
        s = min(off, t)
        return F.pad(x[:, s:], (0, 0, 0, s))
    s = min(-off, t)
    return F.pad(x[:, : t - s], (0, 0, s, 0))


def conv(pr: Products, x: torch.Tensor, p, dilation: int = 1) -> torch.Tensor:
    """Channels-last conv with "same" padding: x [b, t, c_in], weight
    [k, c_in, c_out] -> [b, t, c_out], as the im2col product."""
    w = weight(p)
    k = w.shape[0]
    if k == 1:
        return pr.mm(x, w[0]) + p["b"]
    cols = torch.cat([shifted(x, dilation * (j - k // 2)) for j in range(k)], dim=-1)
    return pr.mm(cols, w.reshape(k * w.shape[1], w.shape[2])) + p["b"]


def index(tree, i: int):
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# text side
# --------------------------------------------------------------------------

def rel_embeddings(rel: torch.Tensor, length: int, window: int) -> torch.Tensor:
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        rel = F.pad(rel, (0, 0, pad, pad))
    return rel[:, start:start + 2 * length - 1]


def rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def attention(pr, q, k, v, mask2d, n_heads, rel_k, rel_v, window, drop):
    b, t, ch = q.shape
    d = ch // n_heads

    def heads(u):
        return pr.rnd(u).reshape(b, t, n_heads, d).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scale = 1.0 / math.sqrt(d)
    scores = pr.out(torch.einsum("bhtd,bhsd->bhts", q, k)) * scale
    rk = pr.rnd(rel_embeddings(rel_k[None], t, window))
    logits = pr.out(torch.einsum("bhld,hmd->bhlm", q, rk.expand(n_heads, -1, -1)))
    scores = scores + rel_to_abs(logits) * scale
    scores = torch.where(mask2d[:, None] == 0, torch.full_like(scores, -1e4), scores)
    probs = pr.rnd(drop(torch.softmax(scores, dim=-1)))
    out = pr.out(torch.einsum("bhts,bhsd->bhtd", probs, v))
    rv = pr.rnd(rel_embeddings(rel_v[None], t, window))
    out = out + pr.out(torch.einsum("bhlm,hmd->bhld", abs_to_rel(probs),
                                    rv.expand(n_heads, -1, -1)))
    return out.transpose(1, 2).reshape(b, t, ch)


def encoder_layer(pr, p, x, x_mask, n_heads, window, p_drop, seed):
    h = x.shape[-1]
    n_sites = n_heads + 3

    def drop(a, site):
        return site_dropout(a, seed, site, n_sites, p_drop)

    m = x_mask[:, :, 0]
    at = p["attn"]
    xm = x * x_mask
    att = attention(
        pr, conv(pr, xm, at["q"]), conv(pr, xm, at["k"]), conv(pr, xm, at["v"]),
        m[:, None, :] * m[:, :, None], n_heads, at["emb_rel_k"][0], at["emb_rel_v"][0], window,
        lambda probs: drop(probs, 0),
    )
    x1 = layer_norm(xm + drop(conv(pr, att, at["o"]), n_heads), p["norm_1"]["gamma"],
                    p["norm_1"]["beta"])
    r = drop(torch.relu(conv(pr, x1 * x_mask, p["ffn"]["conv_1"])), n_heads + 1)
    y2 = drop(conv(pr, r * x_mask, p["ffn"]["conv_2"]) * x_mask, n_heads + 2)
    return layer_norm(x1 + y2, p["norm_2"]["gamma"], p["norm_2"]["beta"])


def prenet(pr, p, x, x_mask, p_drop, seed):
    layers = p["layers"]
    n_layers = layers["conv"]["w"].shape[0]
    cur = x
    for l in range(n_layers):
        lp = index(layers, l)
        y = layer_norm(conv(pr, cur * x_mask, lp["conv"]), lp["norm"]["gamma"], lp["norm"]["beta"])
        cur = torch.relu(y)
        if seed is not None:
            cur = site_dropout(cur, seed, l, n_layers, p_drop)
    return (x + conv(pr, cur, p["proj"])) * x_mask


def duration_predictor(pr, p, x, x_mask, p_drop, seed):
    cur = x
    for l, (c, n) in enumerate((("conv_1", "norm_1"), ("conv_2", "norm_2"))):
        cur = layer_norm(torch.relu(conv(pr, cur * x_mask, p[c])), p[n]["gamma"], p[n]["beta"])
        if seed is not None:
            cur = site_dropout(cur, seed, l, 2, p_drop)
    return conv(pr, cur * x_mask, p["proj"]) * x_mask


def speaker_vector(params, g_ids):
    if g_ids is None:
        return None
    g = params["emb_g"][g_ids]
    norm = torch.sqrt(torch.sum(torch.square(g), dim=-1, keepdim=True))
    return (g / torch.clamp(norm, min=1e-12))[:, None, :]


def encoder(pr, hp, params, x, x_lengths, g, seeds=None, first_row=0):
    """-> (x_m, x_logs, logw, x_mask); dropout on when ``seeds`` is given."""
    t_x = x.shape[1]
    h = hp["hidden_channels"]

    def seed_of():
        return None if seeds is None else (seeds.draw() + first_row) % 2 ** 32

    xh = params["emb"][x] * math.sqrt(h)
    x_mask = time_mask(x_lengths, t_x)
    if hp["prenet"]:
        seed = seed_of()
        xh = prenet(pr, params["prenet"], xh, x_mask, 0.5, seed)
    for i in range(hp["n_layers_enc"]):
        seed = seed_of()
        xh = encoder_layer(pr, index(params["encoder"], i), xh, x_mask, hp["n_heads"],
                           hp["window_size"], 0.0 if seed is None else hp["p_dropout"], seed or 0)
    xh = xh * x_mask
    x_dp = xh.detach()
    if g is not None:
        x_dp = torch.cat([x_dp, g.expand(-1, t_x, -1)], dim=-1)
    x_m = conv(pr, xh, params["proj_m"]) * x_mask
    x_logs = torch.zeros_like(x_m) if hp["mean_only"] else conv(pr, xh, params["proj_s"]) * x_mask
    logw = duration_predictor(pr, params["proj_w"], x_dp, x_mask, hp["p_dropout"], seed_of())
    return x_m, x_logs, logw, x_mask


# --------------------------------------------------------------------------
# flow decoder
# --------------------------------------------------------------------------

def squeeze(x, x_mask, n_sqz):
    b, t, c = x.shape
    t = (t // n_sqz) * n_sqz
    x = x[:, :t].reshape(b, t // n_sqz, n_sqz * c)
    x_mask = x_mask[:, n_sqz - 1::n_sqz]
    return x * x_mask, x_mask


def unsqueeze(x, x_mask, n_sqz):
    b, t, c = x.shape
    x = x.reshape(b, t * n_sqz, c // n_sqz)
    x_mask = torch.repeat_interleave(x_mask, n_sqz, dim=1)
    return x * x_mask, x_mask


def invconv_dense(w: torch.Tensor, c: int, s: int) -> torch.Tensor:
    """The s x s group mix of InvConvNear as its dense [c, c] channel map."""
    ch = np.arange(c)
    a = ch // (c // 2)
    q = (ch % (c // 2)) // (s // 2)
    r = ch % (s // 2)
    sel = np.zeros((c, s), np.float32)
    sel[ch, a * (s // 2) + r] = 1.0
    qqt = (q[:, None] == q[None, :]).astype(np.float32)
    sel = torch.as_tensor(sel, device=w.device)
    return (sel @ w @ sel.T) * torch.as_tensor(qqt, device=w.device)


def wn_stack(pr, wn, hidden, x, x_mask, g, kernel_size, dilation_rate, p_drop, seed):
    """The gated WaveNet stack -> skip sum; the pre-gate tensor dropped with
    the hash masks of ``seed`` when ``p_drop`` > 0."""
    n_layers = wn["in_layers"]["v"].shape[0]
    b, t, h = x.shape
    g_all = None
    if g is not None:
        g_all = conv(pr, g, wn["cond"]).reshape(b, n_layers, 2 * hidden)
    seeds = seed + torch.arange(b, dtype=torch.int64, device=x.device)
    skip = torch.zeros_like(x)
    for l in range(n_layers):
        xin = conv(pr, x, index(wn["in_layers"], l), dilation_rate ** l)
        if p_drop > 0.0:
            xin = xin * keep_mask(seeds, l, n_layers, (t, 2 * h), p_drop) * (1.0 / (1.0 - p_drop))
        if g_all is not None:
            xin = xin + g_all[:, l][:, None, :]
        acts = torch.tanh(xin[..., :h]) * torch.sigmoid(xin[..., h:])
        if l < n_layers - 1:
            rs = conv(pr, acts, index(wn["res_skip"], l))
            x = (x + rs[..., :h]) * x_mask
            skip = skip + rs[..., h:]
        else:
            skip = skip + conv(pr, acts, wn["res_skip_last"])
    return skip


def coupling(pr, hp, p, x, x_mask, g, p_drop=0.0, seed=0, reverse=False):
    c2 = x.shape[-1] // 2
    x0, x1 = x[..., :c2], x[..., c2:]
    h = conv(pr, x0, p["start"]) * x_mask
    skip = wn_stack(pr, p["wn"], hp["hidden_channels"], h, x_mask, g, hp["kernel_size_dec"],
                    hp["dilation_rate"], p_drop, seed)
    out = conv(pr, skip * x_mask, p["end"])
    m, logs = out[..., :c2], out[..., c2:]
    if reverse:
        z1 = (x1 - m) * torch.exp(-logs) * x_mask
    else:
        z1 = (m + torch.exp(logs) * x1) * x_mask
    return torch.cat([x0, z1], dim=-1), torch.sum(logs * x_mask, dim=(1, 2))


def invconv(pr, p, x, x_mask, n_split):
    c = x.shape[-1]
    m = invconv_dense(p["weight"], c, n_split)
    x_len = torch.sum(x_mask, dim=(1, 2))
    logdet = torch.linalg.slogdet(p["weight"])[1] * (c / n_split) * x_len
    return pr.mm(x, m.T) * x_mask, logdet


def actnorm(p, x, x_mask):
    z = (p["bias"] + torch.exp(p["logs"]) * x) * x_mask
    return z, torch.sum(p["logs"]) * torch.sum(x_mask, dim=(1, 2))


def decoder_forward(pr, hp, blocks, y, y_mask, g, seeds=None, first_row=0):
    """mel -> (z, logdet [b]); dropout on when ``seeds`` is given."""
    x, x_mask = squeeze(y, y_mask, hp["n_sqz"])
    logdet = 0.0
    for i in range(blocks["actnorm"]["logs"].shape[0]):
        bp = index(blocks, i)
        seed = 0 if seeds is None else (seeds.draw() + first_row) % 2 ** 32
        p_drop = 0.0 if seeds is None else hp["p_dropout_dec"]
        x, ld1 = actnorm(bp["actnorm"], x, x_mask)
        x, ld2 = invconv(pr, bp["invconv"], x, x_mask, hp["n_split"])
        x, ld3 = coupling(pr, hp, bp["coupling"], x, x_mask, g, p_drop, seed)
        logdet = logdet + ld1 + ld2 + ld3
    x, _ = unsqueeze(x, x_mask, hp["n_sqz"])
    return x, logdet


def decoder_inverse(pr, hp, blocks, z, z_mask, g):
    x, x_mask = squeeze(z, z_mask, hp["n_sqz"])
    c = x.shape[-1]
    for i in reversed(range(blocks["actnorm"]["logs"].shape[0])):
        bp = index(blocks, i)
        x, _ = coupling(pr, hp, bp["coupling"], x, x_mask, g, reverse=True)
        m_inv = torch.linalg.inv(invconv_dense(bp["invconv"]["weight"], c, hp["n_split"]))
        x = pr.mm(x, m_inv.T) * x_mask
        an = bp["actnorm"]
        x = (x - an["bias"]) * torch.exp(-an["logs"]) * x_mask
    x, _ = unsqueeze(x, x_mask, hp["n_sqz"])
    return x


@torch.no_grad()
def ddi(pr, hp, params, y, y_lengths, g_ids):
    """Data-dependent ActNorm init on one batch: each block's ActNorm from
    the masked statistics of its input -> {"logs", "bias"} [n_blocks, c]."""
    g = speaker_vector(params, g_ids)
    t_y = (y.shape[1] // hp["n_sqz"]) * hp["n_sqz"]
    y_lengths = (y_lengths // hp["n_sqz"]) * hp["n_sqz"]
    x, x_mask = squeeze(y[:, :t_y], time_mask(y_lengths, t_y), hp["n_sqz"])
    blocks = params["decoder"]["blocks"]
    logs_all, bias_all = [], []
    for i in range(blocks["actnorm"]["logs"].shape[0]):
        bp = index(blocks, i)
        c = x.shape[-1]
        n = torch.sum(x_mask).expand(c)
        m = torch.sum(x * x_mask, dim=(0, 1)) / n
        m_sq = torch.sum(x * x * x_mask, dim=(0, 1)) / n
        logs = 0.5 * torch.log(torch.clamp(m_sq - m ** 2, min=1e-6))
        an = {"bias": -m * torch.exp(-logs), "logs": -logs}
        logs_all.append(an["logs"])
        bias_all.append(an["bias"])
        x, _ = actnorm(an, x, x_mask)
        x, _ = invconv(pr, bp["invconv"], x, x_mask, hp["n_split"])
        x, _ = coupling(pr, hp, bp["coupling"], x, x_mask, g)
    return {"logs": torch.stack(logs_all), "bias": torch.stack(bias_all)}


# --------------------------------------------------------------------------
# alignment, losses, training step
# --------------------------------------------------------------------------

@torch.no_grad()
def maximum_path(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment search: the column scan (ties stay) and the
    backtrace -> 0/1 path [b, t_x, t_y]."""
    b, t_x, t_y = logp.shape
    device = logp.device
    value = logp * mask
    t_x_len = mask[:, :, 0].sum(1).to(torch.int64)
    t_y_len = mask[:, 0, :].sum(1).to(torch.int64)
    x_range = torch.arange(t_x, device=device)
    v = torch.zeros((b, t_x), dtype=torch.float32, device=device)
    neg = torch.full((b, 1), -1e9, dtype=torch.float32, device=device)
    stays = []
    for y in range(t_y):
        v0 = torch.cat([neg, v[:, :-1]], dim=1)
        stay = v >= v0
        v = torch.where(x_range[None, :] <= y, torch.where(stay, v, v0) + value[:, :, y], -1e9)
        stays.append(stay)
    direction = torch.stack(stays, dim=1)
    direction = torch.where(mask.transpose(1, 2) > 0, direction, True).to(torch.int64)
    path = torch.zeros((b, t_x, t_y), dtype=torch.float32, device=device)
    idx = torch.clamp(t_x_len - 1, min=0)
    rows = torch.arange(b, device=device)
    for y in range(t_y - 1, -1, -1):
        active = y < t_y_len
        path[rows, idx, y] = active.to(torch.float32)
        d = direction[rows, y, idx]
        d = torch.where(idx == 0, 1, torch.where(idx == y, 0, d))
        idx = torch.where(active, torch.clamp(idx + d - 1, min=0), idx)
    return path * mask


def numerators(pr, hp, params, batch, seeds, first_row):
    """The MLE and duration losses' numerators of a block of rows (their
    denominators are the whole batch's)."""
    g = speaker_vector(params, batch.get("speaker_ids"))
    x_m, x_logs, logw, x_mask = encoder(pr, hp, params, batch["x"], batch["x_lengths"], g,
                                        seeds, first_row)
    n_sqz = hp["n_sqz"]
    y = batch["y"]
    t_y = (y.shape[1] // n_sqz) * n_sqz
    y_lengths = (batch["y_lengths"] // n_sqz) * n_sqz
    z_mask = time_mask(y_lengths, t_y)
    z, logdet = decoder_forward(pr, hp, params["decoder"]["blocks"], y[:, :t_y], z_mask, g,
                                seeds, first_row)
    attn_mask = x_mask[:, :, 0][:, :, None] * z_mask[:, :, 0][:, None, :]
    with torch.no_grad():
        s_sq_r = torch.exp(-2.0 * x_logs)
        logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - x_logs, dim=-1)[:, :, None]
        logp2 = torch.einsum("bxd,byd->bxy", s_sq_r, -0.5 * torch.square(z))
        logp3 = torch.einsum("bxd,byd->bxy", x_m * s_sq_r, z)
        logp4 = torch.sum(-0.5 * torch.square(x_m) * s_sq_r, dim=-1)[:, :, None]
        attn = maximum_path(logp1 + logp2 + logp3 + logp4, attn_mask)
    z_m = torch.einsum("bxy,bxd->byd", attn, x_m)
    z_logs = torch.einsum("bxy,bxd->byd", attn, x_logs)
    logw_ = torch.log(1e-8 + torch.sum(attn, dim=2))[:, :, None] * x_mask
    n_mle = (torch.sum(z_logs) + 0.5 * torch.sum(torch.exp(-2.0 * z_logs) * torch.square(z - z_m))
             - torch.sum(logdet))
    n_dur = torch.sum(torch.square(logw - logw_))
    return n_mle, n_dur


def denominators(hp, batch):
    n_sqz = hp["n_sqz"]
    frames = torch.sum(((batch["y_lengths"] // n_sqz) * n_sqz).to(torch.float32))
    return frames * hp["mel_channels"], torch.sum(batch["x_lengths"].to(torch.float32))


def rows(batch, start, stop):
    return {k: v[start:stop] for k, v in batch.items()}


def loss_and_grads(pr, hp, params, batch, seed, step, block_rows):
    """One step's loss, its MLE term and the gradient of every leaf, the
    batch in blocks of ``block_rows`` rows (each block drawing its rows'
    dropout masks)."""
    leaves = {k: v for k, v in flatten(params).items()}
    d_mle, d_dur = denominators(hp, batch)
    b = batch["x"].shape[0]
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    num_mle = num_dur = 0.0
    for start in range(0, b, block_rows):
        tree = unflatten({k: v.detach().requires_grad_(True) for k, v in leaves.items()})
        flat = flatten(tree)
        n_mle, n_dur = numerators(pr, hp, tree, rows(batch, start, start + block_rows),
                                  Seeds(seed, step), start)
        total = n_mle / d_mle + n_dur / d_dur
        got = torch.autograd.grad(total, list(flat.values()), allow_unused=True)
        for k, gr in zip(flat, got):
            if gr is not None:
                grads[k] += gr
        num_mle, num_dur = num_mle + float(n_mle.detach()), num_dur + float(n_dur.detach())
    mle = num_mle / float(d_mle) + 0.5 * math.log(2 * math.pi)
    return mle + num_dur / float(d_dur), mle, grads


def noam(hp, opt, count: int) -> float:
    step = torch.tensor(count + 1.0, dtype=torch.float32)
    warm = torch.tensor(opt["warmup_steps"] ** -1.5, dtype=torch.float32)
    scale = hp["hidden_channels"] ** -0.5 * torch.minimum(step ** -0.5, step * warm)
    return float(opt["learning_rate"] * scale)


@torch.no_grad()
def adam(hp, opt, params, grads, state):
    b1, b2 = opt["betas"]
    count = state["count"] + 1
    lr = noam(hp, opt, state["count"])
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
    for k, p in params.items():
        g = torch.clamp(grads[k], -opt["grad_clip"], opt["grad_clip"])
        mu = state["mu"][k].mul_(b1).add_((1.0 - b1) * g)
        nu = state["nu"][k].mul_(b2).add_((1.0 - b2) * (g * g))
        p.add_(-lr * (mu / bc1.to(mu.device)) / (torch.sqrt(nu / bc2.to(nu.device)) + opt["eps"]))
    state["count"] = count


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def unflatten(flat):
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return out


def to_device(batch, device):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)).to(device)
    return out


def train(hp, opt, weights, ddi_batch, batches, seed, device, mode="f32", block_rows=32,
          half_batch=False):
    """The reference's DDI and steps 1..len(batches) from ``weights``
    ({"a/b/c": f32 tensor}) -> {"loss": [per step], "mle": [its MLE term
    per step], "grad1": clipped
    gradient of step 1, "theta0", "theta_end", "ref_grads": [per step]},
    tensors on the host.  ``half_batch``: the planted fault of a step that
    leaves out half of each batch, the mean taken over the rest."""
    pr = Products(mode)
    params = {k: v.detach().to(device=device, dtype=torch.float32).clone()
              for k, v in weights.items()}
    with pr.context():
        dd = to_device(ddi_batch, device)
        # DDI in f32 in every mode: the program runs it in f32 whatever the
        # step's precision, so a control lowers the step's products alone
        an = ddi(Products(), hp, unflatten(params), dd["y"], dd["y_lengths"],
                 dd.get("speaker_ids") if hp["n_speakers"] > 1 else None)
        params["decoder/blocks/actnorm/logs"].copy_(an["logs"])
        params["decoder/blocks/actnorm/bias"].copy_(an["bias"])
        theta0 = {k: v.cpu().clone() for k, v in params.items()}
        state = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                 "nu": {k: torch.zeros_like(v) for k, v in params.items()}, "count": 0}
        losses, mles, grads_all, grad1 = [], [], [], None
        for i, host in enumerate(batches):
            batch = to_device(host, device)
            if hp["n_speakers"] <= 1:
                batch.pop("speaker_ids", None)
            if half_batch:
                batch = rows(batch, 0, batch["x"].shape[0] // 2)
            loss, mle, grads = loss_and_grads(pr, hp, unflatten(params), batch, seed, i + 1,
                                              block_rows)
            losses.append(loss)
            mles.append(mle)
            clipped = {k: torch.clamp(g, -opt["grad_clip"], opt["grad_clip"]).cpu()
                       for k, g in grads.items()}
            grads_all.append(clipped)
            if i == 0:
                grad1 = clipped
            adam(hp, opt, params, grads, state)
        theta_end = {k: v.cpu().clone() for k, v in params.items()}
    return {"loss": losses, "mle": mles, "grad1": grad1, "theta0": theta0, "theta_end": theta_end,
            "ref_grads": grads_all}


# --------------------------------------------------------------------------
# synthesis
# --------------------------------------------------------------------------

def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(t_y, device=duration.device, dtype=torch.float32)
    path = (pos[None, None, :] < cum[:, :, None]).to(torch.float32)
    path = path - F.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


def pad_ids(sentences, device):
    t = max(len(s) for s in sentences)
    x = np.zeros((len(sentences), t), np.int64)
    for i, s in enumerate(sentences):
        x[i, :len(s)] = s
    lengths = np.asarray([len(s) for s in sentences], np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(lengths).to(device)


def speaker_ids(speaker, n, device):
    if speaker is None:
        return None
    return torch.full((n,), int(speaker), dtype=torch.int64, device=device)


@torch.no_grad()
def synthesize(hp, weights, sentences, device, length_scale=1.0, mode="f32", frames=None,
               speaker=None, with_durations=False):
    """Noise-free mels [n_mel, t] of ``sentences`` (lists of phoneme ids),
    with ``with_durations`` also each sentence's per-phoneme durations
    before rounding.  ``frames``: per sentence, the integer frames of each
    phoneme to use in place of the ceiling of the reference's own durations
    (a phoneme whose duration lies on a frame boundary may round either
    way)."""
    pr = Products(mode)
    params = unflatten({k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()})
    x, x_lengths = pad_ids(sentences, device)
    with pr.context():
        g = speaker_vector(params, speaker_ids(speaker, len(sentences), device))
        x_m, x_logs, logw, x_mask = encoder(pr, hp, params, x, x_lengths, g)
        dur = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(dur)
        if frames is not None:
            for i, f in enumerate(frames):
                if f is not None:
                    w_ceil[i, :len(f), 0] = torch.as_tensor(f, dtype=torch.float32, device=device)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0).to(torch.int64)
        y_lengths = (y_lengths // hp["n_sqz"]) * hp["n_sqz"]
        t_y = int(y_lengths.max()) + hp["n_sqz"]
        t_y = (t_y // hp["n_sqz"]) * hp["n_sqz"]
        z_mask = time_mask(y_lengths, t_y)
        attn_mask = x_mask[:, :, 0][:, :, None] * z_mask[:, :, 0][:, None, :]
        attn = generate_path(w_ceil[:, :, 0], attn_mask)
        z_m = torch.einsum("bxy,bxd->byd", attn, x_m)
        y = decoder_inverse(pr, hp, params["decoder"]["blocks"], z_m * z_mask, z_mask, g)
        y = y.cpu().numpy()
        lengths = y_lengths.cpu().numpy()
        dur = dur[:, :, 0].cpu().numpy()
    mels = [y[i, :lengths[i]].T for i in range(len(sentences))]
    if with_durations:
        return mels, [dur[i, :len(s)] for i, s in enumerate(sentences)]
    return mels

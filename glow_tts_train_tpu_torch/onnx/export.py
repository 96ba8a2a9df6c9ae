"""The Glow-TTS generation graph as opset-12 ONNX, built directly.

The reference gets its ``generator.onnx`` by tracing the torch module with
``torch.onnx.export`` (reference export_onnx.py:105-118: opset 12, inputs
``input``/``input_lengths``/``scales``, dynamic batch/phoneme/time axes).
This module produces the equivalent artifact from the framework's param
pytree with no torch, no tf2onnx, and no jax — the graph is hand-built on
the wire codec (proto.py) through :class:`~.builder.GraphBuilder`, so the
export works in any environment the framework itself runs in.

Signature parity (export_onnx.py:106-118 + infer_onnx.py:120-128):

    input          [batch_size, phonemes]  int64
    input_lengths  [batch_size]            int64
    scales         [2]                     float32  (noise_scale, length_scale)
    -->
    output         [batch_size, mel_channels, time]  float32
    output_lengths [batch_size]            int64

All shapes are dynamic (ONNX graphs, unlike XLA, carry symbolic dims): the
output time axis is the true max predicted length, not a padded budget.
Weight-norm is folded, the InvConvNear inverse is precomputed as a dense
[c, c] channel map (ops/flows.py:154-169 semantics), and multispeaker
models bake one speaker's conditioning in as constants (one artifact per
voice — the exported signature has no speaker input, matching the
reference).  Noise is a ``RandomNormalLike`` node exactly like the traced
``torch.randn_like`` (models.py:352); run with noise_scale=0 for
deterministic output.
"""

from __future__ import annotations

import math
import typing

import numpy as np

from . import proto
from .builder import GraphBuilder

BIG = 2**62  # "to the end" slice bound


# ---------------------------------------------------------------------------
# Param pytree helpers (pure numpy)
# ---------------------------------------------------------------------------


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" and arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return arr


def _index_tree(tree, i: int):
    """Slice layer ``i`` out of a parameter-stacked pytree."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _conv_wb(p: dict) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Fold weight-norm if present; returns (w [k, c_in, c_out], b [c_out])."""
    if "v" in p:
        v = np.asarray(p["v"], np.float64)
        g = np.asarray(p["g"], np.float64)
        norm = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))
        w = (v * (g[None, None, :] / np.maximum(norm, 1e-12))).astype(np.float32)
    else:
        w = np.asarray(p["w"], np.float32)
    return w, np.asarray(p["b"], np.float32)


def _invconv_dense_inverse(p: dict, c: int, n_split: int) -> np.ndarray:
    """Dense [c, c] inverse channel map (ops/flows.py:131-169 semantics)."""
    if "weight_inv" in p:
        w_inv = np.asarray(p["weight_inv"], np.float64)
    else:
        w_inv = np.linalg.inv(np.asarray(p["weight"], np.float64))
    s = n_split
    ch = np.arange(c)
    a = ch // (c // 2)
    q = (ch % (c // 2)) // (s // 2)
    r = ch % (s // 2)
    group = a * (s // 2) + r
    sel = np.zeros((c, s))
    sel[ch, group] = 1.0
    qqt = (q[:, None] == q[None, :]).astype(np.float64)
    m = (sel @ w_inv @ sel.T) * qqt
    return m.astype(np.float32)


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------


class _Gen:
    """Stateful helper over GraphBuilder for the generator graph."""

    def __init__(self, g: GraphBuilder):
        self.g = g
        self._dim_cache: typing.Dict[typing.Tuple[str, int], str] = {}

    # -- shape arithmetic (all 1-D [1] int64 tensors) -----------------------

    def dim(self, x: str, i: int) -> str:
        key = (x, i)
        if key not in self._dim_cache:
            shape = self.g.node("Shape", [x])
            self._dim_cache[key] = self.g.node(
                "Gather", [shape, self.g.i64([i])], axis=0
            )
        return self._dim_cache[key]

    def scalar(self, x1d: str) -> str:
        return self.g.node("Squeeze", [x1d], axes=[0])

    def iadd(self, a: str, k: int) -> str:
        return self.g.node("Add", [a, self.g.i64([k])])

    def isub(self, a: str, k: int) -> str:
        return self.g.node("Sub", [a, self.g.i64([k])])

    def imul(self, a: str, k: int) -> str:
        return self.g.node("Mul", [a, self.g.i64([k])])

    def imax0(self, a: str) -> str:
        return self.g.node("Max", [a, self.g.i64([0])])

    def concat(self, parts: typing.Sequence[str], axis: int = 0) -> str:
        return self.g.node("Concat", list(parts), axis=axis)

    def reshape(self, x: str, shape_parts: typing.Sequence[str]) -> str:
        return self.g.node("Reshape", [x, self.concat(shape_parts)])

    # -- elementwise conveniences -------------------------------------------

    def mul(self, a: str, b: str) -> str:
        return self.g.node("Mul", [a, b])

    def add(self, a: str, b: str) -> str:
        return self.g.node("Add", [a, b])

    def sub(self, a: str, b: str) -> str:
        return self.g.node("Sub", [a, b])

    # -- layers ---------------------------------------------------------------

    def matmul1x1(self, x: str, p: dict, hint: str) -> str:
        """1x1 conv on [b, t, c] == MatMul + bias (ops/conv.py:137-140)."""
        w, b = _conv_wb(p)
        wn = self.g.init(f"{hint}_w", w[0])  # [c_in, c_out]
        bn = self.g.init(f"{hint}_b", b)
        return self.add(self.g.node("MatMul", [x, wn]), bn)

    def conv_k(self, x: str, p: dict, hint: str, dilation: int = 1) -> str:
        """k-wide conv on [b, t, c] via NCT Conv (torch-style same padding)."""
        w, b = _conv_wb(p)
        k = w.shape[0]
        if k == 1:
            return self.matmul1x1(x, p, hint)
        pad = (k * dilation - dilation) // 2
        wn = self.g.init(f"{hint}_w", np.transpose(w, (2, 1, 0)))  # [o, i, k]
        bn = self.g.init(f"{hint}_b", b)
        x_nct = self.g.node("Transpose", [x], perm=[0, 2, 1])
        y = self.g.node(
            "Conv",
            [x_nct, wn, bn],
            dilations=[dilation],
            pads=[pad, pad],
            strides=[1],
            kernel_shape=[k],
        )
        return self.g.node("Transpose", [y], perm=[0, 2, 1])

    def layer_norm(self, x: str, p: dict, hint: str, eps: float = 1e-4) -> str:
        """Channel LayerNorm over the last axis (ops/norms.py:22-32)."""
        mean = self.g.node("ReduceMean", [x], axes=[-1], keepdims=1)
        d = self.sub(x, mean)
        var = self.g.node("ReduceMean", [self.mul(d, d)], axes=[-1], keepdims=1)
        inv = self.g.node(
            "Reciprocal",
            [self.g.node("Sqrt", [self.add(var, self.g.f32_scalar(eps))])],
        )
        y = self.mul(d, inv)
        y = self.mul(y, self.g.init(f"{hint}_g", np.asarray(p["gamma"], np.float32)))
        return self.add(y, self.g.init(f"{hint}_b", np.asarray(p["beta"], np.float32)))

    def sequence_mask(self, lengths: str, t1d: str) -> str:
        """[b] int64 lengths + [1] int64 max-length -> [b, t, 1] f32 mask."""
        r = self.g.node(
            "Range",
            [self.g.i64_scalar(0), self.scalar(t1d), self.g.i64_scalar(1)],
        )
        r2 = self.g.node("Unsqueeze", [r], axes=[0])  # [1, t]
        l2 = self.g.node("Unsqueeze", [lengths], axes=[1])  # [b, 1]
        m = self.g.node("Less", [r2, l2])
        m = self.g.node("Cast", [m], to=proto.FLOAT)
        return self.g.node("Unsqueeze", [m], axes=[2])

    def pad_axis(self, x: str, rank: int, axis: int, begin: str, end: str) -> str:
        """Pad one axis by dynamic [1] int64 amounts (zeros elsewhere)."""
        zeros = self.g.i64([0])
        parts = []
        for i in range(rank):
            parts.append(begin if i == axis else zeros)
        for i in range(rank):
            parts.append(end if i == axis else zeros)
        return self.g.node("Pad", [x, self.concat(parts)], mode="constant")


def _relative_to_absolute(G: _Gen, x: str, b: str, h: int, t: str) -> str:
    """[b, h, t, 2t-1] -> [b, h, t, t] (ops/attention.py:68-74)."""
    g = G.g
    zero = g.i64([0])
    t2 = G.imul(t, 2)  # 2t
    # pad last dim by (0, 1) -> [b, h, t, 2t]
    x = G.pad_axis(x, 4, 3, zero, g.i64([1]))
    # -> [b, h, t*2t]
    x = G.reshape(x, [b, g.i64([h]), G.g.node("Mul", [t, t2])])
    # pad last by (0, t-1)
    x = G.pad_axis(x, 3, 2, zero, G.isub(t, 1))
    # -> [b, h, t+1, 2t-1]
    x = G.reshape(x, [b, g.i64([h]), G.iadd(t, 1), G.isub(t2, 1)])
    # slice [:, :, :t, t-1:]
    starts = G.concat([zero, G.isub(t, 1)])
    ends = G.concat([t, g.i64([BIG])])
    return g.node("Slice", [x, starts, ends, g.i64([2, 3])])


def _absolute_to_relative(G: _Gen, x: str, b: str, h: int, t: str) -> str:
    """[b, h, t, t] -> [b, h, t, 2t-1] (ops/attention.py:77-83)."""
    g = G.g
    zero = g.i64([0])
    t2 = G.imul(t, 2)
    # pad last by (0, t-1) -> [b, h, t, 2t-1]
    x = G.pad_axis(x, 4, 3, zero, G.isub(t, 1))
    # -> [b, h, t*(2t-1)]
    flat = g.node("Mul", [t, G.isub(t2, 1)])
    x = G.reshape(x, [b, g.i64([h]), flat])
    # pad front by (t, 0) -> [b, h, 2t^2]
    x = G.pad_axis(x, 3, 2, t, zero)
    # -> [b, h, t, 2t]
    x = G.reshape(x, [b, g.i64([h]), t, t2])
    # slice last [1:]
    return g.node("Slice", [x, g.i64([1]), g.i64([BIG]), g.i64([3])])


def _rel_embedding(
    G: _Gen, emb: np.ndarray, t: str, window_size: int, hint: str
) -> str:
    """Dynamic get_relative_embeddings (ops/attention.py:53-65).

    emb: [1, 2w+1, d] (heads_share) -> graph value [2t-1, d]."""
    g = G.g
    table = g.init(hint, np.asarray(emb[0], np.float32))  # [2w+1, d]
    zero = g.i64([0])
    pl = G.imax0(G.isub(t, window_size + 1))
    ss = G.imax0(g.node("Sub", [g.i64([window_size + 1]), t]))
    # symmetric pad on axis 0
    padded = g.node(
        "Pad", [table, G.concat([pl, zero, pl, zero])], mode="constant"
    )
    ends = G.concat([g.node("Add", [ss, G.isub(G.imul(t, 2), 1)]), g.i64([BIG])])
    return g.node(
        "Slice", [padded, G.concat([ss, zero]), ends, g.i64([0, 1])]
    )


def _mha(
    G: _Gen,
    x: str,
    mask4: str,
    p: dict,
    n_heads: int,
    window_size: typing.Optional[int],
    block_length: typing.Optional[int],
    b: str,
    t: str,
    hint: str,
) -> str:
    """Rel-pos self-attention (ops/attention.py:132-224, deterministic)."""
    g = G.g
    ch = _conv_wb(p["q"])[0].shape[1]
    k_ch = ch // n_heads
    scale = g.f32_scalar(1.0 / math.sqrt(k_ch))

    def heads(name_in: str) -> str:
        r = G.reshape(name_in, [b, t, g.i64([n_heads]), g.i64([k_ch])])
        return g.node("Transpose", [r], perm=[0, 2, 1, 3])

    q = heads(G.matmul1x1(x, p["q"], f"{hint}_q"))
    k = heads(G.matmul1x1(x, p["k"], f"{hint}_k"))
    v = heads(G.matmul1x1(x, p["v"], f"{hint}_v"))

    kt = g.node("Transpose", [k], perm=[0, 1, 3, 2])
    scores = G.mul(g.node("MatMul", [q, kt]), scale)

    if window_size is not None:
        rel_k = _rel_embedding(G, p["emb_rel_k"], t, window_size, f"{hint}_rk")
        rel_logits = g.node(
            "MatMul", [q, g.node("Transpose", [rel_k], perm=[1, 0])]
        )
        rel_abs = _relative_to_absolute(G, rel_logits, b, n_heads, t)
        scores = G.add(scores, G.mul(rel_abs, scale))

    zero_f = G.g.f32_scalar(0.0)
    neg = G.g.f32_scalar(-1e4)
    is_pad = g.node("Equal", [mask4, zero_f])
    scores = g.node("Where", [is_pad, neg, scores])
    if block_length is not None:
        # banded |i-j| <= block_length (ops/attention.py:195-200)
        r = g.node(
            "Range",
            [g.i64_scalar(0), G.scalar(t), g.i64_scalar(1)],
        )
        rows = g.node("Unsqueeze", [r], axes=[1])
        cols = g.node("Unsqueeze", [r], axes=[0])
        dist = g.node("Abs", [G.sub(rows, cols)])
        band = g.node("LessOrEqual", [dist, g.i64_scalar(block_length)])
        band = g.node("Unsqueeze", [band], axes=[0, 1])
        scores = g.node("Where", [band, scores, neg])

    p_attn = g.node("Softmax", [scores], axis=3)
    out = g.node("MatMul", [p_attn, v])

    if window_size is not None:
        rel_w = _absolute_to_relative(G, p_attn, b, n_heads, t)
        rel_v = _rel_embedding(G, p["emb_rel_v"], t, window_size, f"{hint}_rv")
        out = G.add(out, g.node("MatMul", [rel_w, rel_v]))

    out = g.node("Transpose", [out], perm=[0, 2, 1, 3])
    out = G.reshape(out, [b, t, g.i64([ch])])
    return G.matmul1x1(out, p["o"], f"{hint}_o")


def _wn_stack(
    G: _Gen,
    hidden: str,
    mask: str,
    wn: dict,
    g_all: typing.Optional[np.ndarray],
    hidden_channels: int,
    dilation_rate: int,
    n_layers: int,
    hint: str,
) -> str:
    """Gated WaveNet stack, inference (ops/flows.py:250-313)."""
    g = G.g
    h = hidden_channels
    c0 = g.i64([0])
    ch1 = g.i64([h])
    ch2 = g.i64([2 * h])
    ax2 = g.i64([2])
    output = None
    for i in range(n_layers):
        in_p = _index_tree(wn["in_layers"], i)
        x_in = G.conv_k(hidden, in_p, f"{hint}_in{i}", dilation=dilation_rate**i)
        if g_all is not None:
            g_l = g_all[i * 2 * h : (i + 1) * 2 * h].reshape(1, 1, 2 * h)
            x_in = G.add(x_in, g.init(f"{hint}_cond{i}", g_l.astype(np.float32)))
        a = g.node("Slice", [x_in, c0, ch1, ax2])
        bb = g.node("Slice", [x_in, ch1, ch2, ax2])
        acts = G.mul(g.node("Tanh", [a]), g.node("Sigmoid", [bb]))
        if i < n_layers - 1:
            rs_p = _index_tree(wn["res_skip"], i)
            rs = G.matmul1x1(acts, rs_p, f"{hint}_rs{i}")
            res = g.node("Slice", [rs, c0, ch1, ax2])
            skip = g.node("Slice", [rs, ch1, ch2, ax2])
            hidden = G.mul(G.add(hidden, res), mask)
            output = skip if output is None else G.add(output, skip)
        else:
            rs = G.matmul1x1(acts, wn["res_skip_last"], f"{hint}_rsl")
            output = rs if output is None else G.add(output, rs)
    return G.mul(output, mask)


def build_generator_graph(
    params: dict,
    config,
    speaker: int = 0,
) -> GraphBuilder:
    """Build the full generation graph; returns the GraphBuilder.

    ``params``: the model param pytree (init_model layout; numpy or jax
    arrays).  ``config``: TrainingConfig.  Multispeaker conditioning for
    ``speaker`` is folded into constants.
    """
    m = config.model
    n_mel = config.audio.mel_channels
    h_enc = m.hidden_channels_enc or m.hidden_channels
    h_dec = m.hidden_channels_dec or m.hidden_channels
    n_sqz = m.n_sqz
    params = _np_tree(params)

    # speaker conditioning vector [gin] (models/glow_tts.py:435-445)
    g_vec = None
    if m.n_speakers > 1:
        if not 0 <= speaker < m.n_speakers:
            raise ValueError(f"speaker {speaker} out of range [0, {m.n_speakers})")
        g_vec = np.asarray(params["emb_g"][speaker], np.float64)
        g_vec = (g_vec / max(float(np.linalg.norm(g_vec)), 1e-12)).astype(
            np.float32
        )

    g = GraphBuilder("glow_tts_generator")
    G = _Gen(g)

    x = g.input("input", proto.INT64, ["batch_size", "phonemes"])
    x_lengths = g.input("input_lengths", proto.INT64, ["batch_size"])
    scales = g.input("scales", proto.FLOAT, [2])

    b = G.dim(x, 0)
    t_x = G.dim(x, 1)
    noise_scale = g.node("Gather", [scales, g.i64_scalar(0)], axis=0)
    length_scale = g.node("Gather", [scales, g.i64_scalar(1)], axis=0)

    # ---- embedding + mask (models/glow_tts.py:389-391) ----
    emb = g.init("emb", np.asarray(params["emb"], np.float32))
    xh = g.node("Gather", [emb, x], axis=0)  # [b, t, h]
    xh = G.mul(xh, g.f32_scalar(math.sqrt(h_enc)))
    x_mask = G.sequence_mask(x_lengths, t_x)

    # ---- prenet (ops/attention.py:468-513) ----
    if m.prenet:
        pre = params["prenet"]
        x_org = xh
        n_pre = np.asarray(pre["layers"]["conv"]["w"]).shape[0]
        cur = xh
        for i in range(n_pre):
            lp = _index_tree(pre["layers"], i)
            cur = G.conv_k(G.mul(cur, x_mask), lp["conv"], f"pre{i}_conv")
            cur = G.layer_norm(cur, lp["norm"], f"pre{i}_ln")
            cur = g.node("Relu", [cur])
        xh = G.mul(G.add(x_org, G.matmul1x1(cur, pre["proj"], "pre_proj")), x_mask)

    # ---- encoder stack (ops/attention.py:297-434, deterministic) ----
    m_bt = g.node("Squeeze", [x_mask], axes=[2])  # [b, t]
    mask4 = G.mul(
        g.node("Unsqueeze", [m_bt], axes=[1, 3]),
        g.node("Unsqueeze", [m_bt], axes=[1, 2]),
    )  # [b, 1, t, t]
    n_layers_enc = np.asarray(params["encoder"]["norm_1"]["gamma"]).shape[0]
    for i in range(n_layers_enc):
        lp = _index_tree(params["encoder"], i)
        xh = G.mul(xh, x_mask)
        y = _mha(
            G, xh, mask4, lp["attn"], m.n_heads, m.window_size,
            m.block_length, b, t_x, f"enc{i}",
        )
        xh = G.layer_norm(G.add(xh, y), lp["norm_1"], f"enc{i}_ln1")
        f1 = G.conv_k(G.mul(xh, x_mask), lp["ffn"]["conv_1"], f"enc{i}_ffn1")
        f1 = g.node("Relu", [f1])
        f2 = G.conv_k(G.mul(f1, x_mask), lp["ffn"]["conv_2"], f"enc{i}_ffn2")
        y = G.mul(f2, x_mask)
        xh = G.layer_norm(G.add(xh, y), lp["norm_2"], f"enc{i}_ln2")
    xh = G.mul(xh, x_mask)

    # ---- stats + duration projections (models/glow_tts.py:417-432) ----
    x_m = G.mul(G.matmul1x1(xh, params["proj_m"], "proj_m"), x_mask)
    if m.mean_only:
        x_logs = G.mul(x_m, g.f32_scalar(0.0))
    else:
        x_logs = G.mul(G.matmul1x1(xh, params["proj_s"], "proj_s"), x_mask)

    x_dp = xh
    if g_vec is not None:
        g_exp = g.node(
            "Expand",
            [
                g.init("spk", g_vec.reshape(1, 1, -1)),
                G.concat([b, t_x, g.i64([g_vec.shape[0]])]),
            ],
        )
        x_dp = g.node("Concat", [x_dp, g_exp], axis=2)

    dp = params["proj_w"]
    d1 = G.conv_k(G.mul(x_dp, x_mask), dp["conv_1"], "dp_conv1")
    d1 = G.layer_norm(g.node("Relu", [d1]), dp["norm_1"], "dp_ln1")
    d2 = G.conv_k(G.mul(d1, x_mask), dp["conv_2"], "dp_conv2")
    d2 = G.layer_norm(g.node("Relu", [d2]), dp["norm_2"], "dp_ln2")
    logw = G.mul(G.matmul1x1(G.mul(d2, x_mask), dp["proj"], "dp_proj"), x_mask)

    # ---- durations -> lengths (models/glow_tts.py:574-582) ----
    w = G.mul(G.mul(g.node("Exp", [logw]), x_mask), length_scale)
    w_ceil = g.node("Ceil", [w])  # [b, t, 1]
    y_len_f = g.node("ReduceSum", [w_ceil], axes=[1, 2], keepdims=0)  # [b]
    y_len_f = g.node("Clip", [y_len_f, g.f32_scalar(1.0)])
    y_lengths = g.node("Cast", [y_len_f], to=proto.INT64)
    y_lengths = G.imul(
        g.node("Div", [y_lengths, g.i64([n_sqz])]), n_sqz
    )  # floor to n_sqz multiple
    t_y = g.node("ReduceMax", [y_lengths], axes=[0], keepdims=1)  # [1]

    # ---- masks + alignment path (ops/masks.py:25-43) ----
    z_mask = G.sequence_mask(y_lengths, t_y)  # [b, ty, 1]
    attn_mask = G.mul(
        x_mask, g.node("Transpose", [z_mask], perm=[0, 2, 1])
    )  # [b, tx, ty]
    cum = g.node(
        "CumSum", [g.node("Squeeze", [w_ceil], axes=[2]), g.i64_scalar(1)]
    )  # [b, tx] f32
    frames = g.node(
        "Range", [g.i64_scalar(0), G.scalar(t_y), g.i64_scalar(1)]
    )
    frames = g.node("Cast", [frames], to=proto.FLOAT)
    frames = g.node("Unsqueeze", [frames], axes=[0, 1])  # [1, 1, ty]
    path = g.node(
        "Cast",
        [g.node("Less", [frames, g.node("Unsqueeze", [cum], axes=[2])])],
        to=proto.FLOAT,
    )  # [b, tx, ty]
    shifted = G.pad_axis(path, 3, 1, g.i64([1]), g.i64([0]))
    shifted = g.node("Slice", [shifted, g.i64([0]), t_x, g.i64([1])])
    attn = G.mul(G.sub(path, shifted), attn_mask)

    # ---- expand stats to frames + noise (models/glow_tts.py:588-597) ----
    attn_t = g.node("Transpose", [attn], perm=[0, 2, 1])  # [b, ty, tx]
    z_m = g.node("MatMul", [attn_t, x_m])
    z_logs = g.node("MatMul", [attn_t, x_logs])
    eps = g.node("RandomNormalLike", [z_m], dtype=proto.FLOAT)
    z = G.mul(
        G.add(z_m, G.mul(G.mul(g.node("Exp", [z_logs]), eps), noise_scale)),
        z_mask,
    )

    # ---- flow decoder inverse (ops/flows.py:605-684) ----
    dec = params["decoder"]["blocks"]
    n_blocks = np.asarray(dec["actnorm"]["logs"]).shape[0]
    c_sqz = n_mel * n_sqz
    cur = z
    if n_sqz > 1:
        t_sqz = g.node("Div", [t_y, g.i64([n_sqz])])
        cur = G.reshape(cur, [b, t_sqz, g.i64([c_sqz])])
        mask = g.node(
            "Slice",
            [z_mask, g.i64([n_sqz - 1]), g.i64([BIG]), g.i64([1]), g.i64([n_sqz])],
        )
        cur = G.mul(cur, mask)
    else:
        mask = z_mask

    c2 = c_sqz // 2
    ax2 = g.i64([2])
    for bi in reversed(range(n_blocks)):
        bp = _index_tree(dec, bi)
        hint = f"dec{bi}"
        # coupling inverse (ops/flows.py:337-394)
        x0 = g.node("Slice", [cur, g.i64([0]), g.i64([c2]), ax2])
        x1 = g.node("Slice", [cur, g.i64([c2]), g.i64([c_sqz]), ax2])
        hidden = G.mul(
            G.matmul1x1(x0, bp["coupling"]["start"], f"{hint}_start"), mask
        )
        g_all = None
        if g_vec is not None:
            cond_w, cond_b = _conv_wb(bp["coupling"]["wn"]["cond"])
            g_all = g_vec @ cond_w[0] + cond_b  # [2*h*n_layers]
        wn_out = _wn_stack(
            G, hidden, mask, bp["coupling"]["wn"], g_all, h_dec,
            m.dilation_rate, m.n_block_layers, f"{hint}_wn",
        )
        out = G.matmul1x1(wn_out, bp["coupling"]["end"], f"{hint}_end")
        mu = g.node("Slice", [out, g.i64([0]), g.i64([c2]), ax2])
        logs = g.node("Slice", [out, g.i64([c2]), g.i64([c_sqz]), ax2])
        if m.sigmoid_scale:
            logs = g.node(
                "Log",
                [
                    G.add(
                        g.f32_scalar(1e-6),
                        g.node(
                            "Sigmoid", [G.add(logs, g.f32_scalar(2.0))]
                        ),
                    )
                ],
            )
        z1 = G.mul(
            G.mul(G.sub(x1, mu), g.node("Exp", [g.node("Neg", [logs])])), mask
        )
        cur = g.node("Concat", [x0, z1], axis=2)
        # invconv inverse as a dense matmul (ops/flows.py:172-206)
        m_inv = _invconv_dense_inverse(bp["invconv"], c_sqz, m.n_split)
        cur = G.mul(
            g.node("MatMul", [cur, g.init(f"{hint}_minv", m_inv.T.copy())]),
            mask,
        )
        # actnorm inverse (ops/flows.py:100-103)
        an_bias = np.asarray(bp["actnorm"]["bias"], np.float32)
        an_scale = np.exp(-np.asarray(bp["actnorm"]["logs"], np.float64)).astype(
            np.float32
        )
        cur = G.mul(
            G.mul(
                G.sub(cur, g.init(f"{hint}_an_b", an_bias)),
                g.init(f"{hint}_an_s", an_scale),
            ),
            mask,
        )

    if n_sqz > 1:
        cur = G.reshape(cur, [b, t_y, g.i64([n_mel])])
        cur = G.mul(cur, z_mask)

    mel = g.node(
        "Transpose", [cur], perm=[0, 2, 1], outputs=["output"]
    )  # [b, n_mel, t]
    g.node("Identity", [y_lengths], outputs=["output_lengths"])
    g.output("output", proto.FLOAT, ["batch_size", n_mel, "time"])
    g.output("output_lengths", proto.INT64, ["batch_size"])
    del mel
    return g


def export_generator_onnx(
    params: dict,
    config,
    speaker: int = 0,
    producer_version: str = "",
) -> bytes:
    """Serialize the generator as an opset-12 ONNX ModelProto (bytes).

    The emitted model is structurally validated before it is returned
    (onnx/check.py: SSA/topological order, dangling refs, name hygiene,
    declared-dim consistency) so a malformed graph fails loudly at export
    time rather than inside some strict external consumer."""
    g = build_generator_graph(params, config, speaker=speaker)
    blob = g.model_bytes(
        opset_version=12,
        ir_version=7,
        producer_version=producer_version,
        doc_string=(
            "Glow-TTS generator (glow-tts-train-tpu). Signature parity with "
            "the reference torch.onnx export (export_onnx.py:105-118)."
        ),
    )
    from .check import check_model

    summary = check_model(blob)
    import logging

    logging.getLogger("glow_tts_train_tpu_torch.onnx").debug(
        "ONNX structural check passed: %s", summary
    )
    return blob

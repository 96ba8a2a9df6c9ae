"""Pure-numpy ONNX graph executor.

The reference runs its exported ``generator.onnx`` with
``onnxruntime.InferenceSession`` (reference infer_onnx.py:67-75).  No
onnxruntime wheel exists in this image, so the framework ships its own
executor for the opset-12 subset the exporter emits (plus enough
generality to run small externally-produced files).  The infer-onnx CLI
prefers onnxruntime when importable and falls back to this module.

Shapes are fully dynamic — numpy has no static-shape constraint, so the
exported graph's Shape/Range/Pad/Slice arithmetic executes naturally.

Not a performance path: this is the correctness/portability backend.
Serving-grade inference is the JAX/TPU path (infer.py) or onnxruntime
where installed.
"""

from __future__ import annotations

import math
import typing

import numpy as np

from . import proto


class UnsupportedOp(NotImplementedError):
    pass


def _attr(node: proto.Node, name: str, default=None):
    return node.attributes.get(name, default)


# --------------------------------------------------------------------------
# Op implementations.  Each takes (list-of-input-arrays, node) and returns a
# list of output arrays.  Single-output ops may return a bare array.
# --------------------------------------------------------------------------


def _op_conv(inputs, node):
    x, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    if x.ndim != 3:
        raise UnsupportedOp("Conv: only 1-D (N,C,T) supported")
    group = int(_attr(node, "group", 1))
    dilations = _attr(node, "dilations", [1])
    strides = _attr(node, "strides", [1])
    pads = _attr(node, "pads")
    d, s = int(dilations[0]), int(strides[0])
    k = w.shape[2]
    n, c_in, t = x.shape
    if pads is None:
        auto = _attr(node, "auto_pad", "NOTSET")
        if auto in ("NOTSET", "VALID"):
            p0 = p1 = 0
        else:
            # SAME_*: output length is ceil(t/s); total padding makes the
            # strided window sweep cover exactly that many positions.
            out_t = -(-t // s)
            total = max((out_t - 1) * s + (k - 1) * d + 1 - t, 0)
            p0 = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
            p1 = total - p0
    else:
        p0, p1 = int(pads[0]), int(pads[1])
    c_out = w.shape[0]
    xp = np.pad(x, ((0, 0), (0, 0), (p0, p1)))
    t_out = (xp.shape[2] - (k - 1) * d - 1) // s + 1
    out = np.zeros((n, c_out, t_out), dtype=np.result_type(x, w))
    cg_in = w.shape[1]  # per-group input channels
    og = c_out // group
    for gi in range(group):
        xg = xp[:, gi * cg_in : (gi + 1) * cg_in] if group > 1 else xp
        wg = w[gi * og : (gi + 1) * og]
        # sum of k shifted matmuls: [n, t_out, c_in] @ [c_in, og]
        acc = np.zeros((n, t_out, og), dtype=out.dtype)
        for tap in range(k):
            start = tap * d
            sl = xg[:, :, start : start + (t_out - 1) * s + 1 : s]
            acc += np.einsum("nct,oc->nto", sl, wg[:, :, tap])
        out[:, gi * og : (gi + 1) * og] = acc.transpose(0, 2, 1)
    if b is not None:
        out += b.reshape(1, -1, 1)
    return out


def _axes_list(node, inputs, idx=1, default=None):
    """axes as attribute (opset<=12) or optional input (opset>=13)."""
    axes = _attr(node, "axes")
    if axes is None and len(inputs) > idx and inputs[idx] is not None:
        axes = [int(a) for a in np.atleast_1d(inputs[idx])]
    if axes is None:
        axes = default
    return axes


def _reduce(fn):
    def run(inputs, node):
        x = inputs[0]
        axes = _axes_list(node, inputs, default=list(range(x.ndim)))
        keepdims = bool(_attr(node, "keepdims", 1))
        return fn(x, axis=tuple(int(a) for a in axes), keepdims=keepdims)

    return run


def _op_slice(inputs, node):
    x = inputs[0]
    if len(inputs) >= 3:  # opset >= 10: runtime tensors
        starts = np.atleast_1d(inputs[1]).astype(np.int64)
        ends = np.atleast_1d(inputs[2]).astype(np.int64)
        axes = (
            np.atleast_1d(inputs[3]).astype(np.int64)
            if len(inputs) > 3 and inputs[3] is not None
            else np.arange(len(starts))
        )
        steps = (
            np.atleast_1d(inputs[4]).astype(np.int64)
            if len(inputs) > 4 and inputs[4] is not None
            else np.ones(len(starts), np.int64)
        )
    else:  # opset 1: attributes
        starts = np.asarray(_attr(node, "starts"), np.int64)
        ends = np.asarray(_attr(node, "ends"), np.int64)
        axes = np.asarray(
            _attr(node, "axes", list(range(len(starts)))), np.int64
        )
        steps = np.ones(len(starts), np.int64)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[int(ax)] = slice(int(st), int(en), int(sp))
    return x[tuple(sl)]


def _op_pad(inputs, node):
    x = inputs[0]
    pads = _attr(node, "pads")
    if pads is None:
        pads = np.atleast_1d(inputs[1]).astype(np.int64)
    value = 0.0
    if len(inputs) > 2 and inputs[2] is not None:
        value = float(np.asarray(inputs[2]))
    else:
        value = float(_attr(node, "value", 0.0))
    mode = _attr(node, "mode", "constant")
    n = x.ndim
    pairs = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if any(p < 0 for pair in pairs for p in pair):
        # negative pads crop (ONNX semantics)
        sl = []
        pos_pairs = []
        for (lo, hi), dim in zip(pairs, x.shape):
            start = -lo if lo < 0 else 0
            end = dim + hi if hi < 0 else dim
            sl.append(slice(start, end))
            pos_pairs.append((max(lo, 0), max(hi, 0)))
        x = x[tuple(sl)]
        pairs = pos_pairs
    if mode == "constant":
        return np.pad(x, pairs, constant_values=value)
    return np.pad(x, pairs, mode={"reflect": "reflect", "edge": "edge"}[mode])


def _op_reshape(inputs, node):
    x, shape = inputs[0], np.atleast_1d(inputs[1]).astype(np.int64).tolist()
    out = []
    for i, d in enumerate(shape):
        if d == 0 and not _attr(node, "allowzero", 0):
            out.append(x.shape[i])
        else:
            out.append(int(d))
    return x.reshape(out)


def _op_split(inputs, node):
    x = inputs[0]
    axis = int(_attr(node, "axis", 0))
    split = _attr(node, "split")
    if split is None and len(inputs) > 1 and inputs[1] is not None:
        split = np.atleast_1d(inputs[1]).astype(np.int64).tolist()
    if split is None:
        n_out = len(node.outputs)
        split = [x.shape[axis] // n_out] * n_out
    idx = np.cumsum(split)[:-1]
    return list(np.split(x, idx, axis=axis))


def _op_gather(inputs, node):
    x, idx = inputs
    axis = int(_attr(node, "axis", 0))
    return np.take(x, idx.astype(np.int64), axis=axis)


def _op_cast(inputs, node):
    to = int(_attr(node, "to"))
    return inputs[0].astype(proto.ONNX_TO_NP[to])


def _op_softmax(inputs, node, opset: int = 12):
    x = inputs[0]
    # Defaults differ by opset: <13 is axis=1 with flatten-at-axis
    # semantics; >=13 is axis=-1 with ordinary per-axis softmax.
    axis = int(_attr(node, "axis", -1 if opset >= 13 else 1))
    if axis < 0:
        axis += x.ndim
    if opset >= 13:
        m = x.max(axis=axis, keepdims=True)
        e = np.exp(x - m)
        return (e / e.sum(axis=axis, keepdims=True)).astype(x.dtype)
    # opset <13: flatten to 2-D at `axis` and softmax the suffix.  For
    # axis == last dim (all the exporter emits) this equals per-row softmax.
    shape = x.shape
    x2 = x.reshape(int(np.prod(shape[:axis], dtype=np.int64)), -1)
    m = x2.max(axis=1, keepdims=True)
    e = np.exp(x2 - m)
    return (e / e.sum(axis=1, keepdims=True)).reshape(shape).astype(x.dtype)


def _op_random_normal_like(inputs, node, rng: np.random.Generator):
    x = inputs[0]
    dtype = proto.ONNX_TO_NP.get(int(_attr(node, "dtype", 0)), x.dtype)
    mean = float(_attr(node, "mean", 0.0))
    scale = float(_attr(node, "scale", 1.0))
    return (rng.standard_normal(x.shape) * scale + mean).astype(dtype)


def _op_constant_of_shape(inputs, node):
    shape = np.atleast_1d(inputs[0]).astype(np.int64)
    value = _attr(node, "value")
    if value is None:
        return np.zeros(shape, np.float32)
    arr = value.array if isinstance(value, proto.Tensor) else np.asarray(value)
    return np.full(shape, arr.reshape(-1)[0], dtype=arr.dtype)


def _op_expand(inputs, node):
    x, shape = inputs[0], np.atleast_1d(inputs[1]).astype(np.int64)
    # ONNX Expand: broadcast to mutually-broadcast shape
    target = np.broadcast_shapes(x.shape, tuple(int(s) for s in shape))
    return np.broadcast_to(x, target)


def _op_clip(inputs, node):
    x = inputs[0]
    lo = hi = None
    if len(inputs) > 1 and inputs[1] is not None:
        lo = inputs[1]
    else:
        lo = _attr(node, "min")
    if len(inputs) > 2 and inputs[2] is not None:
        hi = inputs[2]
    else:
        hi = _attr(node, "max")
    return np.clip(x, lo, hi)


def _op_cumsum(inputs, node):
    x, axis = inputs[0], int(np.asarray(inputs[1]))
    if _attr(node, "exclusive", 0) or _attr(node, "reverse", 0):
        raise UnsupportedOp("CumSum exclusive/reverse")
    return np.cumsum(x, axis=axis).astype(x.dtype)


def _op_gemm(inputs, node):
    a, b = inputs[0], inputs[1]
    if _attr(node, "transA", 0):
        a = a.T
    if _attr(node, "transB", 0):
        b = b.T
    y = float(_attr(node, "alpha", 1.0)) * (a @ b)
    if len(inputs) > 2 and inputs[2] is not None:
        y = y + float(_attr(node, "beta", 1.0)) * inputs[2]
    return y


def _op_range(inputs, node):
    start, limit, delta = (np.asarray(v).item() for v in inputs)
    return np.arange(start, limit, delta, dtype=inputs[0].dtype)


def _op_transpose(inputs, node):
    perm = _attr(node, "perm")
    return np.transpose(inputs[0], perm)


def _op_squeeze(inputs, node):
    axes = _axes_list(node, inputs)
    if axes is None:
        return np.squeeze(inputs[0])
    return np.squeeze(inputs[0], axis=tuple(int(a) for a in axes))


def _op_unsqueeze(inputs, node):
    axes = _axes_list(node, inputs)
    x = inputs[0]
    # Negative axes resolve against the OUTPUT rank (ONNX spec), so fix
    # the rank first, then insert in ascending resolved order.
    out_rank = x.ndim + len(axes)
    for a in sorted(int(v) + (out_rank if int(v) < 0 else 0) for v in axes):
        x = np.expand_dims(x, a)
    return x


def _op_constant(inputs, node):
    v = _attr(node, "value")
    if isinstance(v, proto.Tensor):
        return v.array
    for key in ("value_float", "value_int"):
        if _attr(node, key) is not None:
            return np.asarray(_attr(node, key))
    for key in ("value_floats", "value_ints"):
        if _attr(node, key) is not None:
            return np.asarray(_attr(node, key))
    raise UnsupportedOp("Constant without value")


def _binary(fn, type_promote=True):
    def run(inputs, node):
        a, b = inputs
        return fn(a, b)

    return run


def _int_div_trunc(a, b):
    """ONNX integer Div truncates toward zero; numpy // floors.  When the
    signs differ and the division is inexact, floor is one below trunc."""
    q = a // b
    r = a - q * b
    return (q + ((r != 0) & ((a < 0) != (b < 0)))).astype(np.result_type(a, b))


_SIMPLE_OPS: typing.Dict[str, typing.Callable] = {
    "Add": _binary(np.add),
    "Sub": _binary(np.subtract),
    "Mul": _binary(np.multiply),
    "Div": lambda i, n: (
        _int_div_trunc(i[0], i[1])
        if np.issubdtype(i[0].dtype, np.integer)
        and np.issubdtype(i[1].dtype, np.integer)
        else i[0] / i[1]
    ),
    "MatMul": _binary(np.matmul),
    "Pow": _binary(np.power),
    "Min": lambda i, n: np.minimum.reduce(i),
    "Max": lambda i, n: np.maximum.reduce(i),
    "And": _binary(np.logical_and),
    "Or": _binary(np.logical_or),
    "Equal": _binary(np.equal),
    "Less": _binary(np.less),
    "LessOrEqual": _binary(np.less_equal),
    "Greater": _binary(np.greater),
    "GreaterOrEqual": _binary(np.greater_equal),
    "Mod": _binary(np.mod),
    "Neg": lambda i, n: -i[0],
    "Abs": lambda i, n: np.abs(i[0]),
    "Exp": lambda i, n: np.exp(i[0]),
    "Log": lambda i, n: np.log(i[0]),
    "Sqrt": lambda i, n: np.sqrt(i[0]),
    "Ceil": lambda i, n: np.ceil(i[0]),
    "Floor": lambda i, n: np.floor(i[0]),
    "Relu": lambda i, n: np.maximum(i[0], 0),
    "Sigmoid": lambda i, n: 1.0 / (1.0 + np.exp(-i[0])),
    "Tanh": lambda i, n: np.tanh(i[0]),
    "Erf": lambda i, n: np.vectorize(math.erf, otypes=[i[0].dtype])(i[0]),
    "Not": lambda i, n: np.logical_not(i[0]),
    "Identity": lambda i, n: i[0],
    "Where": lambda i, n: np.where(i[0], i[1], i[2]),
    "Shape": lambda i, n: np.asarray(i[0].shape, np.int64),
    "Size": lambda i, n: np.asarray(i[0].size, np.int64),
    "Concat": lambda i, n: np.concatenate(i, axis=int(_attr(n, "axis", 0))),
    "Reciprocal": lambda i, n: 1.0 / i[0],
    "LeakyRelu": lambda i, n: np.where(
        i[0] >= 0, i[0], i[0] * _attr(n, "alpha", 0.01)
    ).astype(i[0].dtype),
}

_COMPLEX_OPS: typing.Dict[str, typing.Callable] = {
    "Conv": _op_conv,
    "Reshape": _op_reshape,
    "Transpose": _op_transpose,
    "Slice": _op_slice,
    "Pad": _op_pad,
    "Split": _op_split,
    "Gather": _op_gather,
    "Cast": _op_cast,
    "Softmax": _op_softmax,
    "ConstantOfShape": _op_constant_of_shape,
    "Expand": _op_expand,
    "Clip": _op_clip,
    "CumSum": _op_cumsum,
    "Gemm": _op_gemm,
    "Range": _op_range,
    "Squeeze": _op_squeeze,
    "Unsqueeze": _op_unsqueeze,
    "Constant": _op_constant,
    "ReduceSum": _reduce(np.sum),
    "ReduceMean": _reduce(np.mean),
    "ReduceMax": _reduce(np.max),
    "ReduceMin": _reduce(np.min),
    "ReduceProd": _reduce(np.prod),
}


class OnnxRuntime:
    """Execute an ONNX model graph with numpy.

    Usage mirrors onnxruntime.InferenceSession:
        sess = OnnxRuntime.from_file(path)       # or OnnxRuntime(model_bytes)
        outs = sess.run(None, {"input": ..., "input_lengths": ..., ...})
    """

    def __init__(self, model_bytes: bytes, seed: typing.Optional[int] = None):
        self.model = proto.decode_model(model_bytes)
        self.graph = self.model.graph
        self._initializers = {t.name: t.array for t in self.graph.initializers}
        self._seed = seed
        init_names = set(self._initializers)
        self.input_names = [
            vi.name for vi in self.graph.inputs if vi.name not in init_names
        ]
        self.output_names = [vi.name for vi in self.graph.outputs]

    @classmethod
    def from_file(cls, path, seed: typing.Optional[int] = None):
        with open(path, "rb") as f:
            return cls(f.read(), seed=seed)

    # onnxruntime-compatible introspection
    def get_inputs(self):
        init_names = set(self._initializers)
        return [vi for vi in self.graph.inputs if vi.name not in init_names]

    def get_outputs(self):
        return list(self.graph.outputs)

    def run(
        self,
        output_names: typing.Optional[typing.Sequence[str]],
        feeds: typing.Dict[str, np.ndarray],
    ) -> typing.List[np.ndarray]:
        values: typing.Dict[str, np.ndarray] = dict(self._initializers)
        for name, arr in feeds.items():
            values[name] = np.asarray(arr)
        missing = [n for n in self.input_names if n not in values]
        if missing:
            raise ValueError(f"missing graph inputs: {missing}")
        rng = np.random.default_rng(self._seed)

        for node in self.graph.nodes:
            inputs = [values[n] if n else None for n in node.inputs]
            try:
                if node.op_type == "RandomNormalLike":
                    out = _op_random_normal_like(inputs, node, rng)
                elif node.op_type == "Softmax":
                    out = _op_softmax(inputs, node, self.model.opset_version)
                elif node.op_type in _SIMPLE_OPS:
                    out = _SIMPLE_OPS[node.op_type](inputs, node)
                elif node.op_type in _COMPLEX_OPS:
                    out = _COMPLEX_OPS[node.op_type](inputs, node)
                else:
                    raise UnsupportedOp(node.op_type)
            except UnsupportedOp:
                raise
            except Exception as exc:  # pragma: no cover - debug aid
                raise RuntimeError(
                    f"ONNX node {node.op_type} '{node.name}' failed: {exc!r}"
                ) from exc
            if not isinstance(out, (list, tuple)):
                out = [out]
            for name, arr in zip(node.outputs, out):
                if name:
                    values[name] = np.asarray(arr)

        names = output_names or self.output_names
        missing = [n for n in names if n not in values]
        if missing:
            raise ValueError(f"graph produced no value for outputs: {missing}")
        return [values[n] for n in names]

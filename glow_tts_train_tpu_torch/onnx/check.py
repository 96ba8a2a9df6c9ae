"""Static structural validation of emitted ONNX graphs.

The exporter (onnx/export.py) writes whatever graph the builder
constructed; a dangling input, duplicate value name, out-of-order node, or
a declared output dim that contradicts the graph's real shapes would only
surface when a *strict* consumer — real onnxruntime, which this image
lacks — loads the file.  The in-house numpy executor (onnx/runtime.py) is
deliberately tolerant, so it cannot play that role.  This module is the
strict first-party consumer: pure structural checks plus a conservative
static shape propagation, run automatically inside ``--format onnx``
export (export.py) so malformed output fails loudly at write time.

Checks (all hard errors, raised as :class:`OnnxGraphError`):

* SSA / topological order: every node input must be defined by a graph
  input, an initializer, or an *earlier* node output; every value is
  defined exactly once (ONNX IR spec: graphs are SSA and nodes are stored
  in topological order).
* Name hygiene: non-empty unique node names; unique graph input /
  initializer / output names; every graph output produced.
* Well-formed nodes: an op_type and at least one non-empty output each.
* Declared-dim consistency: static shape propagation over the opset the
  exporter emits (unknown dims propagate as ``None`` and never fail);
  any *fixed* dim declared on a graph output that contradicts a
  *propagated-known* dim — or a rank mismatch — is an error.  Elementwise
  broadcasts with incompatible known dims are errors anywhere in the
  graph.

The propagation is deliberately conservative: an op it does not model
yields fully-unknown output shapes, so it can reject only genuinely
inconsistent graphs, never merely novel ones.
"""

from __future__ import annotations

import typing

import numpy as np

from . import proto


class OnnxGraphError(ValueError):
    """A structural defect in an ONNX graph (raised at export time)."""


# A shape is a tuple of dims (int = known, None = unknown) or None for
# fully-unknown rank.
Shape = typing.Optional[typing.Tuple[typing.Optional[int], ...]]


def _declared_shape(vi: proto.ValueInfo) -> Shape:
    if not vi.shape:
        return None  # scalar and unknown-rank are indistinguishable; skip
    return tuple(d if isinstance(d, int) else None for d in vi.shape)


def _broadcast(a: Shape, b: Shape, where: str) -> Shape:
    """Numpy-style broadcast of two (possibly unknown) shapes."""
    if a is None or b is None:
        return None
    rank = max(len(a), len(b))
    a = (None,) * (rank - len(a)) + tuple(a)
    b = (None,) * (rank - len(b)) + tuple(b)
    out = []
    for da, db in zip(a, b):
        if da is None and db is None:
            out.append(None)
        elif da is None:
            # the unknown side may be 1 (broadcast) or equal — known only
            # when the known side exceeds 1 (result is then that dim)
            out.append(db if db != 1 else None)
        elif db is None:
            out.append(da if da != 1 else None)
        elif da == db or db == 1:
            out.append(da)
        elif da == 1:
            out.append(db)
        else:
            raise OnnxGraphError(
                f"{where}: incompatible broadcast dims {da} vs {db}"
            )
    return tuple(out)


def _axis(ax: int, rank: int) -> int:
    return ax + rank if ax < 0 else ax


def _same(shapes, node):
    return [shapes[0]]


def _bcast_all(shapes, node):
    out = shapes[0]
    for s in shapes[1:]:
        out = _broadcast(out, s, f"node '{node.name}' ({node.op_type})")
    return [out]


def _shape_conv(shapes, node):
    x, w = shapes[0], shapes[1]
    if x is None or w is None or len(x) != 3:
        return [None]
    c_out = w[0] if len(w) == 3 else None
    # time dim: known only for the stride-1 SAME/equal-pad cases we don't
    # model — leave unknown (never wrong, merely imprecise)
    return [(x[0], c_out, None)]


def _shape_matmul(shapes, node):
    a, b = shapes[0], shapes[1]
    if a is None or b is None or len(a) < 2 or len(b) < 2:
        return [None]
    batch = _broadcast(a[:-2], b[:-2], f"node '{node.name}' (MatMul batch)")
    if (
        a[-1] is not None
        and b[-2] is not None
        and a[-1] != b[-2]
    ):
        raise OnnxGraphError(
            f"node '{node.name}' (MatMul): contraction dims "
            f"{a[-1]} vs {b[-2]}"
        )
    if batch is None:
        return [None]
    return [tuple(batch) + (a[-2], b[-1])]


def _shape_transpose(shapes, node):
    x = shapes[0]
    if x is None:
        return [None]
    perm = node.attributes.get("perm") or list(range(len(x) - 1, -1, -1))
    if len(perm) != len(x):
        raise OnnxGraphError(
            f"node '{node.name}' (Transpose): perm rank {len(perm)} "
            f"vs input rank {len(x)}"
        )
    return [tuple(x[int(p)] for p in perm)]


def _shape_concat(shapes, node):
    known = [s for s in shapes if s is not None]
    if not known:
        return [None]
    rank = len(known[0])
    ax = _axis(int(node.attributes.get("axis", 0)), rank)
    out: typing.List[typing.Optional[int]] = list(known[0])
    total: typing.Optional[int] = 0
    for s in shapes:
        if s is None:
            total = None
            continue
        if len(s) != rank:
            raise OnnxGraphError(
                f"node '{node.name}' (Concat): mixed input ranks"
            )
        for i in range(rank):
            if i == ax:
                continue
            if out[i] is None:
                out[i] = s[i]
            elif s[i] is not None and s[i] != out[i]:
                raise OnnxGraphError(
                    f"node '{node.name}' (Concat): non-axis dim mismatch "
                    f"{out[i]} vs {s[i]} at axis {i}"
                )
        total = None if (total is None or s[ax] is None) else total + s[ax]
    out[ax] = total
    return [tuple(out)]


class _Prop:
    """Shape/constant propagation state over one graph walk."""

    def __init__(self) -> None:
        self.shapes: typing.Dict[str, Shape] = {}
        self.consts: typing.Dict[str, np.ndarray] = {}
        # "dim vectors": values that are (partially) known 1-D integer
        # vectors of dimensions — Shape outputs and their Gather/Unsqueeze/
        # Concat derivatives.  Entries are per-element ints or None, which
        # keeps the STATIC dims of a shape tensor live even when one
        # element (typically the batch) is symbolic.
        self.dimvecs: typing.Dict[
            str, typing.Tuple[typing.Optional[int], ...]
        ] = {}

    def const(self, name: str) -> typing.Optional[np.ndarray]:
        return self.consts.get(name)

    def _as_dimvec(
        self, name: str
    ) -> typing.Optional[typing.Tuple[typing.Optional[int], ...]]:
        if name in self.dimvecs:
            return self.dimvecs[name]
        c = self.consts.get(name)
        if (
            c is not None
            and c.ndim <= 1
            and np.issubdtype(c.dtype, np.integer)
        ):
            return tuple(int(v) for v in np.atleast_1d(c))
        return None

    # -- per-op rules (each: (input shapes, node) -> [output shapes]) -----

    def run(self, node: proto.Node) -> typing.List[Shape]:
        shapes = [
            self.shapes.get(n) if n else None for n in node.inputs
        ]
        rule = getattr(self, f"_op_{node.op_type.lower()}", None)
        table = _RULES.get(node.op_type)
        if rule is not None:
            out = rule(shapes, node)
        elif table is not None:
            out = table(shapes, node)
        else:
            out = [None] * len(node.outputs)
        if len(out) < len(node.outputs):
            out = out + [None] * (len(node.outputs) - len(out))
        return out

    def _op_concat(self, shapes, node):
        out = _shape_concat(shapes, node)
        # rank-1 integer concat: merge dimvecs elementwise so shape
        # tensors assembled from Gather/Unsqueeze pieces stay live
        if int(node.attributes.get("axis", 0)) == 0:
            parts = [self._as_dimvec(n) for n in node.inputs]
            if all(p is not None for p in parts):
                self.dimvecs[node.outputs[0]] = tuple(
                    d for p in parts for d in p
                )
        return out

    def _op_shape(self, shapes, node):
        x = shapes[0]
        if x is not None:
            if all(d is not None for d in x):
                self.consts[node.outputs[0]] = np.asarray(x, np.int64)
            self.dimvecs[node.outputs[0]] = tuple(x)
            return [(len(x),)]
        return [(None,)]

    def _op_size(self, shapes, node):
        return [()]

    def _op_constant(self, shapes, node):
        v = node.attributes.get("value")
        if isinstance(v, proto.Tensor):
            self.consts[node.outputs[0]] = v.array
            return [tuple(int(d) for d in v.array.shape)]
        return [None]

    def _op_reshape(self, shapes, node):
        target = self._as_dimvec(node.inputs[1])
        x = shapes[0]
        if target is None:
            ts = self.shapes.get(node.inputs[1])
            if ts is not None and len(ts) == 1 and ts[0] is not None:
                return [(None,) * ts[0]]  # rank known, dims unknown
            return [None]
        dims = [None if d is None else int(d) for d in target]
        out: typing.List[typing.Optional[int]] = []
        for i, d in enumerate(dims):
            if d == 0:
                out.append(x[i] if x is not None and i < len(x) else None)
            elif d == -1:
                out.append(None)
            else:
                out.append(d)
        # resolve -1 when everything else and the input size are known
        if (
            x is not None
            and all(v is not None for v in x)
            and out.count(None) == 1
            and -1 in dims
        ):
            known = 1
            for v in out:
                if v is not None:
                    known *= v
            total = int(np.prod([int(v) for v in x], dtype=np.int64))
            if known and total % known == 0:
                out[out.index(None)] = total // known
        return [tuple(out)]

    def _op_unsqueeze(self, shapes, node):
        x = shapes[0]
        axes = node.attributes.get("axes")
        if axes is None and len(node.inputs) > 1:
            c = self.const(node.inputs[1])
            axes = None if c is None else [int(a) for a in np.atleast_1d(c)]
        if x is None or axes is None:
            return [None]
        rank = len(x) + len(axes)
        out: typing.List[typing.Optional[int]] = list(x)
        for a in sorted(_axis(int(v), rank) for v in axes):
            out.insert(a, 1)
        c = self.const(node.inputs[0])
        if c is not None:
            self.consts[node.outputs[0]] = c.reshape(
                [d if d is not None else -1 for d in out]
            )
        dv = self._as_dimvec(node.inputs[0])
        if dv is not None and len(out) == 1:
            # unsqueezing a shape element keeps the flat element list
            self.dimvecs[node.outputs[0]] = dv
        return [tuple(out)]

    def _op_squeeze(self, shapes, node):
        x = shapes[0]
        axes = node.attributes.get("axes")
        if axes is None and len(node.inputs) > 1:
            c = self.const(node.inputs[1])
            axes = None if c is None else [int(a) for a in np.atleast_1d(c)]
        if x is None:
            return [None]
        if axes is None:
            if any(d is None for d in x):
                return [None]
            return [tuple(d for d in x if d != 1)]
        drop = {_axis(int(a), len(x)) for a in axes}
        for a in drop:
            if x[a] is not None and x[a] != 1:
                raise OnnxGraphError(
                    f"node '{node.name}' (Squeeze): axis {a} has dim {x[a]}"
                )
        return [tuple(d for i, d in enumerate(x) if i not in drop)]

    def _op_gather(self, shapes, node):
        x, idx = shapes[0], shapes[1]
        if x is None or idx is None:
            return [None]
        ax = _axis(int(node.attributes.get("axis", 0)), len(x))
        out = tuple(x[:ax]) + tuple(idx) + tuple(x[ax + 1 :])
        cx, ci = self.const(node.inputs[0]), self.const(node.inputs[1])
        if cx is not None and ci is not None:
            self.consts[node.outputs[0]] = np.take(
                cx, ci.astype(np.int64), axis=ax
            )
        # dimvec: gathering elements of a (partially known) shape vector
        dv = self._as_dimvec(node.inputs[0])
        if dv is not None and ci is not None and ax == 0:
            picked = tuple(
                dv[int(j)] for j in np.atleast_1d(ci) if -len(dv) <= int(j) < len(dv)
            )
            if len(picked) == np.atleast_1d(ci).size:
                self.dimvecs[node.outputs[0]] = picked
        return [out]

    def _op_slice(self, shapes, node):
        x = shapes[0]
        if x is None:
            return [None]
        axes_c = (
            self.const(node.inputs[3])
            if len(node.inputs) > 3 and node.inputs[3]
            else None
        )
        if axes_c is None and len(node.inputs) >= 3:
            starts = self.const(node.inputs[1])
            if starts is None:
                return [None]
            axes_c = np.arange(len(np.atleast_1d(starts)))
        if axes_c is None:
            axes_c = np.asarray(
                node.attributes.get("axes", list(range(len(x))))
            )
        sliced = {_axis(int(a), len(x)) for a in np.atleast_1d(axes_c)}
        return [
            tuple(None if i in sliced else d for i, d in enumerate(x))
        ]

    def _op_pad(self, shapes, node):
        x = shapes[0]
        if x is None:
            return [None]
        pads = node.attributes.get("pads")
        if pads is None and len(node.inputs) > 1:
            c = self.const(node.inputs[1])
            pads = None if c is None else [int(p) for p in np.atleast_1d(c)]
        if pads is None or len(pads) != 2 * len(x):
            return [(None,) * len(x)]
        return [
            tuple(
                None if d is None else d + int(pads[i]) + int(pads[i + len(x)])
                for i, d in enumerate(x)
            )
        ]

    def _op_split(self, shapes, node):
        x = shapes[0]
        if x is None:
            return [None] * len(node.outputs)
        ax = _axis(int(node.attributes.get("axis", 0)), len(x))
        split = node.attributes.get("split")
        n_out = len(node.outputs)
        if split is None:
            if x[ax] is None or x[ax] % n_out:
                parts = [None] * n_out
            else:
                parts = [x[ax] // n_out] * n_out
        else:
            parts = [int(s) for s in split]
            if x[ax] is not None and sum(parts) != x[ax]:
                raise OnnxGraphError(
                    f"node '{node.name}' (Split): splits {parts} "
                    f"do not sum to dim {x[ax]}"
                )
        return [
            tuple(p if i == ax else d for i, d in enumerate(x))
            for p in parts
        ]

    def _op_constantofshape(self, shapes, node):
        c = self.const(node.inputs[0])
        if c is not None:
            return [tuple(int(d) for d in np.atleast_1d(c))]
        s = shapes[0]
        if s is not None and len(s) == 1 and s[0] is not None:
            return [(None,) * s[0]]
        return [None]

    def _op_expand(self, shapes, node):
        c = self.const(node.inputs[1])
        if c is None:
            return [None]
        target = tuple(int(d) if int(d) != 1 else None for d in np.atleast_1d(c))
        return [
            _broadcast(
                shapes[0], target, f"node '{node.name}' (Expand)"
            )
        ]

    def _op_reducesum(self, shapes, node):
        return self._reduce(shapes, node)

    _op_reducemean = _op_reducesum
    _op_reducemax = _op_reducesum
    _op_reducemin = _op_reducesum
    _op_reduceprod = _op_reducesum

    def _reduce(self, shapes, node):
        x = shapes[0]
        if x is None:
            return [None]
        axes = node.attributes.get("axes")
        if axes is None and len(node.inputs) > 1:
            c = self.const(node.inputs[1])
            axes = None if c is None else [int(a) for a in np.atleast_1d(c)]
        keep = bool(node.attributes.get("keepdims", 1))
        if axes is None:
            axes = list(range(len(x)))
        red = {_axis(int(a), len(x)) for a in axes}
        if keep:
            return [tuple(1 if i in red else d for i, d in enumerate(x))]
        return [tuple(d for i, d in enumerate(x) if i not in red)]

    def _op_range(self, shapes, node):
        return [(None,)]

    def _op_gemm(self, shapes, node):
        a, b = shapes[0], shapes[1]
        if a is None or b is None or len(a) != 2 or len(b) != 2:
            return [None]
        if node.attributes.get("transA", 0):
            a = a[::-1]
        if node.attributes.get("transB", 0):
            b = b[::-1]
        if a[1] is not None and b[0] is not None and a[1] != b[0]:
            raise OnnxGraphError(
                f"node '{node.name}' (Gemm): contraction dims {a[1]} vs {b[0]}"
            )
        return [(a[0], b[1])]


# Ops whose output shape equals input 0's shape.
_SAME_SHAPE_OPS = (
    "Abs Cast Ceil Clip CumSum Erf Exp Floor Identity LeakyRelu Log Neg "
    "Not RandomNormalLike Reciprocal Relu Sigmoid Softmax Sqrt Tanh"
).split()
# Elementwise multi-input broadcasting ops.
_BCAST_OPS = (
    "Add And Div Equal Greater GreaterOrEqual Less LessOrEqual Max Min "
    "Mod Mul Or Pow Sub Where"
).split()

_RULES: typing.Dict[str, typing.Callable] = {
    **{op: _same for op in _SAME_SHAPE_OPS},
    **{op: _bcast_all for op in _BCAST_OPS},
    "Conv": _shape_conv,
    "MatMul": _shape_matmul,
    "Transpose": _shape_transpose,
    "Concat": _shape_concat,
}


def check_model(model: typing.Union[bytes, proto.Model]) -> typing.Dict:
    """Validate an ONNX model structurally; raise OnnxGraphError on defects.

    Returns a small summary dict (node/initializer/check counts) for
    logging.  See module docstring for the checked properties.
    """
    if isinstance(model, (bytes, bytearray, memoryview)):
        model = proto.decode_model(bytes(model))
    graph = model.graph

    prop = _Prop()
    defined: typing.Dict[str, str] = {}  # value name -> definer description

    def define(name: str, by: str) -> None:
        if name in defined:
            raise OnnxGraphError(
                f"value '{name}' defined twice: by {defined[name]} and {by}"
            )
        defined[name] = by

    init_names = set()
    for t in graph.initializers:
        if not t.name:
            raise OnnxGraphError("initializer with empty name")
        if t.name in init_names:
            raise OnnxGraphError(f"duplicate initializer '{t.name}'")
        init_names.add(t.name)
        define(t.name, "initializer")
        prop.shapes[t.name] = tuple(int(d) for d in t.array.shape)
        if t.array.size <= 4096:  # shapes/axes/scalars feed propagation
            prop.consts[t.name] = t.array

    for vi in graph.inputs:
        if not vi.name:
            raise OnnxGraphError("graph input with empty name")
        if vi.name in init_names:
            continue  # legacy initializer-with-matching-input pattern
        define(vi.name, "graph input")
        prop.shapes[vi.name] = _declared_shape(vi)

    node_names = set()
    for i, node in enumerate(graph.nodes):
        where = f"node #{i} '{node.name}' ({node.op_type})"
        if not node.op_type:
            raise OnnxGraphError(f"node #{i} '{node.name}' has no op_type")
        if node.name:
            if node.name in node_names:
                raise OnnxGraphError(f"duplicate node name '{node.name}'")
            node_names.add(node.name)
        if not any(node.outputs):
            raise OnnxGraphError(f"{where} has no outputs")
        for inp in node.inputs:
            if inp and inp not in defined:
                raise OnnxGraphError(
                    f"{where} reads undefined value '{inp}' "
                    "(dangling reference or non-topological order)"
                )
        out_shapes = prop.run(node)
        for name, shape in zip(node.outputs, out_shapes):
            if not name:
                continue
            define(name, where)
            prop.shapes[name] = shape

    out_names = set()
    for vi in graph.outputs:
        if vi.name in out_names:
            raise OnnxGraphError(f"duplicate graph output '{vi.name}'")
        out_names.add(vi.name)
        if vi.name not in defined:
            raise OnnxGraphError(
                f"graph output '{vi.name}' is never produced"
            )
        declared = _declared_shape(vi)
        inferred = prop.shapes.get(vi.name)
        if declared is None or inferred is None:
            continue
        if len(declared) != len(inferred):
            raise OnnxGraphError(
                f"graph output '{vi.name}': declared rank {len(declared)} "
                f"but graph produces rank {len(inferred)}"
            )
        for i, (d, inf) in enumerate(zip(declared, inferred)):
            if d is not None and inf is not None and d != inf:
                raise OnnxGraphError(
                    f"graph output '{vi.name}' dim {i}: declared {d} "
                    f"but graph produces {inf}"
                )

    return {
        "nodes": len(graph.nodes),
        "initializers": len(graph.initializers),
        "values": len(defined),
        "outputs": len(graph.outputs),
    }

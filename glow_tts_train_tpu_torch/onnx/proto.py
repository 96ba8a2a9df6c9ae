"""ONNX protobuf wire format, hand-rolled — zero dependencies.

The reference emits ``generator.onnx`` with ``torch.onnx.export``
(reference export_onnx.py:105-118) and runs it with onnxruntime
(reference infer_onnx.py:67-75).  Neither torch.onnx nor the onnx wheel
exists in this image, but an .onnx file is nothing more than a serialized
``onnx.ModelProto`` — a stable, public protobuf schema.  This module
implements exactly the subset of protobuf wire encoding/decoding that
ModelProto needs, so the framework can emit TRUE .onnx artifacts (and read
them back) with no third-party packages at all.

Field numbers below are the published onnx.proto schema (onnx/onnx.proto,
IR version 7 / opset 12 era; field numbers are frozen by protobuf
compatibility rules so they are identical in every later release).
``tests/test_onnx_proto.py`` cross-validates the encoding against a
protoc-compiled copy of the same schema where protoc + google.protobuf
are available (they are, in this image).

Wire format recap (https://protobuf.dev/programming-guides/encoding/):
  tag      = (field_number << 3) | wire_type
  wire 0   = varint (int32/int64/enum/bool)
  wire 1   = fixed 64-bit (double)
  wire 2   = length-delimited (string/bytes/submessage/packed repeated)
  wire 5   = fixed 32-bit (float)
Negative int64s encode as 10-byte two's-complement varints.
"""

from __future__ import annotations

import struct
import typing

import numpy as np

# --------------------------------------------------------------------------
# TensorProto.DataType (onnx.proto enum, frozen values)
# --------------------------------------------------------------------------

FLOAT = 1
UINT8 = 2
INT8 = 3
UINT16 = 4
INT16 = 5
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
UINT32 = 12
UINT64 = 13

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.uint16): UINT16,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
}
ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# AttributeProto.AttributeType (frozen enum values)
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_GRAPH = 5
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


# --------------------------------------------------------------------------
# Encoder primitives
# --------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    """Unsigned LEB128; negative ints take the 64-bit two's complement."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def bytes_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def string_field(field: int, value: str) -> bytes:
    return bytes_field(field, value.encode("utf-8"))


def float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def packed_varints(field: int, values: typing.Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return bytes_field(field, payload)


def packed_floats(field: int, values: typing.Sequence[float]) -> bytes:
    return bytes_field(field, struct.pack(f"<{len(values)}f", *values))


# --------------------------------------------------------------------------
# Message encoders (field numbers = published onnx.proto)
# --------------------------------------------------------------------------


def encode_tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    shape = list(array.shape)  # before ascontiguousarray: it promotes 0-d to 1-d
    array = np.ascontiguousarray(array)
    if array.dtype not in _NP_TO_ONNX:
        raise TypeError(f"unsupported initializer dtype {array.dtype}")
    parts = [
        packed_varints(1, shape),
        varint_field(2, _NP_TO_ONNX[array.dtype]),
        string_field(8, name),
        # little-endian fixed-width raw bytes (the onnx convention)
        bytes_field(9, array.astype(array.dtype.newbyteorder("<")).tobytes()),
    ]
    return b"".join(parts)


def encode_attribute(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20.

    Python type drives the attribute type: bool/int -> INT, float -> FLOAT,
    str/bytes -> STRING, np.ndarray -> TENSOR, [int] -> INTS, [float] ->
    FLOATS.  Empty lists default to INTS (the only empty-list attribute the
    exporter emits is ``axes``-style ints).
    """
    parts = [string_field(1, name)]
    if isinstance(value, bool):
        parts += [varint_field(3, int(value)), varint_field(20, ATTR_INT)]
    elif isinstance(value, (int, np.integer)):
        parts += [varint_field(3, int(value)), varint_field(20, ATTR_INT)]
    elif isinstance(value, (float, np.floating)):
        parts += [float_field(2, float(value)), varint_field(20, ATTR_FLOAT)]
    elif isinstance(value, str):
        parts += [bytes_field(4, value.encode("utf-8")), varint_field(20, ATTR_STRING)]
    elif isinstance(value, bytes):
        parts += [bytes_field(4, value), varint_field(20, ATTR_STRING)]
    elif isinstance(value, np.ndarray):
        parts += [
            bytes_field(5, encode_tensor("", value)),
            varint_field(20, ATTR_TENSOR),
        ]
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            # repeated int64 'ints' (field 8): NOT packed in proto2-style
            # onnx.proto — one tag per element
            for v in value:
                parts.append(varint_field(8, int(v)))
            parts.append(varint_field(20, ATTR_INTS))
        elif all(isinstance(v, (int, float, np.floating, np.integer)) for v in value):
            for v in value:
                parts.append(float_field(7, float(v)))
            parts.append(varint_field(20, ATTR_FLOATS))
        else:
            raise TypeError(f"unsupported attribute list {name}={value!r}")
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return b"".join(parts)


def encode_node(
    op_type: str,
    inputs: typing.Sequence[str],
    outputs: typing.Sequence[str],
    name: str = "",
    attributes: typing.Optional[typing.Dict[str, typing.Any]] = None,
    domain: str = "",
) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5, domain=7."""
    parts = []
    for i in inputs:
        parts.append(string_field(1, i))
    for o in outputs:
        parts.append(string_field(2, o))
    if name:
        parts.append(string_field(3, name))
    parts.append(string_field(4, op_type))
    for k, v in (attributes or {}).items():
        parts.append(bytes_field(5, encode_attribute(k, v)))
    if domain:
        parts.append(string_field(7, domain))
    return b"".join(parts)


def encode_value_info(
    name: str,
    elem_type: int,
    shape: typing.Sequence[typing.Union[int, str, None]],
) -> bytes:
    """ValueInfoProto{name=1, type=2} / TypeProto{tensor_type=1} /
    TypeProto.Tensor{elem_type=1, shape=2} / TensorShapeProto{dim=1} /
    Dimension{dim_value=1 | dim_param=2}.

    ``shape`` entries: int -> fixed, str -> symbolic (dynamic), None ->
    anonymous dynamic.
    """
    dims = []
    for d in shape:
        if isinstance(d, (int, np.integer)):
            dims.append(varint_field(1, int(d)))
        elif isinstance(d, str):
            dims.append(string_field(2, d))
        elif d is None:
            dims.append(b"")  # dimension present, neither value nor param
        else:
            raise TypeError(f"bad dim {d!r}")
    shape_proto = b"".join(bytes_field(1, d) for d in dims)
    tensor_type = varint_field(1, elem_type) + bytes_field(2, shape_proto)
    type_proto = bytes_field(1, tensor_type)
    return string_field(1, name) + bytes_field(2, type_proto)


def encode_graph(
    name: str,
    nodes: typing.Sequence[bytes],
    inputs: typing.Sequence[bytes],
    outputs: typing.Sequence[bytes],
    initializers: typing.Sequence[bytes],
    doc_string: str = "",
) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, doc_string=10, input=11,
    output=12."""
    parts = [bytes_field(1, n) for n in nodes]
    parts.append(string_field(2, name))
    parts += [bytes_field(5, t) for t in initializers]
    if doc_string:
        parts.append(string_field(10, doc_string))
    parts += [bytes_field(11, vi) for vi in inputs]
    parts += [bytes_field(12, vi) for vi in outputs]
    return b"".join(parts)


def encode_model(
    graph: bytes,
    opset_version: int = 12,
    ir_version: int = 7,
    producer_name: str = "glow-tts-train-tpu",
    producer_version: str = "",
    doc_string: str = "",
) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    doc_string=6, graph=7, opset_import=8.
    OperatorSetIdProto: domain=1, version=2 (default domain = "")."""
    opset = varint_field(2, opset_version)  # empty domain field omitted
    parts = [
        varint_field(1, ir_version),
        string_field(2, producer_name),
    ]
    if producer_version:
        parts.append(string_field(3, producer_version))
    if doc_string:
        parts.append(string_field(6, doc_string))
    parts += [bytes_field(7, graph), bytes_field(8, opset)]
    return b"".join(parts)


# --------------------------------------------------------------------------
# Decoder — generic wire parse + typed views (for the numpy runtime and for
# loading externally-produced .onnx files)
# --------------------------------------------------------------------------


def _read_varint(data: bytes, pos: int) -> typing.Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def parse_fields(data: bytes) -> typing.Dict[int, list]:
    """Generic protobuf parse: {field_number: [(wire_type, raw_value), ...]}.

    wire 0 values are the raw unsigned varints; callers needing signed int64
    semantics apply :func:`to_signed`.
    """
    fields: typing.Dict[int, list] = {}
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 1:
            value = data[pos : pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire == 5:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        fields.setdefault(field, []).append((wire, value))
    return fields


def to_signed(value: int) -> int:
    """Interpret an unsigned varint as int64 two's complement."""
    return value - (1 << 64) if value >= (1 << 63) else value


def _scalar(fields, num, default=None):
    vals = fields.get(num)
    if not vals:
        return default
    wire, raw = vals[-1]
    return raw


def _varint_scalar(fields, num, default=0):
    vals = fields.get(num)
    if not vals:
        return default
    return to_signed(vals[-1][1])


def _string(fields, num, default=""):
    raw = _scalar(fields, num)
    return raw.decode("utf-8") if raw is not None else default


def _repeated_varints(fields, num) -> typing.List[int]:
    """Repeated int64: either one-per-tag or packed (wire 2)."""
    out: typing.List[int] = []
    for wire, raw in fields.get(num, []):
        if wire == 0:
            out.append(to_signed(raw))
        elif wire == 2:
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                out.append(to_signed(v))
        else:
            raise ValueError(f"bad wire {wire} for repeated varint field {num}")
    return out


class Tensor(typing.NamedTuple):
    name: str
    array: np.ndarray


def decode_tensor(data: bytes) -> Tensor:
    f = parse_fields(data)
    dims = _repeated_varints(f, 1)
    data_type = _varint_scalar(f, 2, FLOAT)
    name = _string(f, 8)
    dtype = ONNX_TO_NP.get(data_type)
    if dtype is None:
        raise TypeError(f"unsupported tensor data_type {data_type}")
    raw = _scalar(f, 9)
    if raw is not None:
        array = np.frombuffer(raw, dtype=dtype.newbyteorder("<")).astype(dtype)
    elif data_type == FLOAT and 4 in f:
        # float_data (field 4, packed floats)
        raws = b"".join(r for _, r in f[4])
        array = np.frombuffer(raws, dtype="<f4").astype(np.float32)
    elif data_type == INT64 and 7 in f:
        array = np.asarray(_repeated_varints(f, 7), dtype=np.int64)
    elif data_type in (INT32, INT8, UINT8, INT16, UINT16, BOOL) and 5 in f:
        array = np.asarray(_repeated_varints(f, 5)).astype(dtype)
    elif data_type == DOUBLE and 10 in f:
        raws = b"".join(r for _, r in f[10])
        array = np.frombuffer(raws, dtype="<f8").astype(np.float64)
    else:
        array = np.zeros(0, dtype=dtype)
    return Tensor(name, array.reshape(dims) if dims else array.reshape(()))


class Attribute(typing.NamedTuple):
    name: str
    value: typing.Any


def decode_attribute(data: bytes) -> Attribute:
    f = parse_fields(data)
    name = _string(f, 1)
    attr_type = _varint_scalar(f, 20, 0)
    if attr_type == ATTR_FLOAT or (attr_type == 0 and 2 in f):
        return Attribute(name, struct.unpack("<f", _scalar(f, 2))[0])
    if attr_type == ATTR_INT or (attr_type == 0 and 3 in f):
        return Attribute(name, _varint_scalar(f, 3))
    if attr_type == ATTR_STRING or (attr_type == 0 and 4 in f):
        return Attribute(name, _scalar(f, 4, b"").decode("utf-8"))
    if attr_type == ATTR_TENSOR or (attr_type == 0 and 5 in f):
        return Attribute(name, decode_tensor(_scalar(f, 5)))
    if attr_type == ATTR_FLOATS or (attr_type == 0 and 7 in f):
        vals: typing.List[float] = []
        for wire, raw in f.get(7, []):
            if wire == 5:
                vals.append(struct.unpack("<f", raw)[0])
            else:  # packed
                vals.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
        return Attribute(name, vals)
    if attr_type == ATTR_INTS or (attr_type == 0 and 8 in f):
        return Attribute(name, _repeated_varints(f, 8))
    if attr_type == ATTR_STRINGS:
        return Attribute(name, [r.decode("utf-8") for _, r in f.get(9, [])])
    return Attribute(name, None)


class Node(typing.NamedTuple):
    op_type: str
    inputs: typing.List[str]
    outputs: typing.List[str]
    name: str
    attributes: typing.Dict[str, typing.Any]
    domain: str


def decode_node(data: bytes) -> Node:
    f = parse_fields(data)
    return Node(
        op_type=_string(f, 4),
        inputs=[r.decode("utf-8") for _, r in f.get(1, [])],
        outputs=[r.decode("utf-8") for _, r in f.get(2, [])],
        name=_string(f, 3),
        attributes=dict(
            decode_attribute(r) for _, r in f.get(5, [])
        ),
        domain=_string(f, 7),
    )


class ValueInfo(typing.NamedTuple):
    name: str
    elem_type: int
    shape: typing.List[typing.Union[int, str, None]]


def decode_value_info(data: bytes) -> ValueInfo:
    f = parse_fields(data)
    name = _string(f, 1)
    elem_type = FLOAT
    shape: typing.List[typing.Union[int, str, None]] = []
    type_raw = _scalar(f, 2)
    if type_raw is not None:
        tf = parse_fields(type_raw)
        tensor_raw = _scalar(tf, 1)
        if tensor_raw is not None:
            tt = parse_fields(tensor_raw)
            elem_type = _varint_scalar(tt, 1, FLOAT)
            shape_raw = _scalar(tt, 2)
            if shape_raw is not None:
                sf = parse_fields(shape_raw)
                for _, dim_raw in sf.get(1, []):
                    df = parse_fields(dim_raw)
                    if 1 in df:
                        shape.append(_varint_scalar(df, 1))
                    elif 2 in df:
                        shape.append(_string(df, 2))
                    else:
                        shape.append(None)
    return ValueInfo(name, elem_type, shape)


class Graph(typing.NamedTuple):
    name: str
    nodes: typing.List[Node]
    inputs: typing.List[ValueInfo]
    outputs: typing.List[ValueInfo]
    initializers: typing.List[Tensor]


def decode_graph(data: bytes) -> Graph:
    f = parse_fields(data)
    return Graph(
        name=_string(f, 2),
        nodes=[decode_node(r) for _, r in f.get(1, [])],
        inputs=[decode_value_info(r) for _, r in f.get(11, [])],
        outputs=[decode_value_info(r) for _, r in f.get(12, [])],
        initializers=[decode_tensor(r) for _, r in f.get(5, [])],
    )


class Model(typing.NamedTuple):
    ir_version: int
    producer_name: str
    opset_version: int
    graph: Graph
    doc_string: str


def decode_model(data: bytes) -> Model:
    f = parse_fields(data)
    opset_version = 0
    for _, raw in f.get(8, []):
        of = parse_fields(raw)
        domain = _string(of, 1)
        if domain in ("", "ai.onnx"):
            opset_version = _varint_scalar(of, 2, 0)
    graph_raw = _scalar(f, 7)
    if graph_raw is None:
        raise ValueError("ModelProto has no graph")
    return Model(
        ir_version=_varint_scalar(f, 1, 0),
        producer_name=_string(f, 2),
        opset_version=opset_version,
        graph=decode_graph(graph_raw),
        doc_string=_string(f, 6),
    )

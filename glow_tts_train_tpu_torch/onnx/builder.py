"""ONNX GraphProto builder on top of the hand-rolled wire format (proto.py).

A thin, explicit builder: ``node()`` appends one NodeProto and returns the
output value name(s); ``init()`` registers an initializer; ``const()``
deduplicates small constant tensors.  The Glow-TTS generator graph itself
is constructed in export_onnx.py.
"""

from __future__ import annotations

import typing

import numpy as np

from . import proto


class GraphBuilder:
    def __init__(self, name: str):
        self.name = name
        self._nodes: typing.List[bytes] = []
        self._inputs: typing.List[bytes] = []
        self._outputs: typing.List[bytes] = []
        self._initializers: typing.List[bytes] = []
        self._counter = 0
        self._const_cache: typing.Dict[
            typing.Tuple[str, bytes, typing.Tuple[int, ...]], str
        ] = {}
        self._names: typing.Set[str] = set()

    # -- naming ------------------------------------------------------------

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        name = f"{hint}_{self._counter}"
        while name in self._names:
            self._counter += 1
            name = f"{hint}_{self._counter}"
        self._names.add(name)
        return name

    # -- graph I/O ---------------------------------------------------------

    def input(
        self,
        name: str,
        elem_type: int,
        shape: typing.Sequence[typing.Union[int, str, None]],
    ) -> str:
        self._inputs.append(proto.encode_value_info(name, elem_type, shape))
        self._names.add(name)
        return name

    def output(
        self,
        name: str,
        elem_type: int,
        shape: typing.Sequence[typing.Union[int, str, None]],
    ) -> str:
        self._outputs.append(proto.encode_value_info(name, elem_type, shape))
        return name

    # -- initializers ------------------------------------------------------

    def init(self, hint: str, array: np.ndarray) -> str:
        name = self.fresh(hint)
        self._initializers.append(proto.encode_tensor(name, np.asarray(array)))
        return name

    def const(self, array, dtype=None, hint: str = "c") -> str:
        """Deduplicated constant initializer (for shapes, axes, scalars)."""
        arr = np.asarray(array, dtype=dtype)
        key = (str(arr.dtype), arr.tobytes(), arr.shape)
        cached = self._const_cache.get(key)
        if cached is not None:
            return cached
        name = self.init(hint, arr)
        self._const_cache[key] = name
        return name

    def i64(self, values) -> str:
        """1-D int64 constant (the shape/axes workhorse)."""
        return self.const(np.atleast_1d(np.asarray(values, np.int64)))

    def i64_scalar(self, value: int) -> str:
        return self.const(np.asarray(value, np.int64))

    def f32_scalar(self, value: float) -> str:
        return self.const(np.asarray(value, np.float32))

    # -- nodes ---------------------------------------------------------------

    def node(
        self,
        op_type: str,
        inputs: typing.Sequence[str],
        n_outputs: int = 1,
        outputs: typing.Optional[typing.Sequence[str]] = None,
        name_hint: typing.Optional[str] = None,
        **attributes,
    ):
        """Append a node; returns the single output name or a list of them."""
        if outputs is None:
            hint = name_hint or op_type.lower()
            outputs = [self.fresh(hint) for _ in range(n_outputs)]
        self._nodes.append(
            proto.encode_node(
                op_type,
                list(inputs),
                list(outputs),
                name=self.fresh(f"n_{op_type.lower()}"),
                attributes=attributes or None,
            )
        )
        return outputs[0] if len(outputs) == 1 else list(outputs)

    # -- serialization -------------------------------------------------------

    def graph_bytes(self, doc_string: str = "") -> bytes:
        return proto.encode_graph(
            self.name,
            self._nodes,
            self._inputs,
            self._outputs,
            self._initializers,
            doc_string=doc_string,
        )

    def model_bytes(
        self,
        opset_version: int = 12,
        ir_version: int = 7,
        producer_name: str = "glow-tts-train-tpu",
        producer_version: str = "",
        doc_string: str = "",
    ) -> bytes:
        return proto.encode_model(
            self.graph_bytes(),
            opset_version=opset_version,
            ir_version=ir_version,
            producer_name=producer_name,
            producer_version=producer_version,
            doc_string=doc_string,
        )

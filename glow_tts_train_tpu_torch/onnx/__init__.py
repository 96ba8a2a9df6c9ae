"""Native ONNX subsystem — emit, read, and execute .onnx with no third-party
ONNX packages.

The reference's ONNX story is torch.onnx.export (export_onnx.py:105-118) +
onnxruntime (infer_onnx.py:67-75).  This package replaces both ends with
first-party code:

* proto.py    — the ModelProto protobuf wire format, hand-rolled
* builder.py  — a GraphProto builder (nodes/initializers/dynamic dims)
* export.py   — the Glow-TTS generation graph as opset-12 ONNX
  (the CLI is ``glow_tts_train_tpu_torch/export.py --format onnx``)
* runtime.py  — a pure-numpy executor for the emitted op subset

onnxruntime is still preferred at run time when importable; these modules
make the capability self-contained where it is not.
"""

from .builder import GraphBuilder  # noqa: F401
from .runtime import OnnxRuntime  # noqa: F401

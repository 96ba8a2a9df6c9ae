"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, named by
a hash of the sources so an edited source never loads a stale build, and
loaded with ctypes.  Nothing is compiled or loaded at import time.  The
library goes under ``build/torch_kernels/`` at the root of a checkout;
an installed package builds under ``$TORCH_EXTENSIONS_DIR`` (default
``~/.cache/torch_extensions``) instead.

Each C entry point runs one TPU kernel's counterpart (a short chain of
launches on the caller's stream), returns ``cudaGetLastError()``, and
allocates nothing: the Python wrappers in ``ops/*_cuda.py`` allocate
outputs and scratch with ``torch.empty``.  :class:`Entry` holds one entry
point's signature and its launch count.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import typing
from pathlib import Path

import torch

_PACKAGE = Path(__file__).resolve().parent
_CSRC = _PACKAGE / "csrc"
if (_PACKAGE.parent / "pyproject.toml").exists():  # a checkout of the repository
    _BUILD_DIR = _PACKAGE.parent / "build" / "torch_kernels"
else:
    _BUILD_DIR = Path(
        os.environ.get("TORCH_EXTENSIONS_DIR", Path.home() / ".cache" / "torch_extensions")
    ) / "glow_tts_train_tpu_torch"
_ARCH = "arch=compute_90a,code=sm_90a"
# sources in link order; every .cu and .cuh under csrc/ feeds the hash
_SOURCES = ("common.cu", "text.cu", "encoder.cu", "block.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int

_lib: typing.Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    digest = hashlib.sha256(_ARCH.encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library
    path.  The compiler's register/shared-memory report (``-Xptxas -v``)
    goes to ``<library>.log`` beside the library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _BUILD_DIR / f"libgtt_kernels_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-lineinfo",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def check_operands(device: torch.device, **tensors) -> None:
    """Raise unless every given tensor is contiguous float32 on ``device``
    (``None`` entries are optional operands and pass)."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}: the CUDA kernels take contiguous float32 tensors on "
                f"{device}; got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}"
            )


def check_shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def route(x: torch.Tensor) -> str:
    """Which version of a kernel runs for ``x``: "cuda" for a CUDA tensor,
    "plain" for a CPU tensor; any other device raises."""
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel or plain version for device {x.device}")


class Entry:
    """One C entry point: its ctypes signature and a launch count.

    ``launches`` goes up by one each time the entry point runs its kernels
    without a launch error, and nowhere else.  Arguments are tensors
    (passed as device pointers; ``None`` as a null pointer) and Python ints
    in the C signature's order; the stream is the current CUDA stream."""

    def __init__(self, symbol: str, n_pointers: int, n_ints: int):
        self.symbol = symbol
        # pointers, then ints, then the stream
        self.argtypes = [_P] * n_pointers + [_I] * n_ints + [_P]
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        stream = torch.cuda.current_stream(device).cuda_stream
        c_args = [
            a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args
        ]
        with torch.cuda.device(device):
            err = self._fn(*c_args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


# C signatures: pointer arguments first, then ints (csrc/*.cu)
PRENET = Entry("gtt_prenet", n_pointers=11, n_ints=5)
DURATION_STACK = Entry("gtt_duration_stack", n_pointers=12, n_ints=5)
ENCODER_LAYER = Entry("gtt_encoder_layer", n_pointers=25, n_ints=7)
BLOCK_INVERSE = Entry("gtt_block_inverse", n_pointers=18, n_ints=9)

ENTRIES = {
    "prenet": PRENET,
    "encoder_layer": ENCODER_LAYER,
    "duration_stack": DURATION_STACK,
    "block_inverse": BLOCK_INVERSE,
}


def launch_counts() -> typing.Dict[str, int]:
    return {name: e.launches for name, e in ENTRIES.items()}


def reset_launch_counts() -> None:
    for e in ENTRIES.values():
        e.launches = 0

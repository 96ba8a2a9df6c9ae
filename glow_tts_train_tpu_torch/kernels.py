"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

At first use the sources are compiled with ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source file and all of them at
once, and linked into one shared library with a plain C interface, named
by a hash of the sources so an edited source never loads a stale build,
and loaded with ctypes.  Nothing is compiled or loaded at import time.  The
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
import functools
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
_SOURCES = (
    "common.cu", "tc_gemm.cu", "text.cu", "text_train.cu", "encoder.cu", "encoder_train.cu",
    "block.cu", "block_train.cu", "mas.cu",
)

# argument kinds of the C signatures: pointer, int, 64-bit int, unsigned
# int, float
_KINDS = {
    "p": ctypes.c_void_p, "i": ctypes.c_int, "L": ctypes.c_longlong, "u": ctypes.c_uint,
    "f": ctypes.c_float,
}

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
    nvcc = _nvcc()
    objects = [_BUILD_DIR / f"{Path(s).stem}.{os.getpid()}.o" for s in _SOURCES]
    compiles = [
        subprocess.Popen(
            [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
             "-Xcompiler", "-fPIC", "-c", "-o", str(obj), str(_CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_SOURCES, objects)
    ]
    logs = [proc.communicate()[0] for proc in compiles]
    failed = [(s, log) for s, proc, log in zip(_SOURCES, compiles, logs) if proc.returncode != 0]
    link = None
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", _ARCH, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True,
        )
        logs.append(link.stdout + link.stderr)
    lib_path.with_suffix(".log").write_text("".join(logs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"{s}:\n{log[-4000:]}" for s, log in failed)
        )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
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
    (passed as device pointers; ``None`` as a null pointer) and Python
    numbers in the C signature's order; the stream is the current CUDA
    stream.  ``signature`` spells the C arguments before the stream, one
    letter each: ``p`` pointer, ``i`` int, ``L`` 64-bit int, ``u``
    unsigned int, ``f`` float."""

    def __init__(self, symbol: str, signature: str):
        self.symbol = symbol
        self.argtypes = [_KINDS[k] for k in signature] + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        if len(args) != len(self.argtypes) - 1:
            raise TypeError(
                f"{self.symbol}: {len(args)} arguments for {len(self.argtypes) - 1} in its signature"
            )
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


# C signatures (csrc/*.cu): pointer arguments first, then numbers
PRENET = Entry("gtt_prenet", "p" * 10 + "L" + "i" * 7 + "uf")
DURATION_STACK = Entry("gtt_duration_stack", "p" * 12 + "L" + "i" * 7 + "uf")
ENCODER_LAYER = Entry("gtt_encoder_layer", "p" * 18 + "L" + "i" * 9 + "uf")
PRENET_BWD = Entry("gtt_prenet_bwd", "p" * 19 + "L" + "i" * 7 + "uf")
DURATION_STACK_BWD = Entry("gtt_duration_stack_bwd", "p" * 23 + "L" + "i" * 7 + "uf")
ENCODER_LAYER_BWD = Entry("gtt_encoder_layer_bwd", "p" * 35 + "L" + "i" * 9 + "uf")
BLOCK_INVERSE = Entry("gtt_block_inverse", "p" * 20 + "L" + "i" * 9)
WN_FORWARD = Entry("gtt_wn_forward", "p" * 11 + "i" * 10 + "uf")
WN_FWD_SAVE = Entry("gtt_wn_fwd_save", "p" * 13 + "i" * 10 + "uf")
WN_BWD_STORE = Entry("gtt_wn_bwd_store", "p" * 14 + "L" + "i" * 8 + "uf")
WN_BWD = Entry("gtt_wn_bwd", "p" * 15 + "L" + "i" * 9 + "uf")
BLOCK_FWD = Entry("gtt_block_fwd", "p" * 21 + "i" * 12 + "uf")
BLOCK_FWD_SAVE = Entry("gtt_block_fwd_save", "p" * 24 + "i" * 12 + "uf")
BLOCK_BWD_STORE = Entry("gtt_block_bwd_store", "p" * 28 + "L" + "i" * 10 + "uf")
BLOCK_BWD = Entry("gtt_block_bwd", "p" * 28 + "L" + "i" * 11 + "uf")
MAS = Entry("gtt_mas", "p" * 5 + "i" * 3)
# the two tensor-core device kernels alone (csrc/tc_gemm.cu), and the
# weights' K-major split
TC_CONV_GEMM = Entry("gtt_tc_conv_gemm", "p" * 5 + "L" + "i" * 10)
TC_CONV_GEMM_TILED = Entry("gtt_tc_conv_gemm_tiled", "p" * 4 + "L" + "i" * 7)
TC_CONV_GEMM_WALK = Entry("gtt_tc_conv_gemm_walk", "p" * 4 + "L" + "i" * 8)
TC_WGRAD = Entry("gtt_tc_wgrad", "p" * 8 + "i" * 11)
SPLIT_WEIGHTS = Entry("gtt_split_weights", "p" * 3 + "i" * 2)

ENTRIES = {
    "prenet": PRENET,
    "encoder_layer": ENCODER_LAYER,
    "duration_stack": DURATION_STACK,
    "block_inverse": BLOCK_INVERSE,
    "wn_forward": WN_FORWARD,
    "wn_fwd_save": WN_FWD_SAVE,
    "wn_bwd_store": WN_BWD_STORE,
    "wn_bwd": WN_BWD,
    "block_fwd": BLOCK_FWD,
    "block_fwd_save": BLOCK_FWD_SAVE,
    "block_bwd_store": BLOCK_BWD_STORE,
    "block_bwd": BLOCK_BWD,
    "mas": MAS,
    "prenet_bwd": PRENET_BWD,
    "encoder_layer_bwd": ENCODER_LAYER_BWD,
    "duration_stack_bwd": DURATION_STACK_BWD,
    "tc_conv_gemm": TC_CONV_GEMM,
    "tc_conv_gemm_tiled": TC_CONV_GEMM_TILED,
    "tc_conv_gemm_walk": TC_CONV_GEMM_WALK,
    "tc_wgrad": TC_WGRAD,
    "split_weights": SPLIT_WEIGHTS,
}

PRODUCT_COUNT_NAMES = (
    "tc_gemm", "tc_wgrad", "core_gemm", "core_wgrad", "declined_gemm", "declined_wgrad",
    "tap_staged_gemm", "bias_wgrad", "split_dy_wgrad",
)


def product_counts(reset: bool = False) -> typing.Dict[str, int]:
    """Device products launched by the built library since the last reset:
    conv-GEMMs and weight gradients on the tensor cores (``tc_*``) and on the
    CUDA cores (``core_*``), of the latter those whose launch chain had
    asked for the tensor-core kernel and was declined (``declined_*``: the
    shape did not fit), and of the tensor-core ones those in the WN reverse
    walk's modes: tap-staged conv-GEMMs (``tap_staged_gemm``), weight
    gradients with a bias row (``bias_wgrad``) and reading dY's K-major
    split (``split_dy_wgrad``).  ``reset`` zeroes the counters after the
    read."""
    fn = library().gtt_product_counts
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    fn.restype = None
    counts = (ctypes.c_longlong * len(PRODUCT_COUNT_NAMES))()
    fn(counts, int(reset))
    return dict(zip(PRODUCT_COUNT_NAMES, counts))


def product_splits(reset: bool = False) -> int:
    """Weight splits that tensor-core conv-GEMMs launched for themselves
    since the last reset: products whose weights were not split beforehand
    (once a chain call by ``presplit_weights``, or once at load for
    serving).  ``reset`` zeroes the count after the read."""
    fn = library().gtt_product_splits
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(int(reset)))


@functools.lru_cache(maxsize=None)
def _size_fn(symbol: str, n_dims: int):
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_int] * n_dims
    fn.restype = ctypes.c_longlong
    return fn


@functools.lru_cache(maxsize=256)
def _size_query(symbol: str, *dims: int) -> int:
    """A size that depends on the shapes alone (and, for MAS, on the
    current device's shared memory: its index is one of ``dims``)."""
    return int(_size_fn(symbol, len(dims))(*dims))


def encoder_scratch_floats(
    batch: int, t: int, h: int, n_heads: int, window: int, f: int, taps: int, backward: bool
) -> int:
    """Floats of the one scratch block a call of the encoder layer's
    forward (or backward) entry point carves its buffers from."""
    return _size_query(
        "gtt_encoder_scratch_floats", batch, t, h, n_heads, window, f, taps, int(backward)
    )


def prenet_scratch_floats(
    batch: int, t: int, h: int, n_layers: int, taps: int, backward: bool
) -> int:
    """Floats of the one scratch block a call of the prenet's forward (or
    backward) entry point carves its buffers from."""
    return _size_query("gtt_prenet_scratch_floats", batch, t, h, n_layers, taps, int(backward))


def block_inverse_scratch_floats(batch: int, t: int, c: int, h: int) -> int:
    """Floats of the one scratch block a call of the serving flow block's
    entry point carves its buffers from."""
    return _size_query("gtt_block_inverse_scratch_floats", batch, t, c, h)


def wn_bwd_scratch_floats(batch: int, t: int, h: int, n_layers: int, taps: int,
                          recompute: bool, with_g: bool) -> int:
    """Floats of the one scratch block a call of the WN stack's backward
    entry points (from saves, or recomputing the forward) carves its
    buffers from; ``with_g``: the conditioning gradient is asked for."""
    return _size_query("gtt_wn_bwd_scratch_floats", batch, t, h, n_layers, taps,
                       int(recompute), int(with_g))


def block_bwd_scratch_floats(batch: int, t: int, c: int, h: int, n_layers: int, taps: int,
                             recompute: bool, with_g: bool) -> int:
    """Floats of the one scratch block a call of the flow block's backward
    entry points carves its buffers from."""
    return _size_query("gtt_block_bwd_scratch_floats", batch, t, c, h, n_layers, taps,
                       int(recompute), int(with_g))


def duration_scratch_floats(batch: int, t: int, c_in: int, f: int, taps: int,
                            backward: bool) -> int:
    """Floats of the one scratch block a call of the duration stack's
    forward (or backward) entry point carves its buffers from."""
    return _size_query("gtt_duration_scratch_floats", batch, t, c_in, f, taps, int(backward))


def mas_bits_words(batch: int, t_x: int, t_y: int, device: torch.device) -> int:
    """Words of device memory MAS needs on ``device`` for its stay bits (0:
    they fit in shared memory; -1: the kernel does not take the shape)."""
    with torch.cuda.device(device):
        return _size_query("gtt_mas_bits_words", batch, t_x, t_y, torch.cuda.current_device())


def launch_counts() -> typing.Dict[str, int]:
    return {name: e.launches for name, e in ENTRIES.items()}


def reset_launch_counts() -> None:
    for e in ENTRIES.values():
        e.launches = 0

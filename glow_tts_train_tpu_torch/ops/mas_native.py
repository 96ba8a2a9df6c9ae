"""Monotonic alignment search on the host: ``csrc/mas_host.cpp`` (a copy of
the JAX package's ``native/mas.cpp``, plain C++ with OpenMP over the
batch) built with g++ at first use and bound with ctypes, the counterpart
of glow_tts_train_tpu ``ops/mas_native.py``.

:func:`mas_cuda.maximum_path` sends CPU tensors here (``--platform cpu``
training, the CPU tests of a step); CUDA tensors take the ``gtt_mas``
kernel.  The paths equal ``mas_cuda.maximum_path_plain``'s and the numpy
oracle's bit for bit: the same banded f32 recurrence, ties stay.

The library goes beside the CUDA kernels' (``kernels._BUILD_DIR``), named
by a hash of the source and the flags, written under a temporary name and
moved into place, so concurrent first builds never load half a file.  A
failed build raises with the compiler's output; nothing falls back to the
torch loop.
"""

import ctypes
import hashlib
import os
import subprocess
import typing
from pathlib import Path

import torch

from .. import kernels

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "mas_host.cpp"
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
# the C++ compiler the library is built with
COMPILER = "g++"
# mas_cuda._MAX_NEG: the value of a cell the path cannot reach
_MAX_NEG = -1e9

_lib: typing.Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    return kernels._BUILD_DIR / f"libgtt_mas_host_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library (once per source hash) and return its path;
    raise ``RuntimeError`` with the compiler's output where it fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [COMPILER, *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host MAS: cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"host MAS: {' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.maximum_path_batch.restype = None
        lib.maximum_path_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        # libgomp's, which the library links
        lib.omp_set_num_threads.restype = None
        lib.omp_set_num_threads.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


@torch.no_grad()
def maximum_path_host(logp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Best monotonic alignment path of CPU tensors: logp, mask [b, t_x,
    t_y] (mask 0/1, rectangular per sample) -> 0/1 path [b, t_x, t_y] in
    logp's dtype.  The samples run in parallel on torch's host thread
    count (``torch.get_num_threads``), at most one thread a sample."""
    if logp.device.type != "cpu" or mask.device.type != "cpu":
        raise ValueError(f"maximum_path_host takes CPU tensors; got {logp.device}, {mask.device}")
    kernels.check_shape("mask", mask, logp.shape)
    lib = library()
    b, t_x, t_y = logp.shape
    maskf = mask.to(torch.float32)
    values = (logp.to(torch.float32) * maskf).contiguous()  # the library updates it in place
    paths = torch.zeros((b, t_x, t_y), dtype=torch.int32)
    t_xs = maskf[:, :, 0].sum(1).to(torch.int32).contiguous()
    t_ys = maskf[:, 0, :].sum(1).to(torch.int32).contiguous()
    # a thread a sample at most: an idle thread of the region only contends
    # with torch's own pool
    lib.omp_set_num_threads(max(1, min(torch.get_num_threads(), b)))
    lib.maximum_path_batch(paths.data_ptr(), values.data_ptr(), t_xs.data_ptr(),
                           t_ys.data_ptr(), b, t_x, t_y, _MAX_NEG)
    return (paths * maskf).to(logp.dtype)

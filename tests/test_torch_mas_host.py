"""The port's host MAS (``ops/mas_native.py`` over ``csrc/mas_host.cpp``),
which ``mas_cuda.maximum_path`` runs for CPU tensors: its paths equal
``mas_cuda.maximum_path_plain``'s, the JAX package's numpy oracle's
(``ops/mas.py`` ``maximum_path_numpy``) and the JAX package's host
library's (``ops/mas_native.py`` ``maximum_path_cpp``) bit for bit; its
source is ``native/mas.cpp`` byte for byte; a failed build raises; and a
CPU ``forward_train`` aligns through it as through the plain version."""

from pathlib import Path

import numpy as np
import pytest
import torch

from glow_tts_train_tpu.ops import mas as jax_mas
from glow_tts_train_tpu.ops import mas_native as jax_mas_native
from glow_tts_train_tpu_torch import checkpoint, kernels, training
from glow_tts_train_tpu_torch.models import glow_tts as model
from glow_tts_train_tpu_torch.ops import mas_cuda, mas_native

from helpers import random_batch, tiny_config

REPO = Path(__file__).resolve().parent.parent

# name -> (shape, logp kind, ragged)
CASES = {
    "random": ((3, 40, 120), "normal", False),
    "random_ragged": ((4, 37, 150), "normal", True),
    "ties_integer_logp": ((3, 30, 90), "integer", True),
    "ties_all_equal": ((2, 25, 60), "zeros", True),
    "t_x_equals_t_y": ((2, 48, 48), "normal", False),
    "t_x_one": ((3, 1, 50), "normal", True),
    "long_text": ((1, 1345, 1400), "normal", False),
}


def _inputs(shape, kind, ragged, seed=0):
    rng = np.random.default_rng(seed)
    b, t_x, t_y = shape
    if kind == "normal":
        logp = rng.standard_normal(shape).astype(np.float32)
    elif kind == "integer":
        logp = rng.integers(-2, 1, shape).astype(np.float32)
    else:
        logp = np.zeros(shape, np.float32)
    x_len = np.full(b, t_x)
    y_len = np.full(b, t_y)
    if ragged:
        x_len[1:] = rng.integers(1, t_x + 1, b - 1)
        y_len[1:] = np.maximum(rng.integers(t_y // 2, t_y + 1, b - 1), x_len[1:])
    mask = ((np.arange(t_x)[None, :, None] < x_len[:, None, None])
            & (np.arange(t_y)[None, None, :] < y_len[:, None, None])).astype(np.float32)
    return logp, mask


@pytest.fixture(scope="module")
def jax_host_library(tmp_path_factory):
    """The JAX package's host library built into this module's own
    directory, so that no other test process (``tests/test_mas.py``) sees
    ``native/build/libmas.so`` half written."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_mas_native, "_LIB", tmp_path_factory.mktemp("jax_mas") / "libmas.so")
        m.setattr(jax_mas_native, "_lib_handle", None)
        yield jax_mas_native.maximum_path_cpp


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_path_equals_plain_and_both_jax_oracles(case, jax_host_library):
    shape, kind, ragged = CASES[case]
    logp, mask = _inputs(shape, kind, ragged)
    got = mas_native.maximum_path_host(torch.from_numpy(logp), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    got = got.numpy()
    assert set(np.unique(got)) <= {0.0, 1.0}
    # every text row of a sample is visited, and every frame holds one row
    np.testing.assert_array_equal(got.sum(1), mask[:, 0, :])
    np.testing.assert_array_equal(
        mas_cuda.maximum_path_plain(torch.from_numpy(logp), torch.from_numpy(mask)).numpy(), got)
    np.testing.assert_array_equal(jax_host_library(logp, mask), got)
    np.testing.assert_array_equal(jax_mas.maximum_path_numpy(logp, mask), got)


def test_maximum_path_routes_cpu_tensors_to_the_host_library(monkeypatch, jax_host_library):
    """``mas_cuda.maximum_path`` on CPU tensors runs the host library, in
    logp's dtype, not the torch loop."""
    calls = []
    host = mas_native.maximum_path_host

    def counted(logp, mask):
        calls.append(tuple(logp.shape))
        return host(logp, mask)

    def refused(*_):
        raise AssertionError("the torch loop ran")

    monkeypatch.setattr(mas_native, "maximum_path_host", counted)
    monkeypatch.setattr(mas_cuda, "maximum_path_plain", refused)
    logp, mask = _inputs((2, 12, 40), "normal", True)
    path = mas_cuda.maximum_path(torch.from_numpy(logp).double(), torch.from_numpy(mask))
    assert calls == [(2, 12, 40)] and path.dtype == torch.float64
    np.testing.assert_array_equal(path.numpy(), jax_host_library(logp, mask))


def test_copy_equals_native_mas_cpp():
    """``csrc/mas_host.cpp`` is the JAX package's ``native/mas.cpp`` byte
    for byte, and the CUDA build does not compile it."""
    copy = REPO / "glow_tts_train_tpu_torch" / "csrc" / "mas_host.cpp"
    assert copy.read_bytes() == (REPO / "native" / "mas.cpp").read_bytes()
    assert all(s.endswith(".cu") for s in kernels._SOURCES)
    assert "mas_host.cpp" not in kernels._SOURCES


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """A compiler that is not there, or one that fails, makes
    ``maximum_path`` on CPU tensors raise with its error; nothing falls
    back to the torch loop."""
    if compiler == "missing":
        path, expect = tmp_path / "no-such-g++", "cannot run"
    else:
        path, expect = tmp_path / "failing-g++", "mas_host.cpp: no such thing"
        path.write_text("#!/bin/sh\necho 'mas_host.cpp: no such thing' >&2\nexit 3\n")
        path.chmod(0o755)
    monkeypatch.setattr(mas_native, "COMPILER", str(path))
    monkeypatch.setattr(mas_native, "_lib", None)
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build")
    logp, mask = _inputs((2, 8, 20), "normal", False)
    with pytest.raises(RuntimeError, match=expect):
        mas_cuda.maximum_path(torch.from_numpy(logp), torch.from_numpy(mask))
    assert not list((tmp_path / "build").glob("*.so"))


def test_forward_train_aligns_as_through_the_plain_version(monkeypatch):
    """A CPU ``forward_train`` (dropout off) gives the same path, and the
    same outputs, through the host library as through
    ``maximum_path_plain``."""
    config = tiny_config(p_dropout=0.0, p_dropout_dec=0.0)
    hp = model.hyper_from_config(config)
    flat = {k[len("model/"):]: v for k, v in checkpoint.random_params(hp, 3).items()}
    params = training.trainable_model(flat, hp, "cpu").tree()
    batch = training.batch_to(random_batch(config, np.random.default_rng(5), b=4), "cpu")
    args = (params, hp, batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"])
    calls = []
    host = mas_native.maximum_path_host
    monkeypatch.setattr(mas_native, "maximum_path_host",
                        lambda *a: calls.append(1) or host(*a))
    with torch.no_grad():
        out_host = model.forward_train(*args)
        assert calls == [1]
        monkeypatch.setattr(mas_cuda, "maximum_path", mas_cuda.maximum_path_plain)
        out_plain = model.forward_train(*args)
    assert calls == [1]
    attn_host, attn_plain = out_host[2][0], out_plain[2][0]
    assert attn_host.sum() > 0
    torch.testing.assert_close(attn_host, attn_plain, rtol=0, atol=0)
    for a, b in zip(torch.utils._pytree.tree_leaves(out_host),
                    torch.utils._pytree.tree_leaves(out_plain)):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

"""The port's inference CLI (python -m glow_tts_train_tpu_torch.infer)
against the JAX package's on the same checkpoint and stdin, in fresh
subprocesses, plus its contract (--csv, --numpy-dir, --batch-size,
out-of-range ids, --platform cuda without a GPU) and the package's
independence from jax."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from glow_tts_train_tpu_torch import checkpoint
from glow_tts_train_tpu_torch.models import hyper_from_config

from helpers import tiny_config

STDIN = "3 7 12 5 9 14 2\n4 8 2\n11 1 19 6 13 3 8 15 2 10\n"
# f32 on the CPU in both frameworks; the mel passes 2 inverse flow blocks
MEL_ATOL = 1e-4


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # --platform cpu does the forcing
    return env


def _run(module, ckpt, cfg, stdin_text, *extra):
    return subprocess.run(
        [sys.executable, "-m", module, str(ckpt), "--config", str(cfg),
         "--platform", "cpu", "--noise-scale", "0", *extra],
        input=stdin_text, capture_output=True, text=True, env=_env(), timeout=300,
    )


def _mels(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    return [
        np.asarray(json.loads(line)["mel"], np.float32)
        for line in proc.stdout.splitlines() if line.strip()
    ]


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    config = tiny_config()
    hp = hyper_from_config(config)
    ckpt = tmp / "checkpoint_1.npz"
    checkpoint.save_npz(ckpt, checkpoint.random_params(hp, 3))
    cfg = tmp / "config.json"
    with open(cfg, "w") as f:
        config.save(f)
    return ckpt, cfg


@pytest.fixture(scope="module")
def jax_mels(model_files):
    return _mels(_run("glow_tts_train_tpu.infer", *model_files, STDIN))


@pytest.mark.parametrize("batch_size", ["1", "3"])
def test_cli_jsonl_matches_jax(model_files, jax_mels, batch_size):
    proc = _run("glow_tts_train_tpu_torch.infer", *model_files, STDIN,
                "--batch-size", batch_size)
    port = _mels(proc)
    assert len(port) == len(jax_mels) == 3
    for p, r in zip(port, jax_mels):
        assert p.shape == r.shape and p.shape[0] == 8
        np.testing.assert_allclose(p, r, rtol=0, atol=MEL_ATOL)
    obj = json.loads(proc.stdout.splitlines()[0])
    assert set(obj) == {"id", "audio", "mel"}
    assert obj["audio"]["mel_channels"] == 8


def test_cli_csv_numpy_dir(model_files, jax_mels, tmp_path):
    lines = [f"utt{i}|{line}" for i, line in enumerate(STDIN.splitlines())]
    out_dir = tmp_path / "mels"
    proc = _run("glow_tts_train_tpu_torch.infer", *model_files, "\n".join(lines) + "\n",
                "--csv", "--numpy-dir", str(out_dir), "--batch-size", "3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert sorted(p.name for p in out_dir.glob("*.npy")) == ["utt0.npy", "utt1.npy", "utt2.npy"]
    for i, ref in enumerate(jax_mels):
        np.testing.assert_allclose(np.load(out_dir / f"utt{i}.npy"), ref, rtol=0, atol=MEL_ATOL)


def test_cli_rejects_out_of_range_ids(model_files):
    proc = _run("glow_tts_train_tpu_torch.infer", *model_files, "3 7 999\n4 8 2\n")
    assert proc.returncode == 1
    assert len([l for l in proc.stdout.splitlines() if l.strip()]) == 1
    assert "out of range" in proc.stderr
    assert "exiting non-zero" in proc.stderr


def test_cli_cuda_platform_needs_a_gpu(model_files):
    """--platform cuda never drops to the CPU: without a GPU it exits with
    an error (the default platform is cuda)."""
    ckpt, cfg = model_files
    proc = subprocess.run(
        [sys.executable, "-m", "glow_tts_train_tpu_torch.infer", str(ckpt),
         "--config", str(cfg)],
        input="3 7 12\n", capture_output=True, text=True, env=_env(), timeout=300,
        )
    probe = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
        capture_output=True, text=True, env=_env(), timeout=120,
    )
    if probe.stdout.strip() == "True":
        assert proc.returncode == 0, proc.stderr[-2000:]
    else:
        assert proc.returncode == 2
        assert "no CUDA device" in proc.stderr
        assert proc.stdout.strip() == ""


def test_package_imports_no_jax():
    """Importing the port and every submodule leaves jax out of
    sys.modules (a fresh process: the test session itself imports jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import glow_tts_train_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'glow_tts_train_tpu_torch.infer' in names, names\n"
        "assert 'glow_tts_train_tpu_torch.ops.block_cuda' in names, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]

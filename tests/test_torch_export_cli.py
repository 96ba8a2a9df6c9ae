"""The port's export CLI (python -m glow_tts_train_tpu_torch.export) and
the CLI that runs its artifacts (python -m
glow_tts_train_tpu_torch.infer_export), end to end in fresh processes on
the CPU: each format's files, JSONL from a ``.pt2`` and a ``.onnx``
against the infer CLI on the checkpoint, the infer CLI given an export
directory or a ``.pth``, and the refusals."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from glow_tts_train_tpu_torch import checkpoint, export
from glow_tts_train_tpu_torch.models import hyper_from_config

from helpers import tiny_config

STDIN = "3 7 12 5 9 14 2\n4 8 2\n11 1 19 6 13 3 8 15 2 10\n"
# the artifacts and the live plain graph, f32 on the CPU
# (tests/test_onnx_export.py's bound for the ONNX executor)
MEL_ATOL = 2e-4


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def _run(module, *args, stdin=STDIN):
    return subprocess.run(
        [sys.executable, "-m", module, *map(str, args)],
        input=stdin, capture_output=True, text=True, env=_env(), timeout=300,
    )


def _mels(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [np.asarray(json.loads(line)["mel"], np.float32)
            for line in proc.stdout.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One checkpoint (with Adam state), exported in each format by the
    CLI in-process -> (tmp dir, checkpoint, config path, {format: dir})."""
    tmp = tmp_path_factory.mktemp("export_cli")
    config = tiny_config()
    hp = hyper_from_config(config)
    flat = checkpoint.random_params(hp, 4)
    ckpt = tmp / "checkpoint_9.npz"
    params = {k[len("model/"):]: torch.from_numpy(v) for k, v in flat.items()}
    from glow_tts_train_tpu_torch.optimize import adam_init

    opt = adam_init(params)
    opt = opt._replace(count=8)
    checkpoint.save_checkpoint(params, ckpt, 9, 0.5, 1, opt, config.scheduler)
    cfg = tmp / "config.json"
    with open(cfg, "w") as f:
        config.save(f)
    dirs = {}
    for fmt in ("pt2", "onnx", "torch"):
        dirs[fmt] = tmp / fmt
        export.main([str(ckpt), str(dirs[fmt]), "--config", str(cfg), "--format", fmt,
                     "--platform", "cpu", "--max-text-length", "16", "--max-frames", "96"])
    return tmp, ckpt, cfg, dirs


@pytest.fixture(scope="module")
def live_mels(exports):
    _, ckpt, cfg, _ = exports
    return _mels(_run("glow_tts_train_tpu_torch.infer", ckpt, "--config", cfg,
                      "--platform", "cpu", "--noise-scale", "0"))


def test_export_writes_each_format(exports):
    """pt2 and onnx: the artifact, config.json and export_meta.json (format,
    budgets, global step, no speaker); torch: generator.pth and
    config.json, the pth holding the reference's keys and the Adam state
    at count 8."""
    _, _, _, dirs = exports
    names = {"pt2": export.ARTIFACT_NAME, "onnx": export.ONNX_NAME, "torch": export.TORCH_NAME}
    for fmt, name in names.items():
        files = sorted(p.name for p in dirs[fmt].iterdir())
        want = [name, "config.json"] + ([export.META_NAME] if fmt != "torch" else [])
        assert files == sorted(want), (fmt, files)
    for fmt in ("pt2", "onnx"):
        meta = json.loads((dirs[fmt] / export.META_NAME).read_text())
        assert meta == {"format": fmt, "max_text_length": 16, "max_frames": 96,
                        "global_step": 9, "speaker": None}
    pth = torch.load(dirs["torch"] / export.TORCH_NAME, weights_only=True)
    config = tiny_config()
    assert list(pth["model"]) == checkpoint.reference_param_order(config)
    assert (pth["global_step"], pth["learning_rate"], pth["version"]) == (9, 0.5, 1)
    assert {float(s["step"]) for s in pth["optimizer"]["state"].values()} == {8.0}


@pytest.mark.parametrize("fmt", ["pt2", "onnx"])
def test_infer_export_jsonl_matches_live(exports, live_mels, fmt):
    """infer_export --platform cpu at noise 0 gives the infer CLI's mels on
    the checkpoint (same lengths, within 2e-4), one JSONL line each; the log
    names where and through what the artifact ran."""
    _, _, _, dirs = exports
    proc = _run("glow_tts_train_tpu_torch.infer_export", dirs[fmt], "--platform", "cpu",
                "--noise-scale", "0")
    mels = _mels(proc)
    assert len(mels) == len(live_mels) == 3
    for got, want in zip(mels, live_mels):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)
    assert ("on cpu" if fmt == "pt2" else "on the host through") in proc.stderr
    assert json.loads(proc.stdout.splitlines()[0])["audio"]["mel_channels"] == 8


def test_infer_takes_an_export_directory(exports, live_mels, tmp_path):
    """The infer CLI given an export directory runs its artifact (here the
    .pt2, --csv into --numpy-dir) and warns that --batch-size is ignored;
    the .onnx file itself is taken by infer_export."""
    _, _, _, dirs = exports
    stdin = "".join(f"u{i}|{line}\n" for i, line in enumerate(STDIN.splitlines()))
    proc = _run("glow_tts_train_tpu_torch.infer", dirs["pt2"], "--platform", "cpu",
                "--noise-scale", "0", "--csv", "--numpy-dir", tmp_path / "mels",
                "--batch-size", "2", stdin=stdin)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--batch-size is ignored" in proc.stderr
    for i, want in enumerate(live_mels):
        np.testing.assert_allclose(np.load(tmp_path / "mels" / f"u{i}.npy"), want, rtol=0,
                                   atol=MEL_ATOL)
    mels = _mels(_run("glow_tts_train_tpu_torch.infer_export", dirs["onnx"] / export.ONNX_NAME,
                      "--platform", "cpu", "--noise-scale", "0"))
    for got, want in zip(mels, live_mels):
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)


def test_infer_serves_the_exported_pth(exports):
    """The infer CLI serves the exported generator.pth with the same mels
    as the .npz bit for bit (noise on: the same draws)."""
    _, ckpt, cfg, dirs = exports
    a = _mels(_run("glow_tts_train_tpu_torch.infer", ckpt, "--config", cfg, "--platform", "cpu"))
    b = _mels(_run("glow_tts_train_tpu_torch.infer", dirs["torch"] / export.TORCH_NAME,
                   "--config", cfg, "--platform", "cpu"))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_text_past_the_budget_is_cut(exports):
    """A .pt2 cuts a text longer than its budget to it, with a warning, and
    still answers."""
    _, _, _, dirs = exports
    proc = _run("glow_tts_train_tpu_torch.infer_export", dirs["pt2"], "--platform", "cpu",
                stdin=" ".join(["3"] * 20) + "\n")
    assert len(_mels(proc)) == 1
    assert "longer than export budget (20 > 16); truncating" in proc.stderr


def _has_gpu() -> bool:
    probe = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                           capture_output=True, text=True, env=_env(), timeout=120)
    return probe.stdout.strip() == "True"


@pytest.mark.parametrize("case", ["savedmodel", "speaker_with_directory", "infer_export_cuda",
                                  "export_cuda", "not_an_artifact"])
def test_refusals(exports, case):
    """savedmodel exits 2 naming TensorFlow; --speaker with an export
    directory exits 2; --platform cuda (the default of both CLIs) without a
    GPU exits 2 with "no CUDA device" and writes nothing; a directory with
    no artifact exits 2."""
    tmp, ckpt, cfg, dirs = exports
    if case == "savedmodel":
        proc = _run("glow_tts_train_tpu_torch.export", ckpt, tmp / "sm", "--config", cfg,
                    "--format", "savedmodel", "--platform", "cpu")
        want = "TensorFlow"
    elif case == "speaker_with_directory":
        proc = _run("glow_tts_train_tpu_torch.infer", dirs["pt2"], "--platform", "cpu",
                    "--speaker", "1")
        want = "--speaker is baked into exported artifacts"
    elif case == "infer_export_cuda":
        if _has_gpu():
            pytest.skip("a GPU is present: --platform cuda runs")
        proc = _run("glow_tts_train_tpu_torch.infer_export", dirs["pt2"])
        want = "no CUDA device"
    elif case == "export_cuda":
        if _has_gpu():
            pytest.skip("a GPU is present: --platform cuda runs")
        proc = _run("glow_tts_train_tpu_torch.export", ckpt, tmp / "cuda", "--config", cfg)
        want = "no CUDA device"
    else:
        (tmp / "empty").mkdir(exist_ok=True)
        proc = _run("glow_tts_train_tpu_torch.infer", tmp / "empty", "--platform", "cpu")
        want = "holds no generator.pt2 or generator.onnx"
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert want in proc.stderr
    assert proc.stdout.strip() == ""
    assert not (tmp / "sm").exists() and not (tmp / "cuda").exists()

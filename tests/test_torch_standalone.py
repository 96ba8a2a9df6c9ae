"""glow_tts_train_tpu_torch stands alone: it imports nothing of jax or of
the JAX package, and its own copies of the configuration schema and of
the host-side data pipeline behave as the JAX package's do (one JSON file
configures both; one corpus and seed give the same batches)."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from glow_tts_train_tpu import config as jax_config
from glow_tts_train_tpu import data as jax_data
from glow_tts_train_tpu_torch import config as port_config
from glow_tts_train_tpu_torch import data as port_data

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """A fresh process imports every module of the port and runs its four
    CLIs' --help (train, infer, export, infer_export); sys.modules then
    holds no jax* and no glow_tts_train_tpu or glow_tts_train_tpu.* key."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import glow_tts_train_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for want in ('config', 'data.dataset', 'data.corpus', 'utils.stdio', 'ops.text_cuda',\n"
        "             'ops.wn_cuda', 'ops.block_cuda', 'ops.flows', 'models.glow_tts', 'training',\n"
        "             'export', 'infer_export', 'onnx.proto', 'onnx.builder', 'onnx.check',\n"
        "             'onnx.runtime', 'onnx.export'):\n"
        "    assert pkg.__name__ + '.' + want in names, (want, names)\n"
        "from glow_tts_train_tpu_torch import __main__ as train_cli, export, infer, infer_export\n"
        "for main in (train_cli.main, infer.main, export.main, infer_export.main):\n"
        "    try:\n"
        "        main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'glow_tts_train_tpu' or m.startswith('glow_tts_train_tpu.'))\n"
        "print(len(names), bad, file=sys.stderr)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=_env(),
        timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-1000:] + proc.stderr[-2000:]
    assert proc.stdout.count("--platform") >= 4
    for prog in ("glow-tts-export-torch", "glow-tts-infer-export-torch"):
        assert prog in proc.stdout


@pytest.mark.parametrize(
    "name", sorted(p.name for p in (REPO / "glow_tts_train_tpu" / "onnx").glob("*.py"))
)
def test_onnx_copy_equals_the_original(name):
    """Each module of the port's ``onnx/`` is the JAX package's, with only
    the package name changed (in logger names and doc strings)."""
    original = (REPO / "glow_tts_train_tpu" / "onnx" / name).read_text()
    copy = (REPO / "glow_tts_train_tpu_torch" / "onnx" / name).read_text()
    assert copy == original.replace("glow_tts_train_tpu", "glow_tts_train_tpu_torch")


@pytest.mark.parametrize(
    "path",
    ["chip_smoke.py", "tests/test_torch_cuda.py"]
    + sorted(str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("torch-*.py"))
    + sorted(str(p.relative_to(REPO)) for p in (REPO / "glow_tts_train_tpu_torch").rglob("*.py")),
)
def test_source_names_no_jax_import(path):
    """No import statement of the port's sources, its GPU smoke script, its
    GPU test file or its measurement scripts names jax or the JAX package
    (any depth: lazy imports inside functions count)."""
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "glow_tts_train_tpu", "helpers")]
    assert not bad, bad


def test_load_config_matches_the_jax_package(tmp_path):
    """``dataclasses.asdict`` of both packages' load of configs/base.json
    plus an override file is equal, field for field, and so are the bare
    defaults and a save/load round trip."""
    override = tmp_path / "override.json"
    override.write_text(json.dumps({
        "encoder_fuse": False, "fp16_run": False, "betas": [0.8, 0.9], "wn_residuals": "store",
        "model": {"num_symbols": 77, "block_length": 5, "prenet": False},
        "audio": {"mel_fmax": None, "hop_length": 200}, "not_a_field": 1,
    }))
    paths = [REPO / "configs" / "base.json", override]
    ours = port_config.load_config(paths)
    theirs = jax_config.TrainingConfig.load_and_merge(jax_config.TrainingConfig(), paths)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.encoder_fuse is False and ours.model.block_length == 5 and ours.betas == (0.8, 0.9)
    assert dataclasses.asdict(port_config.TrainingConfig()) == dataclasses.asdict(
        jax_config.TrainingConfig())
    assert [f.name for f in dataclasses.fields(port_config.TrainingConfig)] == [
        f.name for f in dataclasses.fields(jax_config.TrainingConfig)]
    saved = tmp_path / "saved.json"
    with open(saved, "w") as f:
        ours.save(f)
    with open(saved) as f:
        assert dataclasses.asdict(jax_config.TrainingConfig.load(f)) == dataclasses.asdict(ours)


def _corpus(tmp_path, n=37):
    rng = np.random.default_rng(0)
    mels = tmp_path / "mels"
    mels.mkdir()
    with open(tmp_path / "phonemes.csv", "w") as f:
        for i in range(n):
            k = int(rng.integers(3, 30))
            f.write(f"u{i:03d}|{' '.join(map(str, rng.integers(1, 40, k)))}\n")
            mel = rng.standard_normal((8, int(rng.integers(2 * k + 2, 120)))).astype(np.float32)
            np.save(mels / f"u{i:03d}.npy", mel)
    return tmp_path / "phonemes.csv", mels


@pytest.mark.parametrize("batch_size,seed", [(4, 1234), (8, 7)])
def test_data_pipeline_yields_the_jax_packages_batches(tmp_path, batch_size, seed):
    """From one synthetic corpus and seed both packages' pipelines give the
    same batches over two epochs: keys, ids, lengths, mels, bucket shapes
    and order; and the same symbol count and batches per epoch."""
    phonemes, mels = _corpus(tmp_path)
    batches = []
    for data, cfg in ((port_data, port_config), (jax_data, jax_config)):
        config = cfg.TrainingConfig(
            seed=seed, batch_size=batch_size, bucket_size_text=8, bucket_size_mel=16,
            audio=cfg.AudioConfig(mel_channels=8), model=cfg.ModelConfig(num_symbols=0),
            min_seq_length=4, max_seq_length=28,
        )
        dataset = data.build_dataset(
            [data.SpeakerSource(0, phonemes, mels)], config, mels_are_dirs=True,
            skip_missing_mels=False, multispeaker=False,
        )
        pipeline = data.DataPipeline(dataset, config, batch_size=batch_size)
        epochs = [list(pipeline.batches()) for _ in range(2)]
        batches.append((data.detect_num_symbols(dataset), len(pipeline), epochs))
    (sym_p, len_p, ep_p), (sym_j, len_j, ep_j) = batches
    assert sym_p == sym_j and len_p == len_j > 1
    shapes = set()
    for e_p, e_j in zip(ep_p, ep_j):
        assert len(e_p) == len(e_j) == len_p
        for b_p, b_j in zip(e_p, e_j):
            assert sorted(b_p) == sorted(b_j)
            for k in b_j:
                a, b = np.asarray(b_p[k]), np.asarray(b_j[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            assert b_p["x"].shape[1] % 8 == 0 and b_p["y"].shape[1] % 16 == 0
            shapes.add((b_p["x"].shape, b_p["y"].shape))
    assert len(shapes) > 1  # more than one bucket was exercised
    assert any(  # epochs reshuffle
        a["x"].shape != b["x"].shape or not np.array_equal(a["x"], b["x"])
        for a, b in zip(ep_p[0], ep_p[1])
    )

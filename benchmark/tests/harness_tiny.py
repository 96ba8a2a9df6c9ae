"""Tiny cells for the harness's CPU tests: the shipped configurations at a
width and a corpus a test run can hold, and helpers that drive them."""

import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)

TRAIN_TRAFFIC = {"driver": "train", "utterances": 48, "phonemes": [5, 12],
                 "frames_per_phoneme": [3, 9], "symbols": 20, "speakers": 1, "batch_size": 8,
                 "ranks": 1}
SYNTH_TRAFFIC = {"driver": "synth", "batch": 4, "phonemes": [5, 12], "symbols": 20,
                 "noise_scale": 0.333, "length_scale": 1.0, "greedy_every": 2,
                 "traced_seconds": 1, "checked_calls": 48}


def tiny_config(directory: Path, name: str = "base", fp16: bool = False) -> Path:
    """``configs/<name>.json`` at h 16, 2 flow blocks of 2 WN layers, 8 mels."""
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    speakers = cfg["model"]["n_speakers"]
    cfg["model"].update(num_symbols=20, hidden_channels=16, filter_channels=32,
                        filter_channels_dp=16, n_blocks_dec=2, n_layers_enc=2, n_block_layers=2,
                        hidden_channels_enc=16, hidden_channels_dec=16)
    if speakers > 1:
        cfg["model"].update(n_speakers=5, gin_channels=8)
    cfg["audio"]["mel_channels"] = 8
    cfg["fp16_run"] = fp16
    cfg["bucket_size_text"], cfg["bucket_size_mel"] = 8, 16
    path = directory / f"tiny_{name}{'_bf16' if fp16 else ''}.json"
    path.write_text(json.dumps(cfg))
    return path


def context(config_path: Path, traffic: dict, seed: int = 2 ** 31 + 77, seconds: float = 0.5,
            window: bool = True):
    import torch

    from harness import launch

    return launch.Context("tiny", config_path, traffic, seed, seconds, False,
                          torch.device("cpu"), t0=time.perf_counter(), window=window)


def drive_and_check(ctx):
    """One run of a tiny cell on the CPU -> (record, readings)."""
    from harness import launch

    record, probe = launch.drive(ctx)
    return record, launch.check(ctx, record, probe)


def correct(readings: dict, workload: str) -> bool:
    """``correct`` by the cell's own limits, as a run decides it."""
    from harness import checks, launch

    return launch.verdict(readings, checks.limits_of(BENCH_DIR, workload))

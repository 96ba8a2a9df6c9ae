#!/usr/bin/env python3
"""Train-step time of glow_tts_train_tpu_torch on one GPU with the text
side through its kernels (``encoder_fuse: true``) against the op-by-op
text side (``encoder_fuse: false``), in one process on one card.

    python scripts/torch-train-step-ab.py [--rounds 4] [--steps 12]

Base width (``configs/base.json``, ``fp16_run: false``), batch 16, dropout
on, the four batch shapes of a 64-utterance synthetic corpus
(``scripts/make-synthetic-corpus.py``).  Both variants start from the same
fresh init (DDI on the first batch) and see the same batches.  They run in
turns (fused, plain, plain, fused, ...), ``--steps`` steps a turn after 3
warm-up steps, wall time per step with a device sync on each side; then one
step of each on the largest batch under ``torch.profiler`` for the device's
busy time and its count of device operations.  Prints one JSON object with
every step time, the medians per turn and the profiled steps, and the GPU's
name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=4, help="rounds of fused, plain, plain, fused")
    parser.add_argument("--steps", type=int, default=12, help="timed steps per turn")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from glow_tts_train_tpu_torch import data, kernels, training
    from glow_tts_train_tpu_torch.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    with tempfile.TemporaryDirectory(prefix="train_ab_") as tmp:
        corpus = Path(tmp) / "corpus"
        subprocess.run(
            [sys.executable, str(REPO / "scripts" / "make-synthetic-corpus.py"), str(corpus), "64", "0"],
            check=True, capture_output=True,
        )
        manifest = json.loads((corpus / "manifest.json").read_text())
        over = Path(tmp) / "over.json"
        over.write_text(json.dumps({
            "fp16_run": False, "batch_size": 16, "warmup_steps": 50,
            "model": {"num_symbols": manifest["num_symbols"]},
        }))
        config = load_config([REPO / "configs" / "base.json", over])
        dataset = data.build_dataset(
            [data.SpeakerSource(0, corpus / "phonemes.csv", corpus / "mels")], config,
            mels_are_dirs=True, skip_missing_mels=False, multispeaker=False,
        )
        pipeline = data.DataPipeline(dataset, config, batch_size=config.batch_size)
        batches = [training.batch_to(b, "cuda") for b in pipeline.batches()]

    variants = {}
    for name, fuse in (("fused", True), ("plain", False)):
        config.encoder_fuse = fuse
        state = training.TrainState(training.initialize_model(config, batches[0], "cuda"))
        variants[name] = {
            "step": training.make_train_step(config), "state": state,
            "generator": torch.Generator(device="cuda").manual_seed(config.seed),
            "seeds": torch.Generator().manual_seed(config.seed),
            "n": 0, "turns": [],
        }

    def run_step(v, batch):
        torch.cuda.synchronize()
        start = time.perf_counter()
        v["step"](v["state"], batch, v["generator"], v["seeds"])
        torch.cuda.synchronize()
        v["n"] += 1
        return (time.perf_counter() - start) * 1e3

    for v in variants.values():
        for i in range(3):
            run_step(v, batches[i % len(batches)])
    for _ in range(args.rounds):  # each round gives every variant two turns
        for name in ("fused", "plain", "plain", "fused"):
            v = variants[name]
            v["turns"].append([run_step(v, batches[i % len(batches)]) for i in range(args.steps)])

    largest = max(batches, key=lambda b: b["y"].shape[1])
    out = {"gpu": gpu, "batch_shapes": [[list(b["x"].shape), list(b["y"].shape)] for b in batches],
           "steps_per_turn": args.steps, "variants": {}}
    for name, v in variants.items():
        run_step(v, largest)
        before = kernels.launch_counts()
        unprofiled = run_step(v, largest)
        after = kernels.launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run_step(v, largest)
        busy, ops = 0.0, 0
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                busy += e.self_device_time_total / 1e3
                ops += e.count
        medians = [statistics.median(t) for t in v["turns"]]
        out["variants"][name] = {
            "turn_median_ms": medians, "median_of_turns_ms": statistics.median(medians),
            "all_steps_ms": v["turns"],
            "largest_batch": [list(largest["x"].shape), list(largest["y"].shape)],
            "largest_batch_step_ms": unprofiled, "profiled_wall_ms": wall,
            "device_busy_ms": busy, "device_operations": ops,
            "idle_share_unprofiled": 1.0 - busy / unprofiled,
            "kernel_launches_per_step": {k: after[k] - before[k] for k in after if after[k] != before[k]},
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""MAS (rows 16-18 of PERF.md's table) of one checkout of
glow_tts_train_tpu_torch on one GPU, as one JSON object.

    python scripts/torch-mas-probe.py [--repo DIR]

To compare two commits on one card, unpack the other one beside this
checkout (``git archive <commit> | tar -x -C DIR``) and run the script once
per tree in turns, in one shell command: parent, change, change, parent.
``--repo`` names the checkout whose package is imported and whose kernels
are built (default: the one this file lies in).

Shapes: the training shape [16, 192, 1408] (ragged lengths from a numpy
seed, as a bucket of the synthetic corpus gives them), [2, 400, 2600], and
the texts past the short path's ring: [2, 1344, 1400], [2, 1345, 1400],
[2, 2600, 2700] and [1, 4096, 4200] (sample 0 full, sample 1 ragged).  Each
is timed with CUDA events (median of 30 calls after 5) and held to the
plain version (``maximum_path_plain``) on the same inputs, bit for bit; a
shape the tree refuses reads ``"refused"``.  Prints the GPU's name and
power limit with the numbers.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPES = ((16, 192, 1408), (2, 400, 2600), (2, 1344, 1400), (2, 1345, 1400),
          (2, 2600, 2700), (1, 4096, 4200))


def event_ms(fn, runs: int = 30) -> float:
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(shape, seed: int):
    """logp [b, t_x, t_y] (N(0, 3^2)) and a rectangular mask per sample:
    sample 0 full, the others ragged with t_y >= t_x."""
    import numpy as np
    import torch

    b, t_x, t_y = shape
    rng = np.random.default_rng(seed)
    logp = rng.standard_normal(shape).astype(np.float32) * 3
    mask = np.zeros(shape, np.float32)
    mask[0] = 1.0
    for i in range(1, b):
        tx = int(rng.integers(t_x // 2, t_x + 1))
        ty = int(rng.integers(tx, t_y + 1))
        mask[i, :tx, :ty] = 1.0
    return torch.from_numpy(logp).cuda(), torch.from_numpy(mask).cuda()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE)
    args = parser.parse_args()
    sys.path.insert(0, str(args.repo.resolve()))
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.ops import mas_cuda

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kernels.library()
    rows = {}
    for i, shape in enumerate(SHAPES):
        logp, mask = inputs(shape, i)
        key = "x".join(map(str, shape))
        try:
            path = mas_cuda.maximum_path(logp, mask)
        except ValueError as err:
            rows[key] = {"refused": str(err)}
            continue
        plain = mas_cuda.maximum_path_plain(logp, mask)
        rows[key] = {
            "equal": bool(torch.equal(path, plain)),
            "ms": event_ms(lambda: mas_cuda.maximum_path(logp, mask)),
            "device_words": kernels.mas_bits_words(*shape, logp.device),
        }
    print(json.dumps({"repo": str(args.repo), "gpu": gpu, "mas": rows}))
    return 0 if all(r.get("equal", True) for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

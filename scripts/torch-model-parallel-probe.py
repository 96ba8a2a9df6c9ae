#!/usr/bin/env python3
"""The ``model parallel`` phase of ``chip_smoke.py`` alone
(``chip_smoke.model_parallel_phase``): two ranks on card 0 over gloo as
one model group (``--model-parallel 2``) against the same ranks'
data-parallel steps, bit for bit (f32 with DDI, bf16 as shipped), then
the train CLI through ``python -m torch.distributed.run --nproc-per-node
2 ... --model-parallel 2`` and a one-process resume from its checkpoint.

    python scripts/torch-model-parallel-probe.py [--cards N]

``--cards N`` (N > 1 and even, a machine with N GPUs): both with a rank a
card over NCCL, model groups of 2.

Prints the card's name and power limit, the kernels' build time, the
phase's lines and ``{"model_parallel": {...}}``; exits non-zero where the
phase fails.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cards", type=int, default=1)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch-model-parallel-probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from glow_tts_train_tpu_torch import kernels

    device_line = chip_smoke.gpu_line()
    print(device_line, torch.__version__, torch.version.cuda, torch.cuda.device_count())
    start = time.perf_counter()
    kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="mp_probe_") as workdir:
        row = chip_smoke.model_parallel_phase(
            Path(workdir), REPO, REPO / "configs" / "base.json", device_line, args.cards
        )
    print(json.dumps({"model_parallel": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

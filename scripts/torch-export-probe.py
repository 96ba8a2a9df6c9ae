#!/usr/bin/env python3
"""The export phase of ``chip_smoke.py`` alone, on one GPU: a checkpoint
of ``configs/base.json`` at full width with random non-zero weights from a
numpy seed (``chip_smoke.make_checkpoint``: no training, no Adam state)
through the export CLI's three formats, and what serves them held against
the live kernel path (``chip_smoke.export_phase``), as one JSON line.

    python scripts/torch-export-probe.py

Prints the card's name and power limit, the kernels' build time, the
phase's lines and ``{"export": {...}}``; exits non-zero where the phase
fails.  Takes about 3 minutes, the build included.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch-export-probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from glow_tts_train_tpu_torch import kernels

    device_line = chip_smoke.gpu_line()
    print(device_line, torch.__version__, torch.version.cuda)
    start = time.perf_counter()
    kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config_path = REPO / "configs" / "base.json"
    with tempfile.TemporaryDirectory(prefix="export_probe_") as workdir:
        ckpt, _, _ = chip_smoke.make_checkpoint(Path(workdir), config_path)
        row = chip_smoke.export_phase(Path(workdir), REPO, ckpt, config_path, device_line)
    print(json.dumps({"export": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

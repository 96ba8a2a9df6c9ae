#!/usr/bin/env python3
"""The ``widths`` and ``text op by op bf16`` phases of ``chip_smoke.py``
alone, on one GPU: ``configs/large.json`` and ``configs/multispeaker.json``
trained as shipped through the train CLI and served through the infer CLI
(``chip_smoke.width_phase``), and bf16 training with the text side op by
op (``chip_smoke.text_ops_bf16_phase``), as JSON lines.

    python scripts/torch-widths-probe.py [--phase widths|text_ops|all]
        [--config large|multispeaker ...]

Prints the card's name and power limit, the kernels' build time, the
phases' lines, ``{"widths": {...}}`` and ``{"text_ops_bf16": {...}}``;
exits non-zero where a phase fails.
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
    parser.add_argument("--phase", choices=("widths", "text_ops", "all"), default="all")
    parser.add_argument("--config", action="append", choices=("large", "multispeaker"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch-widths-probe: no CUDA device available", file=sys.stderr)
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
    with tempfile.TemporaryDirectory(prefix="widths_probe_") as workdir:
        workdir = Path(workdir)
        if args.phase in ("widths", "all"):
            rows = {}
            for name in args.config or chip_smoke.WIDTH_CONFIGS:
                start = time.perf_counter()
                rows[name] = chip_smoke.width_phase(workdir, REPO, name, device_line)
                print(f"widths {name}: phase {time.perf_counter() - start:.1f} s")
            print(json.dumps({"widths": rows}))
        if args.phase in ("text_ops", "all"):
            start = time.perf_counter()
            row = chip_smoke.text_ops_bf16_phase(workdir, REPO, device_line)
            print(f"text op by op bf16: phase {time.perf_counter() - start:.1f} s")
            print(json.dumps({"text_ops_bf16": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The serving flow block's products on one GPU, every way the tensor-core
conv-GEMM can take them, as one JSON object: the evidence behind the
serving chain's plan (``ops/tc_gemm.py`` ``inverse_product_plan``).

    python scripts/torch-serve-plan-sweep.py [--repo DIR]

At each batch shape the serving path gives the block ([1, 160] a
48-phoneme request, [1, 832] a 250-phoneme one, [4, 832] and [8, 544]) and
each of its products at base width (start [., 80, 192], the in-layer conv
[., 960, 384], res/skip [., 192, 384], end [., 192, 160], the folded A [.,
160, 160]): the device's own time (torch.profiler, mean of 20 calls; the
weights' split and split-K's second pass included, as
``tc_gemm.conv_product_tiled`` runs them) on the tensor cores in 128- and
64-row tiles with 1 to 8 K shares, the CUDA-core kernel's
(``mode="core"``), and what the serving plan takes (``mode="serve"``, the
weights split in the same call), and the weights' split alone.  Prints the GPU's name and power limit
with the numbers.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPES = {"b1_48": (1, 160), "b1_250": (1, 832), "b4": (4, 832), "b8": (8, 544)}
PRODUCTS = {  # name: (c_in, taps, n)
    "start": (80, 1, 192), "in_conv": (192, 5, 384), "res_skip": (192, 1, 384),
    "end": (192, 1, 160), "fold_a": (160, 1, 160),
}
SHARES = (1, 2, 3, 4, 5, 6, 8)


def device_us(fn, runs: int = 20) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in events) / runs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE, help="the checkout to measure")
    args = parser.parse_args()
    sys.path.insert(0, str(args.repo.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    from glow_tts_train_tpu_torch.ops import tc_gemm

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    out = {"gpu": gpu, "sms": sms, "products": []}
    for case, (batch, t) in SHAPES.items():
        for name, (c_in, taps, n) in PRODUCTS.items():
            a = torch.from_numpy(rng.standard_normal((batch, t, c_in)).astype(np.float32)).cuda()
            w = torch.from_numpy(
                (rng.standard_normal((taps * c_in, n)) / np.sqrt(taps * c_in)).astype(np.float32)
            ).cuda()
            slices = -(-taps * c_in // 32)
            row = {"case": case, "name": name, "shape": [batch * t, taps * c_in, n],
                   "plan": tc_gemm.inverse_product_plan(batch * t, taps * c_in, n, sms),
                   "core_us": device_us(lambda: tc_gemm.conv_product(a, w, taps, mode="core")),
                   "serve_us": device_us(lambda: tc_gemm.conv_product(a, w, taps, mode="serve")),
                   # the weights' split alone, which every tensor-core time here includes
                   # and the serving chain makes once at load
                   "split_us": device_us(lambda: tc_gemm.split_weights(w)),
                   "tiled_us": {}}
            for tile_rows in (128, 64):
                for shares in SHARES:
                    if shares > slices:
                        continue
                    row["tiled_us"][f"{tile_rows}x{shares}"] = device_us(
                        lambda: tc_gemm.conv_product_tiled(a, w, taps, tile_rows, shares))
            best = min(row["tiled_us"], key=row["tiled_us"].get)
            out["products"].append(row)
            print(f"{case} {name} {row['shape']}: plan {row['plan']} {row['serve_us']:.1f} us, "
                  f"core {row['core_us']:.1f} us, best tiled {best} {row['tiled_us'][best]:.1f} us "
                  f"[{gpu}]", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

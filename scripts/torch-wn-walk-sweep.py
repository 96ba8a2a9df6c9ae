#!/usr/bin/env python3
"""The WN reverse walk's products on one GPU in each candidate mode, as one
JSON object a line: what chose the walk's plan (``tc_gemm.walk_products``).

    python scripts/torch-wn-walk-sweep.py [--repo DIR]

At the training shape [16, 704, h] (11,264 rows) at base width (h 192)
and large width (h 256), 5 taps:

* the transposed conv sum_k d_xin[t - off_k] W_k^T [11264, 5 * 2h -> h]
  (``tc_gemm.conv_product_walk``): tap-staged (A staged once a channel
  slice for all taps) and tap by tap, each in 128- and 64-row tiles, at
  dilation 1 and 4; and as the walk's plan takes it (``mode="walk"``);
* dW_in [5h + 1, 11264, 2h] with its bias row, reading d_xin raw (the
  kernel transposes and splits each slice) and reading its K-major split
  (``weight_gradient(..., dy_split=)``), and without the bias row;
* dW_rs [h + 1, 11264, 2h] with and without its bias row.

Each is timed by the device's own time under torch.profiler (mean of 20
calls, the weights' split included where the mode splits them) and by
CUDA events (median of 30 after 5), and held against float64 of the same
operands (max abs error over max |ref|).  Prints the GPU's name and power
limit with the numbers.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


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


def device_us(fn, runs: int = 20) -> tuple:
    """(the device's own time for one call in us, by kernel name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by = {e.key[:60]: e.self_device_time_total / runs for e in prof.key_averages()
          if e.device_type.name == "CUDA"}
    return sum(by.values()), by


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

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(9)
    batch, t, taps = 16, 704, 5
    rows = batch * t

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    def report(**row):
        row["gpu"] = gpu
        print(json.dumps(row), flush=True)

    def held(name, got, ref):
        err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
        if not err <= 5e-6:
            raise SystemExit(f"{name}: max abs err {err} of max |ref| against float64")
        return err

    for h in (192, 256):
        d_xin = randn(batch, t, 2 * h)
        w_in = randn(taps * h, 2 * h, scale=(taps * h) ** -0.5)
        flops = 2.0 * rows * taps * 2 * h * h
        bound_us = flops / (495e12 / 3) * 1e6
        for dilation in (1, 4):
            b = tc_gemm.transposed_weights_plain(w_in, taps)
            ref = (tc_gemm.im2col_plain(d_xin, taps, dilation, -1).double() @ b.double())
            plan = tc_gemm.walk_transposed_plan(rows, 2 * h, h, taps, dilation, sms)
            cases = [(f"{'tap_staged' if staged else 'tap_by_tap'}_{tile}", lambda s=staged, tl=tile:
                      tc_gemm.conv_product_walk(d_xin, w_in, taps, dilation, tl, s))
                     for staged in (True, False) for tile in (128, 64)]
            cases.append(("walk_plan", lambda: tc_gemm.conv_product(
                d_xin, w_in, taps, dilation, -1, mode="walk", w_t=True)))
            for name, fn in cases:
                err = held(f"transposed conv {name}", fn(), ref)
                us, by = device_us(fn)
                report(product="transposed_conv", h=h, dilation=dilation, mode=name,
                       shape=[rows, taps * 2 * h, h], device_us=us, events_ms=event_ms(fn),
                       tflops=flops / us / 1e6, bound_us=bound_us, max_rel_err=err,
                       plan=plan["mode"], by_kernel=by)

        xs = randn(batch, t, h)
        dy_split = tc_gemm.split_weights(d_xin.reshape(rows, 2 * h))
        cols = tc_gemm.im2col_plain(xs, taps, 1).reshape(rows, -1).double()
        ref = cols.T @ d_xin.reshape(rows, 2 * h).double()
        flops = 2.0 * rows * taps * h * 2 * h
        for name, fn in (
            ("raw_bias", lambda: tc_gemm.weight_gradient(xs, d_xin, taps, bias=True)),
            ("split_dy_bias", lambda: tc_gemm.weight_gradient(xs, d_xin, taps, bias=True,
                                                              dy_split=dy_split)),
            ("raw", lambda: tc_gemm.weight_gradient(xs, d_xin, taps)),
        ):
            out = fn()
            err = held(f"dW_in {name}", out[0] if isinstance(out, tuple) else out, ref)
            us, by = device_us(fn)
            report(product="dW_in", h=h, mode=name, shape=[taps * h, rows, 2 * h],
                   device_us=us, events_ms=event_ms(fn), tflops=flops / us / 1e6,
                   bound_us=flops / (495e12 / 3) * 1e6, max_rel_err=err, by_kernel=by)

        acts = randn(batch, t, h)
        g_rs = randn(batch, t, 2 * h)
        ref = acts.reshape(rows, h).double().T @ g_rs.reshape(rows, 2 * h).double()
        flops = 2.0 * rows * h * 2 * h
        for name, fn in (
            ("bias", lambda: tc_gemm.weight_gradient(acts, g_rs, bias=True)),
            ("raw", lambda: tc_gemm.weight_gradient(acts, g_rs)),
        ):
            out = fn()
            err = held(f"dW_rs {name}", out[0] if isinstance(out, tuple) else out, ref)
            us, by = device_us(fn)
            report(product="dW_rs", h=h, mode=name, shape=[h, rows, 2 * h], device_us=us,
                   events_ms=event_ms(fn), tflops=flops / us / 1e6,
                   bound_us=max(flops / (495e12 / 3), 4 * rows * 3 * h / 3.35e12) * 1e6,
                   max_rel_err=err, by_kernel=by)
    print(json.dumps({"done": True, "gpu": gpu, "sms": sms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The WN forward chains' products on one GPU in each candidate kernel, as
one JSON object a line: what chose the forward's plan
(``tc_gemm.forward_products``).

    python scripts/torch-wn-fwd-sweep.py [--repo DIR] [--check]

The in-layer conv im2col(x) @ W_in [rows, 5h -> 2h] (``tc_gemm.
conv_product_fwd``) at [16, 704, 192] (11,264 rows), [16, 576, 192] (the
DDI batch) and [16, 704, 256] (large width), at dilation 1 (and 4 at base
width), with the bare epilogue and with the gate's (tanh(u) sigmoid(v) of
the paired columns); the res/skip product [11264, h -> 2h] at base width.
Candidates: the tap-by-tap walk in 128-row tiles (``conv_gemm_tc_kernel``,
the parent's), the tap-staged kernel (``conv_gemm_tap_kernel``) in 64-row
tiles at 128 and 64 columns, and the TMA-fed kernel
(``conv_gemm_tma_kernel``) in 128- and 64-row tiles in clusters of 1, 2
and 4 row tiles; and as the forward chains' plan takes it (``mode="fwd"``).

Every candidate is held against float64 of the same operands (max abs
error over max |ref| within 5e-6), and the TMA-fed kernel's output against
the tap-staged kernel's bit for bit (the same K order and arithmetic).
``--check`` stops there and times nothing.  Else each is timed by the
device's own time under torch.profiler (mean of 20 calls: ``kernel_us``
without the weights' split launch, ``device_us`` with it) and by CUDA
events (median of 30 after 5).  Prints the GPU's name and power limit with
the numbers.
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
    """(the device's own time for one call in us, the same without the
    weight-split launch, by kernel name).  A trace that holds fewer than
    ``runs`` records of the product's kernels is taken again, up to 4
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        by = {e.key[:70]: e.self_device_time_total / runs for e in events}
        total = sum(by.values())
        product = sum(e.count for e in events if "split_weights" not in e.key)
        if product >= runs:
            return total, total - sum(v for k, v in by.items() if "split_weights" in k), by
    raise RuntimeError(f"no trace of 4 held the {runs} calls' product kernels")


# (name, kernel, tile rows, cluster)
CANDIDATES = (
    ("tap_by_tap_128", "tap_by_tap", 128, 1),
    ("tap_staged_64", "tap_staged", 64, 1), ("tap_staged_64_bn64", "tap_staged_bn64", 64, 1),
    ("tma_128_c1", "tma", 128, 1), ("tma_128_c2", "tma", 128, 2), ("tma_128_c4", "tma", 128, 4),
    ("tma_64_c1", "tma", 64, 1), ("tma_64_c2", "tma", 64, 2), ("tma_64_c4", "tma", 64, 4),
)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repo", type=Path, default=HERE, help="the checkout to measure")
    parser.add_argument("--check", action="store_true", help="hold every candidate, time none")
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
    rng = np.random.default_rng(10)
    taps = 5

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

    def run(product, shape, cases, ref, plan, flops, staged_name, **extra):
        outs = {name: fn() for name, fn in cases}
        staged = outs.get(staged_name)
        for name, fn in cases:
            err = held(f"{product} {shape} {name}", outs[name], ref)
            row = dict(product=product, shape=shape, mode=name, plan=plan, max_rel_err=err,
                       **extra)
            if staged is not None and name.startswith("tma"):
                if not torch.equal(outs[name], staged):
                    raise SystemExit(f"{product} {shape} {name}: bits differ from {staged_name}")
                row["equals_tap_staged"] = True
            if not args.check:
                us, kernel_us, by = device_us(fn)
                row.update(device_us=us, kernel_us=kernel_us, events_ms=event_ms(fn),
                           tflops=flops / kernel_us / 1e6,
                           bound_us=flops / (495e12 / 3) * 1e6, by_kernel=by)
            report(**row)

    for batch, t, h, dilations in ((16, 704, 192, (1, 4)), (16, 576, 192, (1,)),
                                   (16, 704, 256, (1,))):
        rows = batch * t
        x = randn(batch, t, h)
        w_in = randn(taps * h, 2 * h, scale=(taps * h) ** -0.5)
        flops = 2.0 * rows * taps * h * 2 * h
        for dilation in dilations:
            pre = tc_gemm.im2col_plain(x, taps, dilation).double() @ w_in.double()
            plan = tc_gemm.forward_conv_plan(rows, h, 2 * h, taps, dilation, sms)
            for gate in (False, True):
                ref = tc_gemm.gate_plain(pre) if gate else pre
                cases = [(name, lambda k=kernel, tr=tile, cl=cluster, g=gate:
                          tc_gemm.conv_product_fwd(x, w_in, taps, dilation, k, tr, cl, g))
                         for name, kernel, tile, cluster in CANDIDATES]
                if not gate:
                    cases.append(("fwd_plan", lambda: tc_gemm.conv_product(
                        x, w_in, taps, dilation, mode="fwd")))
                run("in_conv", [rows, taps * h, 2 * h], cases, ref, plan["mode"], flops,
                    "tap_staged_64", dilation=dilation, gate=gate)
    # the res/skip product at base width: tap by tap, or the TMA-fed kernel
    rows, h = 16 * 704, 192
    acts = randn(16, 704, h)
    w_rs = randn(h, 2 * h, scale=h ** -0.5)
    ref = acts.reshape(rows, h).double() @ w_rs.double()
    cases = [(name, lambda k=kernel, tr=tile, cl=cluster:
              tc_gemm.conv_product_fwd(acts, w_rs, 1, 1, k, tr, cl).reshape(rows, -1))
             for name, kernel, tile, cluster in CANDIDATES if not kernel.startswith("tap_staged")]
    run("res_skip", [rows, h, 2 * h], cases, ref,
        tc_gemm.forward_conv_plan(rows, h, 2 * h, 1, 1, sms)["mode"], 2.0 * rows * h * 2 * h,
        None)
    print(json.dumps({"done": True, "gpu": gpu, "sms": sms, "checked_only": args.check}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

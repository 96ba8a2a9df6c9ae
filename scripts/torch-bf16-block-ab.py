"""The flow block's bf16 products on an NVIDIA GPU: the TMA-fed wgmma
kernels against the mma.sync kernels, in turns in one process.

Each product of bf16 rows 10 and 12 (``gtt_block_fwd_save_bf16``,
``gtt_block_bwd_store_bf16``) alone at its shape at ``--batch`` x ``--t``
(bare epilogue, f32 out; random bf16 operands from a seed): both units'
error against float64 of the same bf16 values, relative to max |ref|, and
each unit's device time by CUDA events (mma, tma, tma, mma; ``--reps``
launches each), TFLOP/s against the dense BF16 peak.  Then both rows at
base width (c 160, h 192, 4 WN layers, taps 5, dropout on) against their
plain bf16 versions, their product counts and device operations, and
their device time under torch.profiler with the products on the TMA-fed
kernels and on the mma.sync ones in turns.  One JSON line at the end.

    python scripts/torch-bf16-block-ab.py [--batch 32 --t 704 --reps 20]
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from glow_tts_train_tpu_torch import kernels  # noqa: E402
from glow_tts_train_tpu_torch.ops import block_cuda, tc_gemm  # noqa: E402

PEAK_BF16 = 989e12
# (name, c_in, taps, dilation, tap_sign, n, w_t) at base width: c 160, h 192
CONV = (
    ("start", 80, 1, 1, 1, 192, False), ("in_conv_d1", 192, 5, 1, 1, 384, False),
    ("in_conv_d4", 192, 5, 4, 1, 384, False), ("res_skip", 192, 1, 1, 1, 384, False),
    ("coupling", 192, 1, 1, 1, 160, False), ("coupling_bwd", 192, 1, 1, 1, 80, False),
    ("dskip", 160, 1, 1, 1, 192, True), ("gate_bwd", 384, 1, 1, 1, 192, True),
    ("transposed_d1", 384, 5, 1, -1, 192, True), ("transposed_d2", 384, 5, 2, -1, 192, True),
    ("dzp", 192, 1, 1, 1, 80, True), ("dx", 160, 1, 1, 1, 160, True),
)
# (name, c_in, taps, dilation, n) -> [taps * c_in, n]
WGRAD = (
    ("dW_e", 192, 1, 1, 160), ("dW_rs", 192, 1, 1, 384), ("dW_in_d1", 192, 5, 1, 384),
    ("dW_in_d2", 192, 5, 2, 384), ("dW_s", 80, 1, 1, 192), ("dA", 160, 1, 1, 160),
)
# a bare product against float64 of the same bf16 operands: f32 accumulation
# over K up to 1,920 (conv) or 22,528 rows (weight gradient)
PRODUCT_RTOL = 1e-5
BF16_RTOL = 2e-2  # a row against its plain bf16 version (chip_smoke.BF16_KERNEL_RTOL)


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls=3):
    """(device ms a call, device operations a call, device ms a call by
    kernel name) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
    by_name = {}
    for e in ops:
        found = re.search(r"(\w+)(<[^>]*>)?\(", e.name)
        key = "".join(found.groups("")) if found else e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return sum(by_name.values()), len(ops) / calls, by_name


def rel(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def products(batch, t, reps, gen, rows):
    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16).to(dev)

    for name, c_in, taps, dil, sign, n, w_t in CONV:
        a = r(batch, t, c_in)
        w = r(taps * n, c_in, scale=(taps * c_in) ** -0.5) if w_t else r(
            taps * c_in, n, scale=(taps * c_in) ** -0.5)
        ref = tc_gemm.conv_product_plain(a.double(), w.double(), taps, dil, sign, w_t=w_t)
        run = {u: (lambda u=u: tc_gemm.bf16_conv_product(a, w, taps, dil, sign, w_t, u))
               for u in ("mma", "tma")}
        row = product_row(name, "conv", [batch * t, taps * c_in, n], run, ref, reps)
        rows.append(row)
    for name, c_in, taps, dil, n in WGRAD:
        a, dy = r(batch, t, c_in), r(batch, t, n)
        ref = tc_gemm.weight_gradient_plain(a.double(), dy.double(), taps, dil)
        run = {u: (lambda u=u: tc_gemm.bf16_weight_gradient(a, dy, taps, dil, u))
               for u in ("mma", "tma")}
        rows.append(product_row(name, "wgrad", [taps * c_in, batch * t, n], run, ref, reps))


def product_row(name, kind, shape, run, ref, reps):
    errs = {u: rel(fn(), ref) for u, fn in run.items()}
    torch.cuda.synchronize()
    times = {"mma": [], "tma": []}
    for u in ("mma", "tma", "tma", "mma"):
        times[u].append(events_ms(run[u], reps))
    flops = 2.0 * shape[0] * shape[1] * shape[2]
    row = {"name": name, "kind": kind, "shape": shape, "err": errs,
           "us": {u: 1e3 * min(v) for u, v in times.items()},
           "tflops": {u: flops / (min(v) * 1e-3) / 1e12 for u, v in times.items()}}
    row["ok"] = max(errs.values()) <= PRODUCT_RTOL
    print(f"product bf16 {kind} {name} {shape}: err mma {errs['mma']:.2e} tma {errs['tma']:.2e}; "
          f"us mma {row['us']['mma']:.1f} tma {row['us']['tma']:.1f}; TFLOP/s mma "
          f"{row['tflops']['mma']:.1f} tma {row['tflops']['tma']:.1f} of {PEAK_BF16 / 1e12:.0f}"
          f"{'' if row['ok'] else '  FAILED'}", flush=True)
    return row


def block_rows(batch, t, gen):
    dev = torch.device("cuda")
    c, h, n_layers, taps = 160, 192, 4, 5
    lengths = torch.linspace(t, t // 2, batch).long()
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None].to(dev)
    x = (torch.randn(batch, t, c, generator=gen).to(dev) * mask).to(torch.bfloat16)
    f32 = {"A": torch.eye(c) + 0.05 * torch.randn(c, c, generator=gen),
           "bA": 0.1 * torch.randn(1, c, generator=gen),
           "W_s": torch.randn(c // 2, h, generator=gen) * (c // 2) ** -0.5,
           "b_s": 0.1 * torch.randn(1, h, generator=gen),
           "W_e": 0.05 * torch.randn(h, c, generator=gen),
           "b_e": 0.05 * torch.randn(1, c, generator=gen),
           "W_in": torch.randn(n_layers, taps * h, 2 * h, generator=gen) * (taps * h) ** -0.5,
           "b_in": 0.1 * torch.randn(n_layers, 2 * h, generator=gen),
           "W_rs": torch.randn(n_layers, h, 2 * h, generator=gen) * h ** -0.5,
           "b_rs": 0.1 * torch.randn(n_layers, 2 * h, generator=gen)}
    f32["W_rs"][-1, :, :h] = 0.0
    folded = {k: v.to(dev).to(torch.bfloat16 if k in block_cuda.BF16_OPERANDS else torch.float32)
              for k, v in f32.items()}
    cfg = (taps, 1, False, 0.05, 21)
    out = {}
    kernels.product_counts(reset=True)
    z, ld, saves = block_cuda.block_fwd_save(folded, None, x, mask, *cfg)
    torch.cuda.synchronize()
    out["fwd_counts"] = kernels.product_counts(reset=True)
    z_p, ld_p = block_cuda.block_forward_plain_bf16(folded, None, x, mask, *cfg)
    out["fwd_err"] = {"z": rel(z.float(), z_p.double()), "ld": rel(ld, ld_p.double())}
    dz = torch.randn(z.shape, generator=gen).to(dev).to(torch.bfloat16)
    dld = torch.randn(ld.shape, generator=gen).to(dev)
    grads = block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg)
    torch.cuda.synchronize()
    out["bwd_counts"] = kernels.product_counts(reset=True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in folded.items()}
    xl = x.detach().requires_grad_(True)
    zz, ll = block_cuda.block_forward_plain_bf16(leaves, None, xl, mask, *cfg)
    ref = torch.autograd.grad((zz, ll), [xl, *leaves.values()], (dz, dld))
    out["bwd_err"] = {name: rel(grads[name].float(), r.double())
                      for name, r in zip(["dx"] + ["d" + k for k in leaves], ref)}
    again = block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg)
    out["bwd_same_bits"] = all(torch.equal(again[k], grads[k]) for k in grads if grads[k] is not None)
    print(f"block bf16 [{batch}, {t}]: fwd counts {out['fwd_counts']} err {out['fwd_err']}; "
          f"bwd counts {out['bwd_counts']} same bits {out['bwd_same_bits']}", flush=True)
    print(f"  bwd err {out['bwd_err']}", flush=True)
    out["ok"] = (max(out["fwd_err"].values()) <= BF16_RTOL
                 and max(out["bwd_err"].values()) <= BF16_RTOL and out["bwd_same_bits"])

    fwd = lambda: block_cuda.block_fwd_save(folded, None, x, mask, *cfg)  # noqa: E731
    bwd = lambda: block_cuda.block_bwd_store(folded, False, x, mask, saves, dz, dld, *cfg)  # noqa: E731
    timed = {"fwd": {"mma": [], "tma": []}, "bwd": {"mma": [], "tma": []}}
    for unit in ("mma", "tma", "tma", "mma"):
        for row, fn in (("fwd", fwd), ("bwd", bwd)):
            if unit == "mma":
                with kernels.bf16_mma_only():
                    timed[row][unit].append(device_ms(fn))
            else:
                timed[row][unit].append(device_ms(fn))
    out["device_ms"] = {row: {u: min(x[0] for x in v) for u, v in d.items()}
                        for row, d in timed.items()}
    out["device_operations"] = {row: {u: v[0][1] for u, v in d.items()} for row, d in timed.items()}
    out["by_kernel_ms"] = {f"{row} {u}": v[0][2] for row, d in timed.items() for u, v in d.items()}
    print(f"rows bf16 device ms (in turns mma, tma, tma, mma): {out['device_ms']}; device "
          f"operations {out['device_operations']}", flush=True)
    for key, by in out["by_kernel_ms"].items():
        top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
        print(f"  {key}: " + "; ".join(f"{k} {v:.3f}" for k, v in top), flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--t", type=int, default=704)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    lib = kernels.build()
    log = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "bf16_tma" in line and "entry function" in line:
            used = next((x for x in log[i + 1:i + 5] if "Used" in x), "")
            print(line.split("'")[1][-60:], "|", used.strip())
    gen = torch.Generator().manual_seed(0)
    rows = []
    products(args.batch, args.t, args.reps, gen, rows)
    block = block_rows(args.batch, args.t, gen)
    ok = all(r["ok"] for r in rows) and block["ok"]
    print(json.dumps({"card": card, "products": rows, "block": block, "ok": ok}))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

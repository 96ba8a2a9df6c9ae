"""The bf16 text rows on an NVIDIA GPU, a forward and its backward
(``--row``): the encoder layer's (bf16 rows 2 and 13,
``gtt_encoder_layer_bf16`` / ``_bwd_bf16``; the default), the prenet's
(rows 1 and 14, ``gtt_prenet_bf16`` / ``_bwd_bf16``) or the duration
stack's (rows 3 and 15, ``gtt_duration_stack_bf16`` / ``_bwd_bf16``):
where their time goes, their products on both units, and two trees in
turns in one process.

* Each product of the two rows alone at its shape at ``--batch`` x ``--t``
  (base width: the encoder layer's h 192, f 768, taps 3; the prenet's h
  192, 3 layers of 5 taps; the duration stack's 192 channels, f 256, 3
  taps; bare epilogue, f32 out, random bf16
  operands from a seed) on every unit the tree has: "mma" (the mma.sync
  kernels), "tma" (the TMA-fed wgmma kernels, whole K walk a block) and,
  where the tree has it, "text" (the TMA-fed kernels by the text chains'
  plan: chunks a tile and split-K shares): error against float64 of the
  same bf16 values relative to max |ref|, device us from a trace bracketed
  by spin kernels (5 calls; units in turns), TFLOP/s against the dense
  BF16 peak.
* Both rows at base width (ragged lengths, dropout on; the encoder
  layer's 2 heads, window 4) against their plain bf16 versions (2e-2 of
  each output's and gradient's max, the backward at the kernel's own ReLU
  gates), then one call of each under a bracketed trace: every device
  operation in launch order with its us, the products' TFLOP/s.
* Each row's device ms a call, in turns: with ``--parent DIR`` (another
  checkout of the repository, imported as a second package and built
  from its own sources) parent, this tree, this tree, parent; and on this
  tree with its products on the TMA-fed kernels and, by ``gtt_bf16_tma(0)``
  (``kernels.bf16_mma_only``), on the mma.sync ones.

One JSON line at the end.

    python scripts/torch-bf16-encoder-ab.py [--row encoder|prenet|duration]
        [--batch 32 --t 192 --parent DIR]
"""

import argparse
import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from glow_tts_train_tpu_torch import kernels  # noqa: E402
from glow_tts_train_tpu_torch.ops import encoder_cuda, tc_gemm, text_cuda  # noqa: E402

PEAK_BF16 = 989e12
H, F, TAPS, HEADS, WINDOW, P_DROP = 192, 768, 3, 2, 4, 0.1
PRENET_L, PRENET_TAPS, DP_F = 3, 5, 256


class Row:
    """A forward/backward pair of bf16 text rows: their labels, their
    module's wrappers and plain versions (by name), dropout and other
    arguments, and their products in launch order: (name, c_in, taps,
    tap_sign, n, w_t) of each conv-GEMM, (name, c_in, taps, n) of each
    weight gradient (-> [taps * c_in, n]); ``fwd`` the forward's leading
    conv-GEMMs, the backward's recompute."""

    def __init__(self, labels, module, names, cfg, conv, wgrad, order, fwd):
        self.labels, self.module, self.names, self.cfg = labels, module, names, cfg
        self.conv, self.wgrad, self.order, self.fwd = conv, wgrad, order, fwd


ROWS = {
    "encoder": Row(
        ("row 2", "row 13"), "encoder_cuda",
        ("encoder_layer", "encoder_layer_bwd", "encoder_layer_plain_bf16",
         "encoder_layer_bwd_plain"), (HEADS, WINDOW, P_DROP, 17),
        (("qkv", H, 1, 1, 3 * H, False), ("out_proj", H, 1, 1, H, False),
         ("ffn1", H, TAPS, 1, F, False), ("ffn2", F, TAPS, 1, H, False),
         ("dffn", H, TAPS, -1, F, True), ("dx1", F, TAPS, -1, H, True),
         ("datt", H, 1, 1, H, True), ("dx", 3 * H, 1, 1, H, True)),
        (("dW2", F, TAPS, H), ("dW1", H, TAPS, F), ("dWo", H, 1, H), ("dW_qkv", H, 1, 3 * H)),
        ("dW2", "dffn", "dW1", "dx1", "dWo", "datt", "dW_qkv", "dx"), 4),
    "prenet": Row(
        ("row 1", "row 14"), "text_cuda",
        ("prenet", "prenet_bwd", "prenet_plain_bf16", "prenet_bwd_plain"), (0.5, 17),
        tuple((f"conv_{l}", H, PRENET_TAPS, 1, H, False) for l in range(PRENET_L))
        + (("proj", H, 1, 1, H, False), ("dproj", H, 1, 1, H, True))
        + tuple((f"transposed_{l}", H, PRENET_TAPS, -1, H, True)
                for l in reversed(range(PRENET_L))),
        (("dWp", H, 1, H),) + tuple((f"dW_{l}", H, PRENET_TAPS, H)
                                    for l in reversed(range(PRENET_L))),
        ("dWp", "dproj") + sum(((f"dW_{l}", f"transposed_{l}")
                                for l in reversed(range(PRENET_L))), ()), PRENET_L + 1),
    "duration": Row(
        ("row 3", "row 15"), "text_cuda",
        ("duration_stack", "duration_stack_bwd", "duration_stack_plain_bf16",
         "duration_stack_bwd_plain"), (0.1, 17),
        (("conv_0", H, TAPS, 1, DP_F, False), ("conv_1", DP_F, TAPS, 1, DP_F, False),
         ("transposed_1", DP_F, TAPS, -1, DP_F, True), ("transposed_0", DP_F, TAPS, -1, H, True)),
        (("dW_1", DP_F, TAPS, DP_F), ("dW_0", H, TAPS, DP_F)),
        ("dW_1", "transposed_1", "dW_0", "transposed_0"), 2),
}
PRODUCT_RTOL = 1e-5  # a bare product against float64 of the same bf16 operands
BF16_RTOL = 2e-2  # a row against its plain bf16 version (chip_smoke.BF16_KERNEL_RTOL)


def bracketed(fn, calls):
    """[(device operation, us)] of ``calls`` calls of ``fn`` in launch
    order, from a torch.profiler trace in which they stand between 16 spin
    kernels a side (a trace short of records at an edge is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
        spin = ["spin" in e.name for e in ops]
        inner = [i for i, s in enumerate(spin) if not s]
        if inner and any(spin[:inner[0]]) and any(spin[inner[-1]:]) \
                and not any(spin[inner[0]:inner[-1]]):
            return [(ops[i].name, ops[i].time_range.elapsed_us()) for i in inner]
    raise RuntimeError("no trace of 4 held a spin kernel on each side of the calls")


def short(name):
    for junk in ("void ", "(anonymous namespace)::", "gtt::"):
        name = name.replace(junk, "")
    return name.split("(")[0][:60]


def rel(a, ref):
    return ((a.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def load_parent(path, ops_module):
    """The package of another checkout at ``path``, imported as
    ``gtt_parent`` (its kernels built from its own sources into its own
    build directory): its kernels and ``ops_module``."""
    pkg = Path(path).resolve() / "glow_tts_train_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "gtt_parent", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["gtt_parent"] = module
    spec.loader.exec_module(module)
    return (importlib.import_module("gtt_parent.kernels"),
            importlib.import_module(f"gtt_parent.ops.{ops_module}"))


def products(spec, batch, t, gen):
    dev = torch.device("cuda")

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(torch.bfloat16).to(dev)

    units = list(tc_gemm.BF16_UNITS)
    cases = []
    for name, c_in, taps, sign, n, w_t in spec.conv:
        a = r(batch, t, c_in)
        w = r(*((taps * n, c_in) if w_t else (taps * c_in, n)), scale=(taps * c_in) ** -0.5)
        cases.append((name, "conv", [batch * t, taps * c_in, n],
                      lambda u, a=a, w=w, taps=taps, sign=sign, w_t=w_t:
                      tc_gemm.bf16_conv_product(a, w, taps, 1, sign, w_t, u),
                      tc_gemm.conv_product_plain(a.double(), w.double(), taps, 1, sign, w_t=w_t)))
    for name, c_in, taps, n in spec.wgrad:
        a, dy = r(batch, t, c_in), r(batch, t, n)
        cases.append((name, "wgrad", [taps * c_in, batch * t, n],
                      lambda u, a=a, dy=dy, taps=taps:
                      tc_gemm.bf16_weight_gradient(a, dy, taps, 1, "tma" if u == "text" else u),
                      tc_gemm.weight_gradient_plain(a.double(), dy.double(), taps, 1)))
    rows = []
    for name, kind, shape, run, ref in cases:
        mine = units if kind == "conv" else ["mma", "tma"]
        errs = {u: rel(run(u), ref) for u in mine}
        us = {u: [] for u in mine}
        for u in mine + mine[::-1]:
            ops = bracketed(lambda: run(u), 5)
            us[u].append(sum(x for _, x in ops) / 5)
        flops = 2.0 * shape[0] * shape[1] * shape[2]
        best = {u: min(v) for u, v in us.items()}
        row = {"name": name, "kind": kind, "shape": shape, "err": errs, "us": best,
               "us_turns": us, "tflops": {u: flops / (v * 1e-6) / 1e12 for u, v in best.items()},
               "ok": max(errs.values()) <= PRODUCT_RTOL}
        print(f"product bf16 {kind} {name} {shape}: err "
              + ", ".join(f"{u} {e:.2e}" for u, e in errs.items()) + "; device us "
              + ", ".join(f"{u} {v:.1f}" for u, v in best.items()) + "; TFLOP/s "
              + ", ".join(f"{u} {v:.1f}" for u, v in row["tflops"].items())
              + f" of {PEAK_BF16 / 1e12:.0f}" + ("" if row["ok"] else "  FAILED"), flush=True)
        rows.append(row)
    return rows


def layer_inputs(row, batch, t, gen):
    dev = torch.device("cuda")
    d = H // HEADS
    bf = torch.bfloat16

    def r(*shape, scale=1.0, off=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale + off).to(dtype).to(dev)

    lengths = torch.linspace(t, t // 2, batch).long()
    mask = (torch.arange(t)[None, :] < lengths[:, None]).float()[..., None].to(dev)
    x = (torch.randn(batch, t, H, generator=gen).to(dev) * mask).to(bf)
    if row == "prenet":
        L, k = PRENET_L, PRENET_TAPS
        weights = (r(L, k * H, H, scale=(k * H) ** -0.5, dtype=bf), r(L, H, scale=0.1),
                   r(L, H, scale=0.1, off=1.0), r(L, H, scale=0.1),
                   r(H, H, scale=H ** -0.5, dtype=bf), r(1, H, scale=0.1))
    elif row == "duration":
        weights = (r(TAPS * H, DP_F, scale=(TAPS * H) ** -0.5, dtype=bf), r(1, DP_F, scale=0.1),
                   r(1, DP_F, scale=0.1, off=1.0), r(1, DP_F, scale=0.1),
                   r(TAPS * DP_F, DP_F, scale=(TAPS * DP_F) ** -0.5, dtype=bf),
                   r(1, DP_F, scale=0.1), r(1, DP_F, scale=0.1, off=1.0), r(1, DP_F, scale=0.1))
    else:
        weights = (r(H, 3 * H, scale=H ** -0.5, dtype=bf), r(1, 3 * H, scale=0.1),
                   r(H, H, scale=H ** -0.5, dtype=bf), r(1, H, scale=0.1),
                   r(2 * WINDOW + 1, d, scale=d ** -0.5, dtype=bf),
                   r(2 * WINDOW + 1, d, scale=d ** -0.5, dtype=bf),
                   r(1, H, scale=0.1, off=1.0), r(1, H, scale=0.1),
                   r(1, H, scale=0.1, off=1.0), r(1, H, scale=0.1),
                   r(TAPS * H, F, scale=(TAPS * H) ** -0.5, dtype=bf), r(1, F, scale=0.1),
                   r(TAPS * F, H, scale=(TAPS * F) ** -0.5, dtype=bf), r(1, H, scale=0.1))
    width = DP_F if row == "duration" else H
    dout = (torch.randn(batch, t, width, generator=gen) / 4).to(bf).to(dev)
    return weights, x, mask, dout


def chain_products(spec, batch, t, backward):
    """The products of a call in launch order: (name, operations)."""
    rows = batch * t
    ops = {name: 2.0 * rows * taps * c_in * n for name, c_in, taps, _, n, _ in spec.conv}
    ops.update({name: 2.0 * rows * taps * c_in * n for name, c_in, taps, n in spec.wgrad})
    names = [c[0] for c in spec.conv[:spec.fwd]] + (list(spec.order) if backward else [])
    return [(name, ops[name]) for name in names]


def breakdown(spec, label, fn, batch, t, backward):
    """One call's device operations in launch order; each product's us
    (a split-K sum pass or a weight gradient's splits' sum added to the
    product before it) and TFLOP/s."""
    ops = [(short(n), us) for n, us in bracketed(fn, 1)]
    plan = chain_products(spec, batch, t, backward)
    named, i = [], -1
    for name, us in ops:
        if name.startswith(("conv_gemm", "wgrad")):
            i += 1
            named.append([plan[i][0] if i < len(plan) else "?", name, us])
        elif name.startswith(("split_sum", "conv_split_sum")) and named:
            named[-1][2] += us
    total = sum(us for _, us in ops)
    print(f"{label}: {len(ops)} device operations, {total / 1e3:.4f} ms", flush=True)
    for name, us in ops:
        print(f"  {us:9.2f} us  {name}", flush=True)
    flops = dict(plan)
    prods = [{"product": p, "kernel": k, "us": us,
              "tflops": flops.get(p, 0.0) / (us * 1e-6) / 1e12} for p, k, us in named]
    for p in prods:
        print(f"  product {p['product']:9s} {p['us']:8.2f} us {p['tflops']:7.1f} TFLOP/s of "
              f"{PEAK_BF16 / 1e12:.0f} ({p['kernel']})", flush=True)
    return {"ms": total / 1e3, "operations": ops, "products": prods}


def tree_rows(spec, label, kern, mod, inputs, batch, t):
    """The two rows of one tree (``kern``, ``mod``: its kernels and the
    rows' ops module) on ``inputs``: their product counts, their error
    against this tree's plain bf16 versions, one call of each in launch
    order; "fwd" and "bwd" the calls, for the turns."""
    weights, x, mask, dout = inputs
    cfg = spec.cfg
    fwd_name, bwd_name, plain_name, plain_bwd_name = spec.names
    this = {"encoder_cuda": encoder_cuda, "text_cuda": text_cuda}[spec.module]
    row_f, row_b = spec.labels

    def fwd():
        return getattr(mod, fwd_name)(weights, x, mask, *cfg)

    def bwd(saves=None):
        return getattr(mod, bwd_name)(weights, x, mask, dout, *cfg, saves=saves)

    kern.product_counts(reset=True)
    y = fwd()
    torch.cuda.synchronize()
    counts = {row_f: kern.product_counts(reset=True)}
    saves = {}
    grads = bwd(saves)
    torch.cuda.synchronize()
    counts[row_b] = kern.product_counts(reset=True)
    plain = getattr(this, plain_name)(weights, x, mask, *cfg)
    ref = getattr(this, plain_bwd_name)(weights, x, mask, dout, *cfg, gates=saves["gates"])
    errs = {"out": rel(y.float(), plain.float())}
    errs.update({f"grad {i}": rel(a.float(), b.float())
                 for i, (a, b) in enumerate(zip(grads, ref))})
    ok = max(errs.values()) <= BF16_RTOL
    print(f"{label}: products {counts}; worst error against the plain bf16 version "
          f"{max(errs.values()):.2e}{'' if ok else '  FAILED'}", flush=True)
    return {"fwd": fwd, "bwd": bwd, "errs": errs, "counts": counts, "ok": ok,
            "breakdown": {
                row_f: breakdown(spec, f"{label} {row_f} one call", fwd, batch, t, False),
                row_b: breakdown(spec, f"{label} {row_b} one call", bwd, batch, t, True)}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--row", choices=sorted(ROWS), default="encoder")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--t", type=int, default=192)
    parser.add_argument("--parent", default=None)
    parser.add_argument("--skip-products", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    spec = ROWS[args.row]
    trees = {"this": (kernels, {"encoder_cuda": encoder_cuda, "text_cuda": text_cuda}[spec.module])}
    if args.parent:
        trees["parent"] = load_parent(args.parent, spec.module)
    for label, (kern, _) in trees.items():
        lib = kern.build()
        log = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(log):
            kernel = "attn" in line or "attention" in line or "bf16_tma" in line
            if kernel and "entry function" in line:
                used = next((x for x in log[i + 1:i + 5] if "Used" in x), "")
                print(label, line.split("'")[1][-70:], "|", used.strip(), flush=True)
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "row": args.row, "batch": args.batch, "t": args.t}
    if not args.skip_products:
        out["products"] = products(spec, args.batch, args.t, gen)
    inputs = layer_inputs(args.row, args.batch, args.t, gen)
    rows = {label: tree_rows(spec, label, kern, mod, inputs, args.batch, args.t)
            for label, (kern, mod) in trees.items()}
    ok = all(r["ok"] for r in out.get("products", []) + list(rows.values()))
    turns = {}
    order = (["parent", "this", "this", "parent"] if args.parent else ["this"]) * 2
    for label in order:
        for row in ("fwd", "bwd"):
            ops = bracketed(rows[label][row], 3)
            turns.setdefault(f"{label} {row}", []).append(sum(us for _, us in ops) / 3e3)
    for unit in ("tma", "mma", "mma", "tma"):
        with kernels.bf16_mma_only() if unit == "mma" else contextlib.nullcontext():
            for row in ("fwd", "bwd"):
                ops = bracketed(rows["this"][row], 3)
                turns.setdefault(f"this {unit} {row}", []).append(sum(us for _, us in ops) / 3e3)
    print("device ms a call in turns: " + json.dumps(turns), flush=True)
    out["rows"] = {k: {kk: vv for kk, vv in v.items() if kk not in ("fwd", "bwd")}
                   for k, v in rows.items()}
    out["turns_ms"] = turns
    out["ok"] = ok
    print(json.dumps(out, default=str))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

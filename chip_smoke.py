#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (glow_tts_train_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each fatal on failure:

1. builds the CUDA kernels from ``glow_tts_train_tpu_torch/csrc`` with
   nvcc for sm_90a;
2. writes a checkpoint at the full width of ``configs/base.json`` in the
   JAX package's ``.npz`` format, with random non-zero weights from a
   numpy seed (duration bias log 6: about 6 frames per phoneme);
3. serves 4 requests (48, 96, 160 and 250 phonemes) through the port's
   inference CLI entry point, ``glow_tts_train_tpu_torch.infer.main``,
   once at ``--batch-size 1`` and once at ``--batch-size 4``; checks the
   mels (finite, [80, t]) and each kernel's launch count;
4. holds each kernel against its plain PyTorch version on the card, on the
   inputs the batch-4 pass gave it, and the whole batch-4 mel of the
   kernel path against the plain path on the CPU;
5. times each kernel against its plain version with CUDA events;
6. times whole syntheses through ``build_synthesizer`` (the CLI's synth
   without stdin or JSON), kernel path against plain path on the card,
   and profiles one to read the device's busy time and idle share.

Prints the GPU's name and power limit, a ``{"kernels": [...]}`` JSON line,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU
or outside a checkout of the repository.
"""

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
REQUEST_LENGTHS = (48, 96, 160, 250)
# the device the kernel path runs on
PLATFORM = "cuda"
# kernel vs plain version on the card, both f32: they differ only in
# summation order (the kernels' tiled FMA chains vs cuBLAS), so max abs
# error must stay within 1e-4 of the output's max magnitude
KERNEL_RTOL = 1e-4
# whole mel, kernels on the card vs plain path on the CPU: 6 encoder
# layers and 12 inverse flow blocks of f32 GEMMs in different summation
# orders, the inverse flow scaling by exp(-logs) per block
MEL_RTOL = 1e-3
TIMED_RUNS = 30
# whole syntheses: phoneme counts per batch; median of SYNTH_RUNS calls
# after 3 warm-ups, kernel and plain path in turns (kernel, plain, plain,
# kernel)
SERVE_BATCHES = {
    "b1_48": (48,), "b1_250": (250,), "b4_mix": REQUEST_LENGTHS, "b8_160": (160,) * 8,
}
SYNTH_RUNS = 10
PROFILED = ("b1_250", "b4_mix")

KERNEL_META = {
    "prenet": ("glow_tts_train_tpu_torch/csrc/text.cu",
               "glow_tts_train_tpu/ops/text_pallas.py:118"),
    "encoder_layer": ("glow_tts_train_tpu_torch/csrc/encoder.cu",
                      "glow_tts_train_tpu/ops/encoder_pallas.py:250"),
    "duration_stack": ("glow_tts_train_tpu_torch/csrc/text.cu",
                       "glow_tts_train_tpu/ops/text_pallas.py:212"),
    "block_inverse": ("glow_tts_train_tpu_torch/csrc/block.cu",
                      "glow_tts_train_tpu/ops/block_pallas.py:714"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def make_checkpoint(workdir: Path, config_path: Path):
    import numpy as np

    from glow_tts_train_tpu_torch import checkpoint
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.models import hyper_from_config

    config = load_config([config_path])
    hp = hyper_from_config(config)
    flat = checkpoint.random_params(hp, SEED)
    flat["model/proj_w/proj/w"] *= np.float32(0.1)
    flat["model/proj_w/proj/b"][:] = math.log(6.0)
    path = workdir / "checkpoint_base.npz"
    checkpoint.save_npz(path, flat)
    return path, config, hp


def requests() -> str:
    import numpy as np

    rng = np.random.default_rng(SEED)
    lines = []
    for i, n in enumerate(REQUEST_LENGTHS):
        ids = rng.integers(1, 130, size=n)
        lines.append(f"utt{i}|{' '.join(map(str, ids))}")
    return "\n".join(lines) + "\n"


def serve(ckpt: Path, config_path: Path, stdin_text: str, batch_size: int, n_mel: int):
    """One pass of the inference CLI in-process -> (mels by id, seconds)."""
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import infer

    argv = [str(ckpt), "--config", str(config_path), "--csv",
            "--batch-size", str(batch_size), "--platform", PLATFORM]
    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin_text)
    try:
        start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            infer.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        sys.stdin = old_stdin
    mels = {}
    for line in out.getvalue().splitlines():
        obj = json.loads(line)
        mels[obj["id"]] = np.asarray(obj["mel"], np.float32)
    if len(mels) != len(REQUEST_LENGTHS):
        fail(f"batch {batch_size}: {len(mels)} mels for {len(REQUEST_LENGTHS)} requests")
    for utt, mel in mels.items():
        if mel.ndim != 2 or mel.shape[0] != n_mel or mel.shape[1] < 1:
            fail(f"{utt}: mel shape {mel.shape}")
        if not np.isfinite(mel).all():
            fail(f"{utt}: non-finite mel")
    return mels, seconds


class Recorder:
    """Wraps a kernel wrapper to keep the arguments of one call."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None
        self.armed = False
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.armed and self.args is None:
            self.args = (args, kwargs)
        return self.fn(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def time_ms(fn, args, kwargs) -> float:
    import torch

    for _ in range(5):
        fn(*args, **kwargs)
    times = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_path_on_card():
    """Send CUDA tensors to the kernels' plain versions (every wrapper asks
    ``kernels.route``), to time the plain path end to end on the card."""
    from glow_tts_train_tpu_torch import kernels

    route = kernels.route
    kernels.route = lambda x: "plain"
    try:
        yield
    finally:
        kernels.route = route


def serving_times(ckpt: Path, config, hp, device_line: str) -> list:
    """Synthesis wall time per batch, kernel path vs plain path on the
    card, with the real-time factor (synth seconds / audio seconds) of
    each; then the device's busy time and idle share of one profiled
    synthesis on the kernel path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from glow_tts_train_tpu_torch.checkpoint import load_checkpoint
    from glow_tts_train_tpu_torch.infer import build_synthesizer
    from glow_tts_train_tpu_torch.models import store_inverse

    model, _ = load_checkpoint(ckpt, hp)
    weights = store_inverse(model, hp).to(PLATFORM)
    synth = build_synthesizer(weights, hp, config, noise_scale=0.333, length_scale=1.0)
    rng = np.random.default_rng(SEED + 2)
    lengths = sorted({n for batch in SERVE_BATCHES.values() for n in batch})
    ids = {n: rng.integers(1, 130, size=n).tolist() for n in lengths}
    seconds_per_frame = config.audio.hop_length / config.audio.sample_rate

    def median_ms(batch):
        for _ in range(3):
            synth(batch)
        times = []
        for _ in range(SYNTH_RUNS):
            start = time.perf_counter()
            mels = synth(batch)  # ends in the copy of the mels to the host
            times.append(time.perf_counter() - start)
        return statistics.median(times) * 1e3, sum(m.shape[1] for m in mels)

    rows = []
    for case, batch_lengths in SERVE_BATCHES.items():
        batch = [ids[n] for n in batch_lengths]
        ms = {"kernel": [], "plain": []}
        for path in ("kernel", "plain", "plain", "kernel"):
            with plain_path_on_card() if path == "plain" else contextlib.nullcontext():
                t, frames = median_ms(batch)
            ms[path].append(t)
        audio_s = frames * seconds_per_frame
        row = {
            "case": case, "frames": frames, "audio_s": audio_s,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "rtf_kernel": min(ms["kernel"]) / 1e3 / audio_s,
            "rtf_plain": min(ms["plain"]) / 1e3 / audio_s,
        }
        if case in PROFILED:
            synth(batch)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                synth(batch)
                wall_ms = (time.perf_counter() - start) * 1e3
            # device kernels run on one stream, so their times add up
            by_kernel = {
                e.key: e.self_device_time_total / 1e3
                for e in prof.key_averages() if e.device_type.name == "CUDA"
            }
            busy_ms = sum(by_kernel.values())
            row["profiled_wall_ms"] = wall_ms
            row["device_busy_ms"] = busy_ms
            row["idle_share"] = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
            row["top_kernels_ms"] = {k[:60]: v for k, v in top}
        rows.append(row)
        print(f"synth {case}: {frames} frames, kernel path {ms['kernel']} ms, "
              f"plain path {ms['plain']} ms, RTF {row['rtf_kernel']:.3e} vs "
              f"{row['rtf_plain']:.3e} [{device_line}]")
        if case in PROFILED:
            print(f"  profiled: wall {row['profiled_wall_ms']:.3f} ms, device busy "
                  f"{busy_ms:.3f} ms, idle share {row['idle_share']}, top {row['top_kernels_ms']}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from glow_tts_train_tpu_torch import kernels

    config_path = repo / "configs" / "base.json"
    if not config_path.exists():
        fail(f"{config_path} missing: run from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_line = gpu_line()
    print(device_line)

    start = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - start:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        return run(Path(workdir), config_path, device_line)


def run(workdir: Path, config_path: Path, device_line: str) -> int:
    import numpy as np
    import torch

    from glow_tts_train_tpu_torch import kernels
    from glow_tts_train_tpu_torch.checkpoint import load_checkpoint
    from glow_tts_train_tpu_torch.models import encoder_forward, forward_gen, store_inverse
    from glow_tts_train_tpu_torch.ops import block_cuda, encoder_cuda, text_cuda

    ckpt, config, hp = make_checkpoint(workdir, config_path)
    stdin_text = requests()

    recorders = {
        "prenet": Recorder(text_cuda, "prenet"),
        "encoder_layer": Recorder(encoder_cuda, "encoder_layer"),
        "duration_stack": Recorder(text_cuda, "duration_stack"),
        "block_inverse": Recorder(block_cuda, "block_inverse"),
    }

    # ---- main path: the CLI at batch 1, then batch 4 ----
    kernels.reset_launch_counts()
    mels_b1, sec_b1 = serve(ckpt, config_path, stdin_text, 1, hp.out_channels)
    after_b1 = kernels.launch_counts()
    for rec in recorders.values():
        rec.armed = True
    mels_b4, sec_b4 = serve(ckpt, config_path, stdin_text, 4, hp.out_channels)
    launches = kernels.launch_counts()
    for rec in recorders.values():
        rec.restore()
    n = len(REQUEST_LENGTHS)
    per_synth = {  # launches of each kernel in one synthesis
        "prenet": int(hp.prenet), "encoder_layer": hp.n_layers_enc,
        "duration_stack": 1, "block_inverse": hp.n_blocks_dec,
    }
    for name, per in per_synth.items():
        want_b1, want_b4 = n * per, per
        got_b1, got_b4 = after_b1[name], launches[name] - after_b1[name]
        if (got_b1, got_b4) != (want_b1, want_b4):
            fail(f"{name}: launches {got_b1} (b=1) and {got_b4} (b=4), "
                 f"expected {want_b1} and {want_b4}")
    frames = {u: m.shape[1] for u, m in mels_b4.items()}
    for utt, mel in mels_b1.items():
        if mel.shape != mels_b4[utt].shape:
            fail(f"{utt}: b=1 mel {mel.shape} vs b=4 mel {mels_b4[utt].shape}")
    print(f"serve: frames per request {frames}")
    print(f"serve: first pass b=1 {sec_b1:.3f} s, b=4 {sec_b4:.3f} s (4 requests, "
          f"checkpoint load and fold included)")
    _, warm_b1 = serve(ckpt, config_path, stdin_text, 1, hp.out_channels)
    _, warm_b4 = serve(ckpt, config_path, stdin_text, 4, hp.out_channels)
    print(f"serve: second pass b=1 {warm_b1:.3f} s, b=4 {warm_b4:.3f} s")

    # ---- each kernel against its plain version, at the b=4 pass's inputs ----
    plains = {
        "prenet": text_cuda.prenet_plain,
        "encoder_layer": encoder_cuda.encoder_layer_plain,
        "duration_stack": text_cuda.duration_stack_plain,
        "block_inverse": block_cuda.block_inverse_plain,
    }
    report = []
    for name, rec in recorders.items():
        args, kwargs = rec.args
        kernel_fn = rec.fn
        with torch.inference_mode():
            out_k = kernel_fn(*args, **kwargs)
            out_p = plains[name](*args, **kwargs)
            torch.cuda.synchronize()
            err = (out_k - out_p).abs().max().item()
            scale = out_p.abs().max().item()
            if not math.isfinite(err) or err > KERNEL_RTOL * max(scale, 1.0):
                fail(f"{name}: max abs err {err} vs max |ref| {scale} "
                     f"(tolerance {KERNEL_RTOL} relative)")
            ms = time_ms(kernel_fn, args, kwargs)
            plain_ms = time_ms(plains[name], args, kwargs)
        x = next(a for a in args if isinstance(a, torch.Tensor) and a.dim() == 3)
        source, replaces = KERNEL_META[name]
        report.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "shape": list(x.shape), "max_abs_ref": scale,
        })
        print(f"kernel {name}: x {list(x.shape)} err {err:.3e} (max|ref| {scale:.3f}) "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{device_line}]")

    # ---- the whole mel: kernel path on the card vs plain path on the CPU ----
    rng = np.random.default_rng(SEED + 1)
    t_x = max(REQUEST_LENGTHS)
    x_np = np.zeros((n, t_x), np.int64)
    for i, k in enumerate(REQUEST_LENGTHS):
        x_np[i, :k] = rng.integers(1, 130, size=k)
    model, _ = load_checkpoint(ckpt, hp)
    w_cpu = store_inverse(model, hp)
    runs = []
    y_max = eps = None
    for dev, w in ((PLATFORM, w_cpu.to(PLATFORM)), ("cpu", w_cpu)):
        x = torch.from_numpy(x_np).to(dev)
        xl = torch.tensor(REQUEST_LENGTHS, device=dev)
        with torch.inference_mode():
            enc = encoder_forward(w, hp, x, xl)
            if y_max is None:  # one frame budget and one noise draw for both
                n_frames = torch.sum(torch.ceil(torch.exp(enc[2]) * enc[3]), dim=(1, 2))
                y_max = (int(n_frames.max()) // hp.n_sqz + 1) * hp.n_sqz
                eps = torch.from_numpy(
                    rng.standard_normal((n, y_max, hp.out_channels)).astype(np.float32)
                )
            (y, *_), _, (_, logw, _), y_len = forward_gen(
                w, hp, x, xl, y_max, noise_scale=0.333, eps=eps.to(dev),
                encoder_out=enc,
            )
        runs.append((y.cpu(), y_len.cpu(), logw.cpu()))
    (y_k, len_k, logw_k), (y_p, len_p, logw_p) = runs
    if not torch.equal(len_k, len_p):
        fail(f"y_lengths differ: {len_k.tolist()} vs {len_p.tolist()}")
    mel_err = (y_k - y_p).abs().max().item()
    mel_scale = y_p.abs().max().item()
    logw_err = (logw_k - logw_p).abs().max().item()
    print(f"mel: kernel path (cuda) vs plain path (cpu) b={n}: max abs err {mel_err:.3e}, "
          f"max |mel| {mel_scale:.3f}, logw err {logw_err:.3e}, "
          f"y_lengths {len_p.tolist()}")
    if not math.isfinite(mel_err) or mel_err > MEL_RTOL * max(mel_scale, 1.0):
        fail(f"mel: max abs err {mel_err} (tolerance {MEL_RTOL} relative)")

    serve_rows = serving_times(ckpt, config, hp, device_line)

    print(json.dumps({"serve": serve_rows}))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Synthesis cells: ``infer.build_synthesizer``'s ``synth``, the function the
infer CLI's ``flush`` calls, driven by one client that sends its calls
back to back (a closed loop).

The weights reach the program through its own load path: the checkpoint's
``model/<path>`` arrays into ``checkpoint.params_from_numpy``, then
``models.store_inverse`` and ``.to(device)``, as the infer CLI loads them.
Every ``greedy_every``-th call goes to a synthesizer built the same way
with ``noise_scale`` 0, whose mels the reference can recompute; the others
sample their noise as the traffic states.

Set-up warms up the longest budget (a call of the traffic's longest
sentences) and a few calls of the traffic through both synthesizers.  The
window's calls run until ``--seconds`` have passed; each call's latency
is the host clock from the call until ``synth`` returns its host arrays.
"""

import json
import time
import typing
from pathlib import Path

import torch

from . import corpus, flops, trace
from . import weights as bench_weights

WARM_CALLS = 8


def run(ctx) -> typing.Tuple[dict, dict]:
    """One run of a synthesis cell -> (record, probe); the probe holds the
    noise-free calls' sentences and mels for the check."""
    from glow_tts_train_tpu_torch.checkpoint import params_from_numpy
    from glow_tts_train_tpu_torch.config import load_config
    from glow_tts_train_tpu_torch.infer import build_synthesizer
    from glow_tts_train_tpu_torch.models import hyper_from_config, store_inverse

    traffic, device = ctx.traffic, ctx.device
    cuda = device.type == "cuda"
    config = load_config([ctx.config_path])
    config.seed = int(ctx.seed)
    hp = hyper_from_config(config)
    hp_ref = bench_weights.hyper(json.loads(Path(ctx.config_path).read_text()))
    flat = bench_weights.make(hp_ref, ctx.seed, device)
    model = params_from_numpy({"model/" + k: v.cpu().numpy() for k, v in flat.items()}, hp)
    del flat
    served = store_inverse(model, hp).to(device)
    del model
    scale = float(traffic["length_scale"])
    speaker = traffic.get("speaker")
    sampled = build_synthesizer(served, hp, config, noise_scale=float(traffic["noise_scale"]),
                                length_scale=scale)
    greedy = build_synthesizer(served, hp, config, noise_scale=0.0, length_scale=scale)
    every = int(traffic["greedy_every"])

    longest = [[1 + (j % (traffic["symbols"] - 1)) for j in range(traffic["phonemes"][1])]
               for _ in range(int(traffic["batch"]))]
    warm = corpus.Calls(traffic, int(ctx.seed) + 1)
    for synth in (sampled, greedy):
        synth(longest, speaker)
        for _ in range(WARM_CALLS // 2):
            synth(next(warm), speaker)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    record: dict = {"setup_s": time.perf_counter() - ctx.t0}

    calls = corpus.Calls(traffic, ctx.seed)
    kept: typing.List[tuple] = []
    lengths: typing.List[tuple] = []
    latencies: typing.List[float] = []

    def window(seconds: float) -> float:
        for kept_list in (kept, lengths, latencies):
            kept_list.clear()
        start = time.perf_counter()
        i = 0
        while True:
            sentences = next(calls)
            noise_free = i % every == 0
            t0 = time.perf_counter()
            mels = (greedy if noise_free else sampled)(sentences, speaker)
            latencies.append(time.perf_counter() - t0)
            lengths.append(([len(s) for s in sentences], [m.shape[1] for m in mels]))
            if noise_free:
                kept.append((sentences, mels))
            i += 1
            if time.perf_counter() - start >= seconds:
                return time.perf_counter() - start

    if ctx.trace:
        _, summary = trace.traced(lambda: window(min(ctx.seconds, traffic["traced_seconds"])),
                                  device)
        record["trace"] = summary
    else:
        record["window_s"] = window(ctx.seconds)
    frames = sum(sum(y) for _, y in lengths)
    record.update(
        driver="synth", world=1, calls=len(latencies), latencies_ms=[t * 1e3 for t in latencies],
        audio_s=frames * config.audio.hop_length / config.audio.sample_rate,
        peak_bytes=int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
        peak_flops=flops.PEAK_FLOPS["tf32"],
        flops=sum(flops.synth_flops(hp_ref, x, y) for x, y in lengths),
        failed=sum(1 for x, y in lengths if len(y) != len(x)),
    )
    del served, sampled, greedy
    if cuda:
        torch.cuda.empty_cache()
    probe = {"hp": hp_ref, "calls": kept, "length_scale": scale, "speaker": speaker}
    return record, probe

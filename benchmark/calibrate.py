#!/usr/bin/env python3
"""Readings that set a cell's limits, in one process for many seeds:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls 3] [--seconds 3] [--platform cpu --config F --traffic F]

For each seed, the program's readings against the reference (what a run's
check computes; a training cell runs its set-up and first three steps, no
window; a synthesis cell a short window).  For the first ``--controls``
seeds also the control's (the reference one precision below the cell's,
in the program's place: for a bf16 training cell fp8, every product's
operands in e4m3 and the gradient it receives in e5m2; TF32 for f32
serving) and the planted faults' (training: half of each batch
left out, the mean over the rest; synthesis: one returned frame altered).
A state left unchanged reads 1 by the update measure and needs no run.
One JSON line a seed and kind on standard output.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from harness import checks, launch, reference  # noqa: E402
from harness import weights as bench_weights  # noqa: E402


def _print(**kw):
    print(json.dumps(kw), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--config")
    parser.add_argument("--traffic")
    args = parser.parse_args()
    launch.set_cache_dirs()
    if args.config:
        config_path, traffic = Path(args.config), json.loads(Path(args.traffic).read_text())
    else:
        _, config_path, traffic_path = launch.resolve(args.workload)
        traffic = json.loads(traffic_path.read_text())
    device = torch.device("cuda", 0) if args.platform == "cuda" else torch.device("cpu")
    if args.platform == "cuda":
        torch.cuda.set_device(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        train = traffic["driver"] == "train"
        ctx = launch.Context(args.workload, config_path, traffic, seed, args.seconds, False,
                             device, t0=t0, window=not train)
        record, probe = launch.drive(ctx)
        weights = bench_weights.make(probe["hp"], seed, device)
        t1 = time.perf_counter()
        if train:
            ref = checks.training_reference(probe, weights, seed, device)
            readings = checks.training_readings(probe, ref)
        else:
            readings = checks.synth_readings(probe["hp"], weights, probe["calls"], device,
                                             length_scale=probe["length_scale"],
                                             speaker=probe["speaker"])
        _print(seed=seed, kind="program", ref_s=time.perf_counter() - t1,
               run_s=t1 - t0, **readings)
        if i >= args.controls:
            continue
        if train:
            for mode, half in (("fp8", False), ("f32", True)):
                planted = checks.training_reference(probe, weights, seed, device, mode=mode,
                                                    half_batch=half)
                _print(seed=seed, kind="control_fp8" if mode == "fp8" else "fault_half_batch",
                       **checks.training_readings(checks.as_program(planted), ref))
        else:
            hp, scale, spk = probe["hp"], probe["length_scale"], probe["speaker"]
            control = [(s, reference.synthesize(hp, weights, s, device, scale, "tf32",
                                                speaker=spk)) for s, _ in probe["calls"]]
            _print(seed=seed, kind="control_tf32",
                   **checks.synth_readings(hp, weights, control, device, length_scale=scale,
                                           speaker=spk))
            altered = [(s, [m.copy() for m in mels]) for s, mels in probe["calls"]]
            altered[0][1][0][:, 0] += 0.5
            _print(seed=seed, kind="fault_altered_answer",
                   **checks.synth_readings(hp, weights, altered, device, length_scale=scale,
                                           speaker=spk))
        del weights
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

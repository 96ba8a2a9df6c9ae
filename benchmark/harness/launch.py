"""One run of one cell: find its files by the names ``BENCHMARK.json``
gives, start its ranks, drive it, check it, print its line.

The cell's ``traffic`` names ``traffic/<traffic>.json``, whose ``driver``
picks the code that drives the program (``train`` or ``synth``) and whose
``ranks`` the processes (one a card; rank 0 is this process, the others
are started by it and join over NCCL through ``parallel.mesh.join``).
Each metric is read from the run's record by ``metrics/<name>.py``; the
numbers that decide ``correct`` are held to ``limits/<cell>.json``.
"""

import argparse
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
import typing
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "glow_tts_train_tpu")
CHILD_TIMEOUT = 300


@dataclasses.dataclass
class Context:
    workload: str
    config_path: Path
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: typing.Any
    rank: int = 0
    world: int = 1
    t0: float = 0.0
    window: bool = True


def forbidden_modules() -> typing.List[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels build under ``build/torch_kernels/``)."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(workload: str) -> typing.Tuple[dict, Path, Path]:
    """-> (the cell, its configuration file, its traffic file)."""
    spec = bench()
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, ROOT / config["file"], BENCH_DIR / "traffic" / f"{cell['traffic']}.json"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts, and by the tests
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                        help=argparse.SUPPRESS)
    parser.add_argument("--config-file", help=argparse.SUPPRESS)
    parser.add_argument("--traffic-file", help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def read_metric(name: str, record: dict) -> typing.Optional[float]:
    """``metrics/<name>.py``'s ``read(record)``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", BENCH_DIR / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(record)
    return None if value is None else float(value)


def applies(metric: dict, workload: str, reported_e2e: typing.Collection[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported_e2e


def metrics_of(spec: dict, workload: str, record: dict, traced: bool) -> dict:
    e2e = [m for m in spec["end_to_end"] if applies(m, workload, ())]
    names = [m["name"] for m in e2e]
    chosen = [m for m in spec["per_layer"] if applies(m, workload, names)] if traced else e2e
    out = {}
    for m in chosen:
        value = read_metric(m["name"], record)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def check(ctx: Context, record: dict, probe: dict) -> typing.Dict[str, float]:
    """The readings of this run's program against the reference."""
    from . import checks
    from . import weights as bench_weights

    weights = bench_weights.make(probe["hp"], ctx.seed, ctx.device)
    if record["driver"] == "train":
        ref = checks.training_reference(probe, weights, ctx.seed, ctx.device)
        return checks.training_readings(probe, ref)
    calls = checks.sample_calls(probe["calls"], int(ctx.traffic["checked_calls"]), ctx.seed)
    return checks.synth_readings(probe["hp"], weights, calls, ctx.device,
                                 length_scale=probe["length_scale"], speaker=probe["speaker"])


def verdict(readings: dict, limits: dict) -> bool:
    """``correct``: every number compared is finite and within its limit."""
    return all(math.isfinite(readings[k]) and readings[k] <= v for k, v in limits.items())


def drive(ctx: Context) -> typing.Tuple[dict, dict]:
    from . import synth, train

    driver = ctx.traffic["driver"]
    if driver == "train":
        return train.run(ctx)
    if driver == "synth":
        return synth.run(ctx)
    raise SystemExit(f"unknown driver {driver!r}")


def emit(result: dict, limits: dict, readings: dict) -> None:
    """The numbers compared, each beside its limit: last on standard error,
    and last in the result's line (stdout's last line)."""
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    for k in limits:
        print(f"check {k} {readings[k]!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None, t0: typing.Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    set_cache_dirs()
    cell, config_path, traffic_path = resolve(args.workload)
    if args.config_file:  # a rank started by rank 0 takes rank 0's files
        config_path, traffic_path = Path(args.config_file), Path(args.traffic_file)
    traffic = json.loads(Path(traffic_path).read_text())
    world = int(traffic.get("ranks", 1))

    import torch

    if args.platform == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload}: needs {cell['chips']} CUDA device(s), found {found}",
                  file=sys.stderr)
            return 2
    children = []
    port = args.port
    if world > 1 and args.rank == 0 and not port:  # rank 0 starts the others
        port = free_port()
        for r in range(1, world):
            cmd = [sys.executable, str(BENCH_DIR / "run.py"), "--workload", args.workload,
                   "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
                   str(args.trace), "--rank", str(r), "--port", str(port),
                   "--platform", args.platform, "--config-file", str(config_path),
                   "--traffic-file", str(traffic_path)]
            children.append(subprocess.Popen(cmd, stdout=2, cwd=str(ROOT)))
    try:
        return _run(args, config_path, traffic, world, port, t0, children)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
            child.wait()


def _run(args, config_path, traffic, world, port, t0, children) -> int:
    import torch

    from glow_tts_train_tpu_torch import parallel

    launch = parallel.Launch(args.rank, world, args.rank,
                             f"tcp://127.0.0.1:{port}" if world > 1 else None)
    device = parallel.join(launch, args.platform)
    ctx = Context(args.workload, config_path, traffic, args.seed, args.seconds,
                  bool(args.trace), device, args.rank, world, t0)
    try:
        record, probe = drive(ctx)
    finally:
        parallel.leave()
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}, which it may not", file=sys.stderr)
        return 3
    if args.rank != 0:
        return 0
    for child in children:
        code = child.wait(timeout=CHILD_TIMEOUT)
        if code != 0:
            print(f"a rank exited with {code}", file=sys.stderr)
            return 4
    from . import checks

    limits = checks.limits_of(BENCH_DIR, args.workload)
    readings = check(ctx, record, probe)
    spec = bench()
    metrics = metrics_of(spec, args.workload, record, ctx.trace)
    correct = verdict(readings, limits)
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": world,
        "memory_peak_bytes": int(record["peak_bytes"]),
    }
    result = {"correct": bool(correct and record.get("failed", 0) == 0),
              "attempted": int(record.get("calls", record.get("steps", 0))),
              "failed": int(record.get("failed", 0)), "metrics": metrics, "device": device_info}
    if ctx.trace:
        summary = record["trace"]
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops_top"],
                               "idle_gaps": summary["idle_gaps"]}
    if "epoch_s" in record:
        print(f"window epochs (s): {record['epoch_s']}", file=sys.stderr)
    print(f"readings: {json.dumps(readings)}", file=sys.stderr)
    emit(result, limits, readings)
    return 0

"""The result's line and the trace reader."""

import io
import json
import sys
from contextlib import redirect_stdout

import pytest

import harness_tiny

from harness import launch, trace

CONTRACT = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


@pytest.mark.parametrize("workload,traffic", [
    ("base.train_b384", harness_tiny.TRAIN_TRAFFIC),
    ("base.synth_b16", harness_tiny.SYNTH_TRAFFIC),
])
def test_last_line_has_the_contract_keys_only(tmp_path, monkeypatch, workload, traffic):
    config = harness_tiny.tiny_config(tmp_path)
    traffic_path = tmp_path / "traffic.json"
    traffic_path.write_text(json.dumps(traffic))
    monkeypatch.setattr(launch, "resolve",
                        lambda name: ({"name": name, "chips": 1}, config, traffic_path))
    out = io.StringIO()
    with redirect_stdout(out):
        code = launch.main(["--workload", workload, "--seed", str(2 ** 31 + 3), "--seconds",
                            "0.5", "--platform", "cpu"])
    assert code == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) <= CONTRACT and set(line) >= CONTRACT - {"breakdown"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    spec = launch.bench()
    wanted = {m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == wanted
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for number in line["checks"].values():
        assert set(number) == {"value", "limit"}


def test_no_result_without_the_cards_the_cell_asks_for(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = launch.main(["--workload", "base.train_b384", "--seed", "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""


def _events():
    # device ops [0, 10), [5, 20), [32, 40), an NCCL kernel [50, 55); host ops
    device = [("k_a", 0, 10), ("k_b", 5, 20), ("k_a", 32, 40), ("ncclDevKernel_AllReduce", 50, 55)]
    host = [("cudaLaunchKernel", 0, 1, 7), ("aten::step", 0, 60, 7),
            ("aten::copy_", 22, 28, 7), ("collate", 41, 49, 9)]
    return trace.Events(device, host)


def test_union_busy_counts_and_breakdown():
    summary = trace.summarize(_events(), window_s=60e-9)
    assert summary["busy_s"] == pytest.approx(33e-9)
    assert summary["device_ops"] == 4
    assert summary["nccl_s"] == pytest.approx(5e-9)
    assert summary["device_ops_top"][0] == ["k_a", pytest.approx(18e-9)]
    gaps = summary["idle_gaps"]
    # the longest gap [20, 32) is named by the innermost op open on the launching thread
    assert gaps[0] == ["host: aten::copy_", pytest.approx(12e-9)]
    assert gaps[1] == ["host: aten::step", pytest.approx(10e-9)]


def test_a_trace_without_device_records_is_retried_then_fails(monkeypatch):
    import torch

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    tries = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr("torch.profiler.profile", Profile)
    monkeypatch.setattr(trace, "events_of",
                        lambda prof: _events() if len(tries) >= 3 else trace.Events([], []))
    result, summary = trace.traced(lambda: tries.append(1) or len(tries), "cuda")
    assert result == 3 and summary["device_ops"] == 4
    tries.clear()
    monkeypatch.setattr(trace, "events_of", lambda prof: trace.Events([], []))
    with pytest.raises(RuntimeError):
        trace.traced(lambda: tries.append(1), "cuda")
    assert len(tries) == trace.TRIES


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil
    import subprocess

    shutil.copy(harness_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness_tiny.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base.synth_b16",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--platform", "cpu"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""

"""A data-parallel cell on the CPU: two gloo ranks, rank 0 this process
and rank 1 started by it, each driving ``training.train`` on its shard;
the reference over the global batch agrees with them."""

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout

import harness_tiny

from harness import launch


def test_two_ranks_agree_with_the_reference_over_the_global_batch(tmp_path, monkeypatch):
    config = harness_tiny.tiny_config(tmp_path)
    traffic = dict(harness_tiny.TRAIN_TRAFFIC, batch_size=4, ranks=2)
    traffic_path = tmp_path / "traffic.json"
    traffic_path.write_text(json.dumps(traffic))
    monkeypatch.setattr(launch, "resolve",
                        lambda name: ({"name": name, "chips": 2}, config, traffic_path))
    out = io.StringIO()
    with redirect_stdout(out):
        code = launch.main(["--workload", "base.train_b384", "--seed", str(2 ** 33 + 1),
                            "--seconds", "0.5", "--platform", "cpu"])
    assert code == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["device"]["count"] == 2
    checks = line["checks"]
    assert line["correct"] is True
    # every number compared reads at round-off (a change over steps at 1e-3)
    for name, number in checks.items():
        assert number["value"] < (1e-3 if name.startswith("update") else 1e-6), name


def test_ranks_that_leave_out_the_exchange_are_not_correct(tmp_path):
    """Every rank's all-reduce left out (each trains on its own rows): rank
    0's check against the global batch fails by the cell's limits."""
    config = harness_tiny.tiny_config(tmp_path)
    traffic = dict(harness_tiny.TRAIN_TRAFFIC, batch_size=4, ranks=2)
    traffic_path = tmp_path / "traffic.json"
    traffic_path.write_text(json.dumps(traffic))
    port = launch.free_port()
    script = f"""
import sys
sys.path[:0] = [{str(harness_tiny.ROOT)!r}, {str(harness_tiny.BENCH_DIR)!r}]
from glow_tts_train_tpu_torch import parallel
parallel.all_reduce_sum = lambda tensors: list(tensors)
from harness import launch
sys.exit(launch.main(sys.argv[1:]))
"""
    args = ["--workload", "base.train_b384", "--seed", "12345", "--seconds", "0.5",
            "--platform", "cpu", "--port", str(port), "--config-file", str(config),
            "--traffic-file", str(traffic_path)]
    procs = [subprocess.Popen([sys.executable, "-c", script, *args, "--rank", str(r)],
                              stdout=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    line = json.loads(outs[0].strip().splitlines()[-1])
    readings = {k: v["value"] for k, v in line["checks"].items()}
    assert line["correct"] is False
    assert not harness_tiny.correct(readings, "base.train_b384")

"""Every name in BENCHMARK.json resolves to its files, and the file keeps to
the benchmark's contract."""

import json
import re

import harness_tiny

ROOT, BENCH_DIR = harness_tiny.ROOT, harness_tiny.BENCH_DIR
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_cells_resolve_to_config_traffic_and_limits():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        config = configs[cell["config"]]
        assert (ROOT / config["file"]).is_file()
        traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
        assert traffic["driver"] in ("train", "synth")
        assert cell["chips"] >= traffic.get("ranks", 1)
        limits = json.loads((BENCH_DIR / "limits" / f"{cell['name']}.json").read_text())
        for number in limits["numbers"].values():
            assert number["lower"] < number["limit"] < number["upper"] or number["limit"] == 0


def test_every_config_is_used_and_states_its_cut():
    used = {c["config"] for c in SPEC["workloads"]}
    for config in SPEC["configs"]:
        assert config["name"] in used
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]
        assert data["fp16_run"] is True


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {c["name"] for c in SPEC["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
        assert set(metric.get("workloads", cells)) <= cells
    for metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in SPEC["per_layer"]:
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in SPEC["workloads"]:
        name = cell["name"]
        e2e = [m["name"] for m in SPEC["end_to_end"] if name in m.get("workloads", [name])]
        layers = [m for m in SPEC["per_layer"] if name in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(SPEC)) < 64 * 1024

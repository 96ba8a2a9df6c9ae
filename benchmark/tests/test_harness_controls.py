"""The control, the reference one precision below what a cell states put in
the program's place, comes out as not correct through a run's own
comparison (``launch.main``, the cell's own limits): TF32 for the f32
synthesis cell at its own size, on the card alone (the CPU has no TF32;
the test skips elsewhere); fp8 for the bf16 training cells at tiny widths
on the CPU.  At the training cells' own size the fp8 control fails no
number on every seed (PERF.md, Open questions), so no such test is kept."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

import harness_tiny

from harness import checks, launch, reference
from harness import weights as bench_weights

TRAIN_CELLS = ["base.train_b384", "multispeaker.train_b384"]


def _train_control(drive):
    """``launch.drive`` with the program's losses, first gradient and
    weights replaced by the fp8 reference's over the same batches."""

    def control_drive(ctx):
        record, probe = drive(ctx)
        weights = bench_weights.make(probe["hp"], ctx.seed, ctx.device)
        fp8 = checks.training_reference(probe, weights, ctx.seed, ctx.device, mode="fp8")
        probe.update(checks.as_program(fp8))
        return record, probe

    return control_drive


def _synth_control(drive):
    """``launch.drive`` with every noise-free call's mels replaced by the
    TF32 reference's of the same sentences."""

    def control_drive(ctx):
        record, probe = drive(ctx)
        weights = bench_weights.make(probe["hp"], ctx.seed, ctx.device)
        probe["calls"] = [
            (sentences, reference.synthesize(probe["hp"], weights, sentences, ctx.device,
                                             probe["length_scale"], "tf32",
                                             speaker=probe["speaker"]))
            for sentences, _ in probe["calls"]]
        return record, probe

    return control_drive


def _line(argv) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        code = launch.main(argv)
    assert code == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_fp8_control_is_not_correct_at_tiny_width(tmp_path, monkeypatch, workload):
    name = workload.split(".")[0]
    config = harness_tiny.tiny_config(tmp_path, name)
    traffic = dict(harness_tiny.TRAIN_TRAFFIC, speakers=5 if name == "multispeaker" else 1)
    traffic_path = tmp_path / "traffic.json"
    traffic_path.write_text(json.dumps(traffic))
    monkeypatch.setattr(launch, "resolve",
                        lambda cell: ({"name": cell, "chips": 1}, config, traffic_path))
    monkeypatch.setattr(launch, "drive", _train_control(launch.drive))
    line = _line(["--workload", workload, "--seed", str(2 ** 31 + 41), "--seconds", "0.2",
                  "--platform", "cpu"])
    assert line["correct"] is False


def test_tf32_control_is_not_correct_at_the_cells_size(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(launch, "drive", _synth_control(launch.drive))
    line = _line(["--workload", "base.synth_b16", "--seed", str(2 ** 31 + 47), "--seconds", "2"])
    assert line["correct"] is False

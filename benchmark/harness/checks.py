"""The comparisons that decide ``correct``, and their numbers.

Training (after the window, the program's state freed): the reference's
DDI and first three steps from the same weights over the same global
batches, then

* ``loss_gap``: the largest of the three steps' |loss - reference| over
  max(|reference|, 1); ``mle_gap`` the same of the loss's MLE term alone
  (the duration term moves with every frame that MAS gives to the
  neighbouring phoneme, which rounding of any precision does);
* ``grad_gap``: the first gradient as Adam got it (its first moment over
  1 - beta1), by the worst leaf: the gap between the program's norm of the
  leaf and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``update_gap``: the same of the weights' change over the three steps,
  leaving out the leaves whose reference gradient is nought to rounding
  (under a thousandth of the median leaf's, by the largest of the three
  steps), which Adam moves by round-off alone.

Synthesis: every noise-free call of the window, each sentence against the
reference's mel of it: ``mel_gap`` the largest |mel - reference| over the
reference's RMS, and ``frame_mismatch`` the sentences whose frame count
differs (a phoneme whose duration lies within :data:`BOUNDARY` of a frame
boundary may round either way, and both roundings are tried).
"""

import itertools
import json
import math
import typing
from pathlib import Path

import numpy as np
import torch

from . import reference

BOUNDARY = 1e-3
MAX_AMBIGUOUS = 3
# a sentence whose mel lies this close to the reference's is settled
# without trying the other roundings of its boundary phonemes
SETTLED = 1e-4


def limits_of(bench_dir: Path, workload: str) -> dict:
    """{number: limit} of a cell, from ``limits/<workload>.json``."""
    data = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    return {k: float(v["limit"]) for k, v in data["numbers"].items()}


def _norms(tensors: typing.Mapping[str, torch.Tensor]) -> typing.Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: typing.Mapping[str, torch.Tensor],
              ref: typing.Mapping[str, torch.Tensor]) -> typing.Dict[str, float]:
    """Per leaf: |‖program‖ - ‖reference‖| / max(‖reference‖, median
    leaf's ‖reference‖)."""
    p_n, r_n = _norms({k: program[k] for k in ref}), _norms(ref)
    median = float(np.median(list(r_n.values())))
    return {k: abs(p_n[k] - r_n[k]) / max(r_n[k], median, 1e-30) for k in ref}


def worst_leaf(program, ref) -> typing.Tuple[float, str]:
    """The largest of :func:`leaf_gaps` -> (gap, leaf)."""
    gaps = leaf_gaps(program, ref)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def live_leaves(ref_grads: typing.Sequence[typing.Mapping[str, torch.Tensor]]) -> typing.List[str]:
    """Leaves whose reference gradient (the largest over the steps) is at
    least a thousandth of the median leaf's."""
    per_step = [_norms(g) for g in ref_grads]
    largest = {k: max(step[k] for step in per_step) for k in per_step[0]}
    median = float(np.median(list(largest.values())))
    return [k for k, v in largest.items() if v >= 1e-3 * median]


def _step_gaps(program: typing.Sequence[float], ref: typing.Sequence[float]) -> typing.List[float]:
    return [abs(p - r) / max(abs(r), 1.0) for p, r in zip(program, ref)]


def training_readings(program: dict, ref: dict) -> typing.Dict[str, float]:
    """The numbers of a program (or a control in its place) against the
    reference; ``program`` holds loss, mle, grad1, theta0, theta3."""
    losses = _step_gaps(program["loss"], ref["loss"])
    mles = _step_gaps(program["mle"], ref["mle"])
    durs = _step_gaps([lp - mp for lp, mp in zip(program["loss"], program["mle"])],
                      [lr - mr for lr, mr in zip(ref["loss"], ref["mle"])])
    grad_p = math.sqrt(sum(float(torch.sum(program["grad1"][k].double() ** 2))
                           for k in ref["grad1"]))
    grad_r = math.sqrt(sum(float(torch.sum(v.double() ** 2)) for v in ref["grad1"].values()))
    grads = leaf_gaps(program["grad1"], ref["grad1"])
    live = live_leaves(ref["ref_grads"])
    delta_p = {k: program["theta3"][k] - program["theta0"][k] for k in live}
    delta_r = {k: ref["theta_end"][k] - ref["theta0"][k] for k in live}
    updates = leaf_gaps(delta_p, delta_r)
    grad_leaf, update_leaf = max(grads, key=grads.get), max(updates, key=updates.get)
    # the numbers compared are those in limits/<cell>.json; the others are for the record
    return {"loss_gap": max(losses), "mle_gap": max(mles), "grad_gap": grads[grad_leaf],
            "update_gap": updates[update_leaf], "loss1_gap": losses[0],
            "mle1_gap": mles[0], "dur_gap": max(durs),
            "grad_global_gap": abs(grad_p - grad_r) / max(grad_r, 1e-30),
            "grad_median_gap": float(np.median(list(grads.values()))),
            "update_median_gap": float(np.median(list(updates.values()))),
            "grad_leaf": grad_leaf, "update_leaf": update_leaf,
            "left_out": sorted(set(ref["grad1"]) - set(live))}


def as_program(ref_run: dict) -> dict:
    """A reference run put in the program's place."""
    return {"loss": ref_run["loss"], "mle": ref_run["mle"], "grad1": ref_run["grad1"],
            "theta0": ref_run["theta0"], "theta3": ref_run["theta_end"]}


def training_reference(probe: dict, weights: dict, seed: int, device, mode: str = "f32",
                       half_batch: bool = False, block_rows: int = 64) -> dict:
    return reference.train(probe["hp"], probe["opt"], weights, probe["ddi"], probe["batches"],
                           seed, device, mode=mode, block_rows=block_rows, half_batch=half_batch)


# --------------------------------------------------------------------------
# synthesis
# --------------------------------------------------------------------------

def _roundings(dur: np.ndarray):
    """The frame counts a phoneme of duration ``dur`` may round to: its
    ceiling, and for durations within BOUNDARY of an integer both sides."""
    ceil = np.ceil(dur)
    near = np.abs(dur - np.round(dur)) < BOUNDARY
    options = []
    for j in np.flatnonzero(near)[:MAX_AMBIGUOUS]:
        n = np.round(dur[j])
        options.append((j, (n, n + 1)))
    return ceil, options


def synth_readings(hp: dict, weights: dict, calls, device, mode: str = "f32",
                   length_scale: float = 1.0, speaker=None) -> dict:
    """``calls``: [(sentences, mels of the program)] -> mel_gap and
    frame_mismatch over every sentence."""
    mel_gap, mismatch, count = 0.0, 0, 0
    for sentences, mels in calls:
        refs, durs = reference.synthesize(hp, weights, sentences, device, length_scale, mode,
                                          speaker=speaker, with_durations=True)
        for i, (dur, ref, got) in enumerate(zip(durs, refs, mels)):
            count += 1
            gap = _gap(got, ref)
            ceil, options = _roundings(dur)
            if gap > SETTLED and options:
                for choice in itertools.product(*[o for _, o in options]):
                    frames = ceil.copy()
                    for (j, _), value in zip(options, choice):
                        frames[j] = value
                    other = reference.synthesize(hp, weights, [sentences[i]], device,
                                                 length_scale, mode, frames=[frames],
                                                 speaker=speaker)[0]
                    gap = min(gap, _gap(got, other))
            if math.isinf(gap):
                mismatch += 1
            else:
                mel_gap = max(mel_gap, gap)
    return {"mel_gap": mel_gap, "frame_mismatch": float(mismatch), "sentences": count}


def _gap(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| over the reference's RMS; infinite where the frame
    counts differ."""
    if got.shape != ref.shape:
        return math.inf
    return float(np.max(np.abs(got - ref))) / max(math.sqrt(float(np.mean(ref * ref))), 1e-6)


def sample_calls(calls: list, count: int, seed: int) -> list:
    """``count`` of the noise-free calls drawn from the seed, the one with
    the longest sentence among them."""
    if len(calls) <= count:
        return list(calls)
    longest = max(range(len(calls)), key=lambda i: max(len(s) for s in calls[i][0]))
    rest = [i for i in range(len(calls)) if i != longest]
    rng = np.random.default_rng(int(seed))
    chosen = [longest] + sorted(rng.choice(rest, size=count - 1, replace=False).tolist())
    return [calls[i] for i in chosen]

"""The traffic generators: deterministic in the seed, with the lengths the
traffic files state, and the same multiset of sizes on every seed."""

import json

import numpy as np
import pytest
import torch

import harness_tiny

from harness import corpus

BENCH_DIR = harness_tiny.BENCH_DIR


def _traffic(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["ljspeech_b384", "vctk_b384"])
def test_training_lengths_as_stated(name):
    traffic = dict(_traffic(name), utterances=512)
    ids, mels, lengths = corpus.training_corpus(traffic, 2 ** 31 + 5, 8, torch.device("cpu"))
    lo, hi = traffic["phonemes"]
    n_ph, frames = lengths[:, 0], lengths[:, 1]
    assert n_ph.min() == lo and n_ph.max() >= hi - 2
    assert np.all(frames >= 3 * n_ph) and np.all(frames <= 9 * n_ph)
    assert abs(frames.sum() / n_ph.sum() - 6.0) < 0.2
    for key, phonemes in ids.items():
        assert mels[key].shape == (8, frames[int(key[1][1:])])
        assert phonemes.min() >= 1 and phonemes.max() < traffic["symbols"]
    speakers = {k[0] for k in ids}
    assert len(speakers) == min(traffic["speakers"], 512)


def test_training_corpus_is_deterministic_and_seeds_share_sizes():
    traffic = dict(_traffic("ljspeech_b384"), utterances=256)
    device = torch.device("cpu")
    a = corpus.training_corpus(traffic, 11, 8, device)
    b = corpus.training_corpus(traffic, 11, 8, device)
    c = corpus.training_corpus(traffic, 2 ** 32 + 11, 8, device)
    assert all(np.array_equal(a[0][k], b[0][k]) and np.array_equal(a[1][k], b[1][k]) for k in a[0])
    assert not np.array_equal(a[2], c[2])
    assert sorted(map(tuple, a[2])) == sorted(map(tuple, c[2]))
    values = np.concatenate([m.ravel() for m in a[1].values()])
    assert values.min() >= -11.5 and values.max() <= 2.0


def test_synthesis_calls_are_deterministic_and_cover_the_range():
    traffic = _traffic("synth_b16")
    first, again = corpus.Calls(traffic, 9), corpus.Calls(traffic, 9)
    calls = [next(first) for _ in range(131)]
    assert calls == [next(again) for _ in range(131)]
    counts = sorted(len(s) for call in calls for s in call)
    lo, hi = traffic["phonemes"]
    assert all(len(call) == traffic["batch"] for call in calls)
    assert counts == sorted(list(range(lo, hi + 1)) * traffic["batch"])
    other = corpus.Calls(traffic, 10)
    assert calls[:3] != [next(other) for _ in range(3)]

"""Traffic: training corpora and synthesis calls, made from the seed.

The mel renderer is a vectorised copy of ``scripts/make-synthetic-corpus.py``
at commit fd792a0 (each phoneme a stable log-mel template of 2-4
formant-like bumps over a tilted floor, repeated for its frames, smoothed
by [0.15, 0.7, 0.15] at the utterance's edges clamped, a slow sine gain and
N(0, 0.15) noise, clipped to [-11.5, 2]).  What changed: every utterance
of a corpus is rendered at once on the device; the lengths come from the
traffic file; the sizes are drawn so that every seed gives the same
multiset of lengths in another order (the phoneme counts an even grid over
the traffic's range, each utterance's durations the values 3..9 in turn,
shuffled), so a seed changes which utterances meet, never the work.
"""

import typing

import numpy as np
import torch

N_BUMPS = (2, 5)


def _grid(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi]."""
    return lo + (np.arange(n) * (hi - lo + 1)) // n


def _templates(gen: torch.Generator, n_symbols: int, n_mels: int, device) -> torch.Tensor:
    """[n_symbols, n_mels] log-mel spectral template a phoneme."""
    axis = torch.linspace(0.0, 1.0, n_mels, device=device)
    n_max = N_BUMPS[1] - 1
    count = torch.randint(N_BUMPS[0], N_BUMPS[1], (n_symbols, 1), generator=gen, device=device)
    u = torch.rand((3, n_symbols, n_max), generator=gen, device=device)
    centers, widths, gains = u[0] * 0.9, 0.02 + u[1] * 0.10, 3.0 + u[2] * 5.0
    live = (torch.arange(n_max, device=device)[None, :] < count).to(torch.float32)
    bumps = gains[..., None] * torch.exp(
        -0.5 * ((axis[None, None, :] - centers[..., None]) / widths[..., None]) ** 2)
    env = -9.0 - 3.0 * axis[None, :] + torch.sum(bumps * live[..., None], dim=1)
    return torch.clamp(env, -11.5, 2.0)


def training_corpus(traffic: dict, seed: int, n_mels: int, device):
    """-> (id_phonemes, id_mels, lengths): {(speaker, utt_id): int32 ids},
    {(speaker, utt_id): f32 mel [n_mels, t]} (views of one host array), and
    the (phonemes, frames) of every utterance.  ``traffic``: utterances,
    phonemes [lo, hi], frames_per_phoneme [lo, hi], symbols, speakers."""
    n = int(traffic["utterances"])
    rng = np.random.default_rng(int(seed))
    n_ph = rng.permutation(_grid(*traffic["phonemes"], n))
    speakers = int(traffic.get("speakers", 1))
    speaker = rng.permutation(np.arange(n) % speakers) if speakers > 1 else np.zeros(n, np.int64)
    lo, hi = traffic["frames_per_phoneme"]
    cycle = np.arange(lo, hi + 1)
    durations = [rng.permutation(np.resize(cycle, k)) for k in n_ph]
    phonemes = [rng.integers(1, traffic["symbols"], size=k).astype(np.int32) for k in n_ph]

    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    templates = _templates(gen, traffic["symbols"], n_mels, device)
    ph = torch.from_numpy(np.concatenate(phonemes).astype(np.int64)).to(device)
    dur = torch.from_numpy(np.concatenate(durations).astype(np.int64)).to(device)
    frames = np.asarray([int(d.sum()) for d in durations])
    total = int(frames.sum())
    starts = np.concatenate([[0], np.cumsum(frames)[:-1]])
    mel = templates[torch.repeat_interleave(ph, dur)]  # [total, n_mels]
    utt = torch.repeat_interleave(torch.arange(n, device=device), torch.from_numpy(frames).to(device))
    start = torch.from_numpy(starts).to(device)[utt]
    last = start + torch.from_numpy(frames).to(device)[utt] - 1
    pos = torch.arange(total, device=device)
    prev = mel[torch.maximum(pos - 1, start)]
    nxt = mel[torch.minimum(pos + 1, last)]
    smooth = 0.15 * prev + 0.7 * mel + 0.15 * nxt
    span = 2.0 + 4.0 * torch.rand(n, generator=gen, device=device)
    t_len = torch.from_numpy(frames).to(device)
    phase = (pos - start).to(torch.float32) / torch.clamp(t_len[utt] - 1, min=1).to(torch.float32)
    gain = 0.5 * torch.sin(phase * span[utt])[:, None]
    noise = 0.15 * torch.randn((total, n_mels), generator=gen, device=device)
    host = torch.clamp(smooth + gain + noise, -11.5, 2.0).cpu().numpy()

    id_phonemes, id_mels = {}, {}
    for i in range(n):
        key = (int(speaker[i]), f"u{i:06d}")
        id_phonemes[key] = phonemes[i]
        id_mels[key] = host[starts[i]:starts[i] + frames[i]].T
    return id_phonemes, id_mels, np.stack([n_ph, frames], axis=1)


class Calls:
    """The synthesis cell's stream of calls: each ``batch`` sentences,
    their phoneme counts taken in turn from shuffled blocks that hold every
    count of [lo, hi] once, the ids uniform over the symbols."""

    def __init__(self, traffic: dict, seed: int):
        self.rng = np.random.default_rng(int(seed))
        self.batch = int(traffic["batch"])
        self.lo, self.hi = traffic["phonemes"]
        self.symbols = int(traffic["symbols"])
        self.pool: typing.List[int] = []

    def __next__(self) -> typing.List[typing.List[int]]:
        while len(self.pool) < self.batch:
            self.pool.extend(self.rng.permutation(np.arange(self.lo, self.hi + 1)).tolist())
        counts, self.pool = self.pool[:self.batch], self.pool[self.batch:]
        return [self.rng.integers(1, self.symbols, size=k).tolist() for k in counts]

    def __iter__(self):
        return self

"""The one traffic generator: every mix under `traffic/` is parameters for it.

A mix fixes a pool of utterances (durations drawn once from `shape_seed`,
so every run seed gets the same sizes) and cuts it into a fixed set of
batches:

  * training (`batch_audio_s`): duration buckets `bucket_s` wide, each
    utterance padded to its bucket's upper edge, as many a batch as fit in
    `batch_audio_s` of padded audio; a bucket's last, partial batch is
    dropped; targets of round(`targets_per_s` * duration) pieces;
  * serving (`batch`): batches of `batch` utterances in arrival order,
    padded to the longest rounded up to `pad_to_s`.

The batches' order, epoch by epoch, is drawn from `shape_seed` too, so
every run does the same work in its window.  The run seed draws the
waveforms (white noise) and the target pieces (and, elsewhere, the
weights); no size, shape or order depends on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Batch:
    rows: tuple            # utterance indices into the pool
    samples: tuple         # valid samples of each row
    pad_samples: int       # the batch's padded length
    targets: tuple         # pieces of each row (0 when untrained-for)
    pad_targets: int

    def audio_s(self, sample_rate: int) -> float:
        """Unpadded audio seconds."""
        return sum(self.samples) / sample_rate


def seeds(seed: int, n: int) -> list:
    """n independent 63-bit seeds derived from a run seed."""
    states = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in states]


def durations(traffic: dict) -> np.ndarray:
    d = traffic["duration_s"]
    rng = np.random.default_rng(traffic["shape_seed"])
    if d["dist"] != "gamma":
        raise ValueError(f"unknown duration distribution {d['dist']!r}")
    shape = (d["mean"] / d["sd"]) ** 2
    out = rng.gamma(shape, d["sd"] ** 2 / d["mean"], traffic["utterances"])
    return np.clip(out, d["min"], d["max"])


def batches(traffic: dict, cfg: dict) -> list:
    """The mix's fixed batch set, in the pool's order."""
    sr = cfg["sample_rate"]
    dur = durations(traffic)
    samples = np.round(dur * sr).astype(np.int64)
    rate = traffic.get("targets_per_s", 0.0)
    pieces = np.maximum(1, np.round(rate * dur)).astype(np.int64) if rate \
        else np.zeros_like(samples)
    out = []
    if "batch_audio_s" in traffic:
        width, lo = traffic["bucket_s"], traffic["duration_s"]["min"]
        bucket = np.floor((dur - lo) / width).astype(np.int64)
        for b in np.unique(bucket):
            rows = np.flatnonzero(bucket == b)
            edge = min(lo + (b + 1) * width, traffic["duration_s"]["max"])
            pad = int(round(edge * sr))
            per = max(1, int(traffic["batch_audio_s"] // edge))
            pad_t = int(max(1, round(rate * edge)))
            for i in range(0, len(rows) - per + 1, per):
                r = rows[i:i + per]
                out.append(Batch(tuple(r), tuple(samples[r]), pad,
                                 tuple(pieces[r]), pad_t))
    else:
        size, step = traffic["batch"], traffic["pad_to_s"] * sr
        for i in range(0, len(dur) - size + 1, size):
            r = np.arange(i, i + size)
            pad = int(math.ceil(samples[r].max() / step) * step)
            out.append(Batch(tuple(r), tuple(samples[r]), pad,
                             tuple(pieces[r]), int(max(pieces[r].max(), 1))))
    return out


def order(traffic: dict, n_batches: int, epoch: int) -> np.ndarray:
    """The order of the batch set in one epoch, drawn from `shape_seed`."""
    return np.random.default_rng([traffic["shape_seed"], epoch]).permutation(
        n_batches)


class Schedule:
    """The batch sequence of a run: epoch after epoch of the batch set,
    each in its `order`."""

    def __init__(self, traffic: dict, n_batches: int):
        self.traffic, self.n = traffic, n_batches
        self._orders = {}

    def index(self, k: int) -> int:
        """The batch set's index of the run's k-th batch."""
        epoch, j = divmod(k, self.n)
        if epoch not in self._orders:
            self._orders[epoch] = order(self.traffic, self.n, epoch)
        return int(self._orders[epoch][j])


def materialise(batch: Batch, cfg: dict, gen: torch.Generator, device):
    """(waves (B, pad) float32, num_samples (B,) int64, targets (B, S)
    int64 padded with 0, target lengths (B,) int64) on `device`, drawn
    from `gen`: noise of standard deviation 0.1 in the valid samples,
    pieces uniform over 1 .. V - 1."""
    n = len(batch.rows)
    lens = torch.tensor(batch.samples, device=device)
    wave = 0.1 * torch.randn((n, batch.pad_samples), generator=gen,
                             device=device)
    wave *= torch.arange(batch.pad_samples, device=device)[None] < lens[:, None]
    tl = torch.tensor(batch.targets, device=device)
    tgt = torch.randint(1, cfg["vocab_size"], (n, batch.pad_targets),
                        generator=gen, device=device)
    tgt *= torch.arange(batch.pad_targets, device=device)[None] < tl[:, None]
    return wave, lens, tgt, tl

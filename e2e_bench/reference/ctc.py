"""The Conformer-CTC model and what the benchmark reads of it: the mean CTC
loss (each sample's negative log-likelihood over its target length,
averaged; infeasible samples count 0), per-frame log-probs, a best path's
score and a transcript's Viterbi score.  The lattice sums run in float64
(`torch.nn.functional.ctc_loss` and a NumPy Viterbi)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import conformer, frontend


def spec(cfg: dict):
    return conformer.encoder_spec("encoder.", cfg, cfg["vocab_size"])


def log_probs(w, cfg, wave, num_samples, p):
    """(N, samples) waveforms -> ((N, T', V) float32 log-probs, (N,) T')."""
    feats = frontend.log_mel(wave, cfg, p)
    frames = frontend.num_frames(num_samples, cfg["n_fft"], cfg["hop_length"])
    logits, lengths = conformer.encode(w, "encoder.", feats, frames, cfg, p)
    return torch.log_softmax(logits, dim=-1), lengths


def loss(w, cfg, wave, num_samples, targets, target_lengths, p):
    """The training objective, float64."""
    lp, lengths = log_probs(w, cfg, wave, num_samples, p)
    return F.ctc_loss(lp.transpose(0, 1).double(), targets.long(), lengths,
                      target_lengths.long(), blank=cfg["blank"],
                      reduction="mean", zero_infinity=True)


def best_path_score(lp: np.ndarray) -> float:
    """Sum over frames of the best log-prob, (T, V) float64."""
    return float(lp.max(axis=1).sum())


def collapse(path, blank: int) -> list:
    out, prev = [], None
    for s in path:
        if s != prev and s != blank:
            out.append(int(s))
        prev = s
    return out


def viterbi(lp: np.ndarray, tokens, blank: int) -> float:
    """The best alignment's log-prob of `tokens` under (T, V) float64
    log-probs; -inf where none fits in T frames."""
    t_max = lp.shape[0]
    ext = [blank]
    for s in tokens:
        ext += [int(s), blank]
    ext = np.array(ext)
    L = len(ext)
    skip = np.zeros(L, bool)  # a label may follow the label two back
    skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    a = np.full(L, -np.inf)
    a[0] = lp[0, ext[0]]
    if L > 1:
        a[1] = lp[0, ext[1]]
    for t in range(1, t_max):
        prev1 = np.concatenate([[-np.inf], a[:-1]])
        prev2 = np.where(skip, np.concatenate([[-np.inf, -np.inf], a[:-2]]),
                         -np.inf)
        a = np.maximum(np.maximum(a, prev1), prev2) + lp[t, ext]
    return float(max(a[-1], a[-2] if L > 1 else -np.inf))


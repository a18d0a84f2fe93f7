"""Greedy (best-path) CTC decoding, vectorised over the batch (torch port of
`end2end_tpu/ops/greedy.py`).

argmax over the vocabulary -> drop repeats -> drop blanks -> left-compact the
kept symbols with a cumsum-scatter.  A handful of elementwise passes; there is
no kernel to write for it.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span


def _as_time_major(log_probs, from_logits, batch_first):
    log_probs = torch.as_tensor(log_probs)
    if batch_first:
        log_probs = log_probs.transpose(0, 1)
    if from_logits:
        log_probs = torch.log_softmax(log_probs, dim=-1)
    return log_probs


def _collapse(ids, input_lengths, blank):
    """ids (T, N) -> ids, keep mask, scatter slots, valid-frame mask, each
    (N, T)."""
    t_max, n = ids.shape
    il = (torch.full((n,), t_max, device=ids.device)
          if input_lengths is None
          else torch.as_tensor(input_lengths, device=ids.device))
    ids_nt = ids.T
    t_mask = (torch.arange(t_max, device=ids.device)[None, :]
              < il[:, None])
    prev = torch.cat([torch.full((n, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids_nt[:, :-1]], dim=1)
    keep = (ids_nt != blank) & (ids_nt != prev) & t_mask
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    # dropped symbols go to a spare column t_max, sliced off afterwards
    slot = torch.where(keep, pos, torch.full_like(pos, t_max))
    return ids_nt, keep, slot, t_mask


def _scatter(values, slot, pad_id):
    n, t_max = values.shape
    out = torch.full((n, t_max + 1), pad_id, dtype=torch.int32,
                     device=values.device)
    out.scatter_(1, slot, values.to(torch.int32))
    return out[:, :t_max]


def greedy_decode_from_path(ids, best, input_lengths=None, blank: int = 0,
                            pad_id: int = -1):
    """Collapse a precomputed best path: ids (T, N) argmax ids, best (T, N)
    their log-probs.  Same returns as `greedy_decode`."""
    ids = torch.as_tensor(ids).to(torch.int32)
    ids_nt, keep, slot, t_mask = _collapse(ids, input_lengths, blank)
    tokens = _scatter(ids_nt, slot, pad_id)
    lengths = keep.sum(dim=1).to(torch.int32)
    scores = torch.where(t_mask, best.T, torch.zeros_like(best.T)).sum(dim=1)
    return tokens, lengths, scores


def greedy_decode(log_probs, input_lengths=None, blank: int = 0,
                  pad_id: int = -1, from_logits: bool = False,
                  batch_first: bool = False):
    """Decode the best path and collapse it.

    Args:
      log_probs: (T, N, C) log-probabilities (or logits: argmax is the same).
      input_lengths: (N,) valid frame counts; default T for every sample.
      blank: blank label id.
      pad_id: fill value for the padded tail of the token matrix.
      from_logits: apply log_softmax first (tokens are unchanged, `scores`
        become true path log-probs).
      batch_first: accept (N, T, C).

    Returns:
      tokens (N, T) int32 left-aligned ids, pad_id elsewhere; lengths (N,)
      int32; scores (N,) sum of the best-path log-probs over valid frames.
    """
    with span("ctc.greedy"):
        log_probs = _as_time_major(log_probs, from_logits, batch_first)
        best, ids = log_probs.max(dim=-1)
        return greedy_decode_from_path(ids, best, input_lengths, blank=blank,
                                       pad_id=pad_id)


def greedy_decode_with_timestamps(log_probs, input_lengths=None,
                                  blank: int = 0, pad_id: int = -1,
                                  from_logits: bool = False,
                                  batch_first: bool = False):
    """`greedy_decode` plus the frame at which each emitted token first fires
    (the start of its repeat run).  Returns (tokens, lengths, scores, times),
    times (N, T) int32 aligned with tokens, pad_id where tokens is padded."""
    log_probs = _as_time_major(log_probs, from_logits, batch_first)
    best, ids = log_probs.max(dim=-1)
    ids_nt, keep, slot, t_mask = _collapse(ids.to(torch.int32),
                                           input_lengths, blank)
    n, t_max = ids_nt.shape
    frames = torch.arange(t_max, device=ids.device).expand(n, t_max)
    tokens = _scatter(ids_nt, slot, pad_id)
    times = _scatter(frames, slot, pad_id)
    lengths = keep.sum(dim=1).to(torch.int32)
    scores = torch.where(t_mask, best.T, torch.zeros_like(best.T)).sum(dim=1)
    return tokens, lengths, scores, times


class GreedyCTCDecoder:
    """Class-style greedy decoder: optional label alphabet; `decode()`
    returns python lists (or joined strings with labels) and path scores."""

    def __init__(self, blank: int = 0, labels=None, from_logits: bool = False,
                 batch_first: bool = False):
        self.blank = blank
        self.labels = list(labels) if labels is not None else None
        self.from_logits = bool(from_logits)
        self.batch_first = bool(batch_first)

    def decode(self, log_probs, input_lengths=None):
        tokens, lengths, scores = greedy_decode(
            log_probs, input_lengths, blank=self.blank,
            from_logits=self.from_logits, batch_first=self.batch_first)
        tokens, lengths = tokens.cpu(), lengths.cpu()
        out = []
        for i in range(tokens.shape[0]):
            ids = tokens[i, : int(lengths[i])].tolist()
            out.append("".join(self.labels[c] for c in ids)
                       if self.labels else ids)
        return out, scores.cpu().tolist()

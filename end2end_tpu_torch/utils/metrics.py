"""Evaluation metrics for ASR/OCR: edit distance, WER, CER (torch port of
`end2end_tpu/utils/metrics.py`).

Two forms:

  * `edit_distance` / `wer` / `cer` / `corpus_wer`: plain NumPy
    Levenshtein for host-side scoring of decoded strings/id-lists (copies
    of the JAX package's).
  * `batch_edit_distance`: a batched DP over padded id matrices on the
    tensors' device, the anti-diagonal formulation of the JAX package
    (two carry rows, vectorised over the batch).  It is a loop of
    La + Lb - 1 steps driven from the host; on the card each step is a
    handful of small launches (PERF.md has its time at the MWER slice's
    shape; ROADMAP.md lists a kernel for it as an open lever).
"""

from __future__ import annotations

import numpy as np
import torch


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences (lists/arrays/strings)."""
    a, b = list(a), list(b)
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    cur = np.empty(len(b) + 1, np.int64)
    for i, ca in enumerate(a, 1):
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev, cur = cur, prev
    return int(prev[len(b)])


def wer(ref: str, hyp: str) -> float:
    """Word error rate between two strings (whitespace tokenization)."""
    r, h = ref.split(), hyp.split()
    if not r:
        return 0.0 if not h else float("inf")
    return edit_distance(r, h) / len(r)


def cer(ref: str, hyp: str) -> float:
    """Character error rate between two strings."""
    if not ref:
        return 0.0 if not hyp else float("inf")
    return edit_distance(ref, hyp) / len(ref)


def corpus_wer(refs, hyps) -> float:
    """Corpus-level WER: total edits over total reference words."""
    edits = words = 0
    for r, h in zip(refs, hyps):
        edits += edit_distance(r.split(), h.split())
        words += len(r.split())
    return edits / max(words, 1)


def batch_edit_distance(a, a_lens, b, b_lens):
    """Batched Levenshtein: a (N, La), b (N, Lb) integer ids, padded (the
    padding ignored through the lengths).  Returns (N,) int32 distances
    between a[i, :a_lens[i]] and b[i, :b_lens[i]], on a's device.

    Anti-diagonal DP over diagonals k = i + j: cell (i, j) needs
    D[i-1, j], D[i, j-1], D[i-1, j-1], all on the previous two diagonals,
    so the loop carries two (N, La+1) rows (slot index = i).  What does
    not depend on the carry is built before the loop: each diagonal's
    column indices into b, and its boundary cells (D[0, j] = j, D[i, 0] =
    i, and a large value off the table) as one mask and one value row; a
    step then takes ~12 launches, and keeps only slot a_len of its
    diagonal.
    """
    a = torch.as_tensor(a)
    dev = a.device
    a = a.long()
    b = torch.as_tensor(b, device=dev).long()
    n, la = a.shape
    lb = b.shape[1]
    a_lens = torch.as_tensor(a_lens, device=dev).long()
    b_lens = torch.as_tensor(b_lens, device=dev).long()
    if la == 0 or lb == 0:
        return torch.maximum(a_lens, b_lens).to(torch.int32)
    big = la + lb + 1
    i_idx = torch.arange(la + 1, device=dev)
    ks = torch.arange(la + lb + 1, device=dev)[:, None]
    j_idx = ks - i_idx  # (K, La+1): diagonal k's column at slot i
    b_col = (j_idx - 1).clamp(0, lb - 1)
    fixed = (i_idx == 0) | (j_idx == 0) | (j_idx < 0) | (j_idx > lb)
    fixed_val = torch.where((j_idx >= 0) & (j_idx <= lb),
                            torch.where(i_idx == 0, j_idx, i_idx), big)
    ai = a[:, (i_idx - 1).clamp(0, la - 1)]  # (N, La+1), the same each step
    slot = a_lens.clamp(0, la)[:, None]
    d_prev2 = torch.zeros((n, la + 1), dtype=torch.long, device=dev)
    d_prev = torch.full((n, la + 1), big, dtype=torch.long, device=dev)
    d_prev[:, :2] = 1  # diagonal 1: D[0, 1] = D[1, 0] = 1
    at_slot = torch.zeros((la + lb + 1, n), dtype=torch.long, device=dev)
    for k in range(2, la + lb + 1):
        sub = d_prev2.roll(1, dims=1) + (ai != b[:, b_col[k]])  # D[i-1, j-1]
        d = torch.minimum(torch.minimum(sub, d_prev.roll(1, dims=1) + 1),
                          d_prev + 1)  # with D[i-1, j] + 1 and D[i, j-1] + 1
        d = torch.where(fixed[k], fixed_val[k], d)
        at_slot[k] = d.gather(1, slot)[:, 0]
        d_prev2, d_prev = d_prev, d
    # each (a_len, b_len) target sits on diagonal a_len + b_len; a pair
    # with an empty side sits on diagonal 0 or 1, outside the loop
    k_n = (a_lens + b_lens).clamp(0, la + lb)
    total = at_slot.gather(0, k_n[None])[0]
    return torch.where((a_lens == 0) | (b_lens == 0),
                       torch.maximum(a_lens, b_lens),
                       total).to(torch.int32)

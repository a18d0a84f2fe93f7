"""Pure-NumPy reference implementations of the CTC loss and decoders (the
torch port's copy of `end2end_tpu/utils/reference_impl.py`, the same names
and arithmetic; it imports only numpy, so it runs wherever the port does).

Slow explicit loops in float64, used as (a) the documentation of the math
and (b) the oracle the CTC kernels and their plain versions are held to
(together with ``torch.nn.CTCLoss``), on the CPU in the tests and on the
card in ``chip_smoke.py``.

Math (Graves et al. 2006; recurrences as pinned in SURVEY.md §4.1/§4.2 and
validated against torch.nn.CTCLoss):

  Extended label sequence  l' = [b, l1, b, l2, ..., lS, b]   (length 2S+1)

  alpha[t, s] = lp[t, l'(s)] + logsumexp(alpha[t-1, s],
                                         alpha[t-1, s-1],
                                         alpha[t-1, s-2] if allowed)
  where the s-2 skip is allowed iff l'(s) is not blank and l'(s) != l'(s-2).

  loss = -logaddexp(alpha[T-1, 2S], alpha[T-1, 2S-1])

  beta~ excludes the emission at t (so alpha*beta~ counts each emission once):
  beta~[T-1, 2S] = beta~[T-1, 2S-1] = 0
  beta~[t, s] = logsumexp over allowed successors s' in {s, s+1, s+2} of
                beta~[t+1, s'] + lp[t+1, l'(s')]

  grad wrt log_probs (matches torch.nn.CTCLoss numerics):
  grad[t, c] = exp(lp[t, c]) - sum_{s: l'(s)=c} exp(alpha[t,s] + beta~[t,s] - logZ)
"""

from __future__ import annotations

import numpy as np


def _extended_labels(target: np.ndarray, blank: int) -> np.ndarray:
    s = len(target)
    ext = np.full(2 * s + 1, blank, dtype=np.int64)
    ext[1::2] = target
    return ext


def ctc_loss_ref(
    log_probs: np.ndarray,
    targets: np.ndarray,
    input_lengths: np.ndarray,
    target_lengths: np.ndarray,
    blank: int = 0,
):
    """Per-sample CTC negative log-likelihood and gradient wrt log_probs.

    Args:
      log_probs: (T, N, C) float array of log-probabilities (time-major,
        already log-softmaxed), torch.nn.CTCLoss layout.
      targets: (N, S) padded int array of target label ids.
      input_lengths: (N,) ints, each <= T.
      target_lengths: (N,) ints, each <= S.
      blank: blank label id.

    Returns:
      (losses (N,), grads (T, N, C)) in float64.  Samples with impossible
      alignments get loss = +inf and grad rows of exp(lp) (finite; callers
      apply zero_infinity semantics).
    """
    log_probs = np.asarray(log_probs, dtype=np.float64)
    T, N, C = log_probs.shape
    losses = np.zeros(N)
    grads = np.zeros_like(log_probs)
    for n in range(N):
        tn = int(input_lengths[n])
        sn = int(target_lengths[n])
        ext = _extended_labels(np.asarray(targets[n][:sn]), blank)
        L = 2 * sn + 1
        lp = log_probs[:tn, n, :]
        alpha = np.full((tn, L), -np.inf)
        alpha[0, 0] = lp[0, blank]
        if L > 1:
            alpha[0, 1] = lp[0, ext[1]]
        for t in range(1, tn):
            for s in range(L):
                a = alpha[t - 1, s]
                if s >= 1:
                    a = np.logaddexp(a, alpha[t - 1, s - 1])
                if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                    a = np.logaddexp(a, alpha[t - 1, s - 2])
                alpha[t, s] = a + lp[t, ext[s]]
        if L > 1:
            log_z = np.logaddexp(alpha[tn - 1, L - 1], alpha[tn - 1, L - 2])
        else:
            log_z = alpha[tn - 1, 0]
        losses[n] = -log_z

        # beta~ (emission at t excluded).
        beta = np.full((tn, L), -np.inf)
        beta[tn - 1, L - 1] = 0.0
        if L > 1:
            beta[tn - 1, L - 2] = 0.0
        for t in range(tn - 2, -1, -1):
            for s in range(L):
                b = beta[t + 1, s] + lp[t + 1, ext[s]]
                if s + 1 < L:
                    b = np.logaddexp(b, beta[t + 1, s + 1] + lp[t + 1, ext[s + 1]])
                if s + 2 < L and ext[s + 2] != blank and ext[s + 2] != ext[s]:
                    b = np.logaddexp(b, beta[t + 1, s + 2] + lp[t + 1, ext[s + 2]])
                beta[t, s] = b

        for t in range(tn):
            post = np.zeros(C)
            if np.isfinite(log_z):
                for s in range(L):
                    g = alpha[t, s] + beta[t, s] - log_z
                    if np.isfinite(g):
                        post[ext[s]] += np.exp(g)
            grads[t, n, :] = np.exp(lp[t]) - post
        # t >= tn rows stay zero (masked).
    return losses, grads


def greedy_decode_ref(log_probs: np.ndarray, input_lengths, blank: int = 0):
    """Greedy (best-path) CTC decoding: argmax -> collapse repeats -> drop blanks.

    Args: log_probs (T, N, C); returns list of N python lists of label ids.
    """
    T, N, C = log_probs.shape
    out = []
    for n in range(N):
        tn = int(input_lengths[n])
        ids = np.argmax(log_probs[:tn, n, :], axis=-1)
        seq = []
        prev = -1
        for t in range(tn):
            c = int(ids[t])
            if c != blank and c != prev:
                seq.append(c)
            prev = c
        out.append(seq)
    return out


def beam_search_decode_ref(
    log_probs: np.ndarray,
    input_lengths,
    beam_width: int = 8,
    blank: int = 0,
    prune_k: int | None = None,
    lm=None,
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
):
    """Prefix beam search (Hannun et al. 2014) with exact prefix merging.

    Maintains per-prefix (p_blank, p_non_blank) in log space; identical
    prefixes produced by different alignment families are merged with
    logaddexp (never max) — the correctness property SURVEY.md §6.3 calls out.

    Returns list over batch of lists of (prefix_tuple, score) sorted by score
    descending, length <= beam_width.
    """
    log_probs = np.asarray(log_probs, dtype=np.float64)
    T, N, C = log_probs.shape
    lm_memo: dict = {(): 0.0}

    def lm_total(prefix):
        """alpha * sum log p_LM(t_i | bos, t_<i) + beta * len — the shallow
        fusion term accumulated by the scan decoder (beam_search.py)."""
        if lm is None:
            return 0.0
        if prefix in lm_memo:
            return lm_memo[prefix]
        ctx = (lm.bos,) + prefix[:-1]
        val = lm_total(prefix[:-1]) + lm_alpha * lm.score(ctx, prefix[-1]) + lm_beta
        lm_memo[prefix] = val
        return val

    results = []
    for n in range(N):
        tn = int(input_lengths[n])
        # prefix -> [p_blank, p_non_blank]
        beams = {(): [0.0, -np.inf]}
        for t in range(tn):
            lp = log_probs[t, n]
            if prune_k is not None and prune_k < C:
                cand = np.argpartition(-lp, prune_k)[:prune_k]
            else:
                cand = range(C)
            new_beams: dict = {}

            def add(prefix, pb, pnb):
                cur = new_beams.setdefault(prefix, [-np.inf, -np.inf])
                cur[0] = np.logaddexp(cur[0], pb)
                cur[1] = np.logaddexp(cur[1], pnb)

            for prefix, (pb, pnb) in beams.items():
                total = np.logaddexp(pb, pnb)
                # blank: prefix unchanged, ends in blank
                add(prefix, total + lp[blank], -np.inf)
                # repeat last char without separator: prefix unchanged
                if prefix:
                    add(prefix, -np.inf, pnb + lp[prefix[-1]])
                for c in cand:
                    c = int(c)
                    if c == blank:
                        continue
                    if prefix and c == prefix[-1]:
                        # only the blank-ending mass can extend with same char
                        add(prefix + (c,), -np.inf, pb + lp[c])
                    else:
                        add(prefix + (c,), -np.inf, total + lp[c])
            scored = sorted(
                new_beams.items(),
                key=lambda kv: -(np.logaddexp(kv[1][0], kv[1][1]) + lm_total(kv[0])),
            )
            beams = dict(scored[:beam_width])
        def fin(p, v):
            s = float(np.logaddexp(v[0], v[1])) + lm_total(p)
            if lm is not None:
                s += lm_alpha * lm.score((lm.bos,) + p, lm.eos)
            return s
        final = sorted(
            ((p, fin(p, v)) for p, v in beams.items()), key=lambda kv: -kv[1]
        )
        results.append(final)
    return results

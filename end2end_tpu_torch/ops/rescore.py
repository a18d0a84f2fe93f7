"""Post-hoc N-best LM rescoring (torch port of `end2end_tpu/ops/rescore.py`).

Decode without the LM, then add the exact shallow-fusion bonus to every
surviving hypothesis y and re-rank:

    alpha * (sum_j log p_LM(y_j | y_<j) + final(y)) + beta * len(y),

the bonus an LM-fused decode attaches to the same prefix.  An LM with
`score_chunk` replays the whole N-best list in one call; any other LM of
the shallow-fusion protocol (ops/lm.py) is folded through `score` and
`select` one position at a time, each hypothesis its own single candidate,
vectorised over the N*W hypotheses (the JAX package's per-token fallback).
"""

from __future__ import annotations

import torch

from .lm import _where_rows


def _score_by_protocol(lm, state, toks):
    """(sum of log p_LM over each row's tokens, the state after them):
    score/select folded over the positions up to the longest row."""
    m = toks.shape[0]
    rows = torch.arange(m, device=toks.device)
    zero = torch.zeros_like(rows)
    extend = torch.zeros(m, dtype=torch.bool, device=toks.device)
    valid = toks >= 0
    lp_sum = torch.zeros(m, device=toks.device)
    for j in range(int(valid.sum(dim=1).max()) if m else 0):
        lm_lp, ext = lm.score(state, toks[:, j:j + 1].clamp(min=0))
        state = _where_rows(valid[:, j], lm.select(state, ext, rows, zero,
                                                   extend), state)
        lp_sum = lp_sum + torch.where(valid[:, j], lm_lp[:, 0], 0.0)
    return lp_sum, state


def rescore_nbest(tokens, lengths, scores, lm, lm_alpha: float = 0.0,
                  lm_beta: float = 0.0, resort: bool = True, times=None):
    """Add shallow-fusion LM bonuses to an N-best list and re-rank.

    tokens (N, W, S) int32 (-1 padded), lengths (N, W), scores (N, W)
    acoustic log-scores (-inf for dead beams), as `beam_search_decode`
    returns them; `times` (N, W, S) optional, co-sorted with the beams.
    Returns (tokens, lengths, scores + bonus), re-sorted best first when
    `resort`, plus times when given.
    """
    n, w, s_cap = tokens.shape
    toks = tokens.reshape(n * w, s_cap).long()
    state = lm.init_state(n * w)
    if hasattr(lm, "score_chunk"):
        lm_sum, state = lm.score_chunk(state, toks)
    else:
        lm_sum, state = _score_by_protocol(lm, state, toks)
    bonus = (lm_alpha * (lm_sum + lm.final(state))
             + lm_beta * lengths.reshape(n * w).to(torch.float32))
    flat = scores.reshape(n * w)
    new = torch.where(torch.isfinite(flat), flat + bonus,
                      float("-inf")).reshape(n, w)
    if resort:
        new, order = torch.sort(new, dim=1, descending=True, stable=True)
        tokens = tokens.gather(1, order[:, :, None].expand_as(tokens))
        lengths = lengths.gather(1, order)
        if times is not None:
            times = times.gather(1, order[:, :, None].expand_as(times))
    if times is not None:
        return tokens, lengths, new, times
    return tokens, lengths, new

"""Post-hoc N-best LM rescoring (torch port of `end2end_tpu/ops/rescore.py`).

Decode without the LM, then add the exact shallow-fusion bonus to every
surviving hypothesis y and re-rank:

    alpha * (sum_j log p_LM(y_j | y_<j) + final(y)) + beta * len(y),

the bonus an LM-fused decode attaches to the same prefix.  The whole
N-best list is replayed in one `score_chunk` call.  The JAX package's
per-token protocol fallback for LMs without `score_chunk` is not ported:
every LM of the port has `score_chunk`.
"""

from __future__ import annotations

import torch


def rescore_nbest(tokens, lengths, scores, lm, lm_alpha: float = 0.0,
                  lm_beta: float = 0.0, resort: bool = True, times=None):
    """Add shallow-fusion LM bonuses to an N-best list and re-rank.

    tokens (N, W, S) int32 (-1 padded), lengths (N, W), scores (N, W)
    acoustic log-scores (-inf for dead beams), as `beam_search_decode`
    returns them; `times` (N, W, S) optional, co-sorted with the beams.
    Returns (tokens, lengths, scores + bonus), re-sorted best first when
    `resort`, plus times when given.
    """
    if not hasattr(lm, "score_chunk"):
        raise NotImplementedError(
            f"{type(lm).__name__} has no score_chunk: the per-token "
            "rescoring fallback is not ported yet (ROADMAP.md queue 1 "
            "item 5)")
    n, w, s_cap = tokens.shape
    lm_sum, state = lm.score_chunk(lm.init_state(n * w),
                                   tokens.reshape(n * w, s_cap))
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

"""The numbers that decide `correct`: the port's readings against the
reference's, each compared with a limit of its own (`limits/<cell>.json`).

Training (the checked first steps):
  * `loss_gap`: the relative gap of the first step's loss (the later
    steps' losses move with AdamW's normalised updates of gradient
    elements that are nought but for rounding: `train_detail` reports
    them, and nothing compares them);
  * `grad_gap`, `change_gap`: over the leaves, the largest gap between
    the port's and the reference's norm of the first gradient, and of the
    change over the checked steps, each over the larger of that leaf's
    reference norm and the median leaf's.  Leaves whose reference
    gradient is under a millionth of the median leaf's (nought but for
    rounding, as a key's bias under softmax, or not read by the loss) are
    left out of both.
Serving (a sample of the finished requests, each run through the
reference alone, padded as in its batch):
  * `score_gap`: the largest gap between a served score and the
    reference's score of the served transcript;
  * `rank_gap`: the largest gap between the reference's best score and
    its score of the served transcript, so that the served transcript has
    to be the reference's best, or within a tie of it.
  For greedy decoding the reference's scores are the transcript's best
  alignment's log-prob and the best path's; for beam search, log p in the
  reference's own beam search (`reference.beam`), infinite where the
  transcript is not among its final beams, and its first beam's.  A
  transcript altered, left out, outranked or computed in a lower precision
  reads far above rounding.  A beam request whose reference search is
  itself unsteady under log-probs moved by a little more than rounding
  (`on_a_tie`) sits on a near-tie that the port's rounding may resolve
  otherwise; it is counted and not judged.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

from e2e_bench.reference import beam as ref_beam
from e2e_bench.reference import ctc as ref_ctc

SMALL_GRAD = 1e-6
TIE_EPS = 3e-4   # a probe moves each log-prob by up to this
TIE_TOL = 0.02   # and the best score by more than this marks a tie
TIE_PROBES = 2


def worst(values) -> float:
    """The largest value; inf if any is NaN or there is none."""
    values = list(values)
    if not values or any(math.isnan(v) for v in values):
        return math.inf
    return max(values)


def _worst_leaf(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref[k] for k in keep)
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def _kept(ref: dict) -> list:
    """The leaves whose reference gradient is more than rounding."""
    med = statistics.median(ref["grads"].values())
    return [k for k, g in ref["grads"].items() if g >= SMALL_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    keep = _kept(ref)
    a, b = prog["losses"][0], ref["losses"][0]
    loss_gap = worst([abs(a - b) / abs(b)])
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(prog["grads"], ref["grads"], keep),
            "change_gap": _worst_leaf(prog["changes"], ref["changes"], keep)}


def train_detail(prog: dict, ref: dict, top: int = 3) -> dict:
    """Where the training numbers come from: each step's loss gap and the
    leaves with the largest gradient and change gaps."""
    keep = _kept(ref)
    out = {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                              zip(prog["losses"], ref["losses"])],
           "left_out": sorted(set(ref["grads"]) - set(keep))}
    for what in ("grads", "changes"):
        m = statistics.median(ref[what][k] for k in keep)
        gaps = sorted(((abs(prog[what][k] - ref[what][k])
                        / max(ref[what][k], m), k, ref[what][k])
                       for k in keep), reverse=True)[:top]
        out[what] = [[k, g, r, m] for g, k, r in gaps]
    return out


def beam_search(lp, beam: dict, blank: int, s_cap: int) -> list:
    """The reference's prefix beam search at a mix's width and prune."""
    return ref_beam.prefix_beam_search(
        lp, beam["beam_width"], beam.get("prune_k") or lp.shape[1], blank,
        s_cap)


def on_a_tie(lp, hyps: list, beam: dict, blank: int, s_cap: int) -> bool:
    """Whether the reference's own search changes its best transcript, or
    moves its score by more than `TIE_TOL`, when every log-prob moves by up
    to `TIE_EPS`, a few times more than the port's and the reference's
    float32 log-probs differ by: then the request sits on a near-tie at a
    pruning step, which rounding may resolve either way."""
    for probe in range(TIE_PROBES):
        noise = np.random.default_rng(probe).uniform(-1.0, 1.0, lp.shape)
        moved = beam_search(lp + TIE_EPS * noise, beam, blank, s_cap)
        if moved[0][0] != hyps[0][0] or abs(moved[0][1] - hyps[0][1]) \
                > TIE_TOL:
            return True
    return False


def serve_numbers(served: list, ref_lps: list, beam: dict | None,
                  blank: int, s_caps: list, notes: dict | None = None
                  ) -> dict:
    """served: [(tokens, score)]; ref_lps: the reference's (T, V) float64
    log-probs of the same requests; beam: None for greedy decoding, else
    {"beam_width", "prune_k"}; s_caps: each request's symbol cap.  Beam
    requests that sit on a near-tie (`on_a_tie`) are not judged; `notes`,
    where given, gets their count as "tie_bound"."""
    scores, ranks, ties = [], [], 0
    for (tokens, score), lp, s_cap in zip(served, ref_lps, s_caps):
        if beam:
            hyps = beam_search(lp, beam, blank, s_cap)
            if on_a_tie(lp, hyps, beam, blank, s_cap):
                ties += 1
                continue
            best = hyps[0][1]
            truth = dict(hyps).get(tuple(tokens), -math.inf)
        else:
            best = ref_ctc.best_path_score(lp)
            truth = ref_ctc.viterbi(lp, tokens, blank)
        scores.append(abs(score - truth))
        ranks.append(best - truth)
    if notes is not None and beam:
        notes["tie_bound"] = ties
    return {"score_gap": worst(scores), "rank_gap": worst(ranks)}

"""Minimum expected word/token error rate (MWER / MBR) training loss (torch
port of `end2end_tpu/ops/mwer.py`).

Sequence-discriminative fine-tuning for CTC models (and, in
`rnnt_mwer_loss`, transducers), from the port's own primitives:

  1. decode an N-best list with the (non-differentiable) beam search,
  2. score each hypothesis exactly under the model: the CTC negative log
     likelihood of the hypothesis as if it were the target (`ctc_nll`,
     differentiable),
  3. renormalize the hypothesis scores into an N-best posterior,
  4. loss = posterior-weighted error regret against the uniform N-best
     mean, L = sum_i p_hat_i * (E_i - mean_j E_j) (Prabhavalkar et al.
     2018, eq. 3).

Gradients flow through the posterior only: the N-best list and the error
counts are constants (decoded under `torch.no_grad`, errors detached).

Errors are Levenshtein distances from `utils.metrics.batch_edit_distance`:
`err='token'` on raw token ids, `err='word'` with `space_id=` on FNV-1a
hashes of the words (`word_id_hashes`).

On the card (CUDA float32 log-probs) the decode runs K3, K4 and the
backtrace kernel once a call, and the scoring K1, K2 and the gradient's
combine on N*W rows: the hypotheses are flattened to (N*W, S') rows,
trimmed to the longest hypothesis (exact: the kernels never read a target
past its length, and a lattice of 2 S' + 1 states replaces one of
2 max_symbols + 1), against log-probs copied W times, (T, N*W, V)
(autograd sums the copies back).  The transducer's `rnnt_mwer_loss`
decodes with the ALSD beam search (K3 on the card) and scores with
`rnnt_nll` (K8, K9).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.metrics import batch_edit_distance
from .beam_search import beam_search_decode
from .ctc_loss import ctc_nll
from .rnnt_decode import _prefix_states, rnnt_beam_decode
from .rnnt_loss import rnnt_nll

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK32 = 0xFFFFFFFF


def word_id_hashes(tokens, lengths, space_id: int, w_cap: int | None = None):
    """Segment padded token id rows at `space_id` and hash each word.

    tokens: (..., S) padded ids; lengths: (...,) valid counts.
    Returns (word_hashes (..., w_cap) int32, word_counts (...,) int32)
    where word_hashes[i, k] is an FNV-1a hash of the k-th word's token ids
    (+1 each, so id 0 counts), the JAX package's uint32 bits as int32;
    empty words (leading, trailing or double separators) are skipped.
    w_cap defaults to S//2 + 1 (the most words S tokens hold).  A loop over
    S positions, vectorised over the rows; the uint32 products wrap in
    int64 masked to 32 bits.
    """
    tokens = torch.as_tensor(tokens)
    dev = tokens.device
    tokens = tokens.long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    batch_shape = tokens.shape[:-1]
    s = tokens.shape[-1]
    if w_cap is None:
        w_cap = s // 2 + 1
    flat = tokens.reshape(-1, s)
    flat_len = lengths.reshape(-1)
    n = flat.shape[0]
    slots = torch.arange(w_cap, device=dev)

    def emit(out, nw, h, close):
        at = close[:, None] & (slots[None, :]
                               == nw.clamp(max=w_cap - 1)[:, None])
        return torch.where(at, h[:, None], out), nw + close.long()

    h = torch.full((n,), _FNV_OFFSET, dtype=torch.long, device=dev)
    in_word = torch.zeros((n,), dtype=torch.bool, device=dev)
    nw = torch.zeros((n,), dtype=torch.long, device=dev)
    out = torch.zeros((n, w_cap), dtype=torch.long, device=dev)
    for pos in range(s):
        tok = flat[:, pos]
        valid = pos < flat_len
        is_sep = valid & (tok == space_id)
        is_tok = valid & (tok != space_id)
        # a separator closes an open word before this position extends one
        out, nw = emit(out, nw, h, is_sep & in_word)
        h_ext = ((h ^ ((tok + 1) & _MASK32)) * _FNV_PRIME) & _MASK32
        h = torch.where(is_tok, h_ext, torch.where(is_sep, _FNV_OFFSET, h))
        in_word = (in_word | is_tok) & ~is_sep
    out, nw = emit(out, nw, h, in_word)  # the sequence's end closes a word
    out = torch.where(out >= 2**31, out - 2**32, out)  # uint32 bits as int32
    return (out.to(torch.int32).reshape(*batch_shape, w_cap),
            nw.to(torch.int32).reshape(batch_shape))


def _nbest_errors(hyp_tokens, hyp_lengths, ref_tokens, ref_lengths,
                  err: str, space_id):
    """(N, W) int32 Levenshtein errors of every hypothesis vs its
    reference."""
    n, w, _ = hyp_tokens.shape
    if err == "word":
        if space_id is None:
            raise ValueError("err='word' requires space_id")
        hyp_tokens, hyp_lengths = word_id_hashes(hyp_tokens, hyp_lengths,
                                                 space_id)
        ref_tokens, ref_lengths = word_id_hashes(ref_tokens, ref_lengths,
                                                 space_id)
    elif err != "token":
        raise ValueError(f"invalid err {err!r} (want 'token' or 'word')")
    d = batch_edit_distance(hyp_tokens.reshape(n * w, -1),
                            hyp_lengths.reshape(n * w),
                            ref_tokens.repeat_interleave(w, dim=0),
                            ref_lengths.repeat_interleave(w, dim=0))
    return d.reshape(n, w)


def mwer_loss_from_nbest(
    log_probs,
    input_lengths,
    hyp_tokens,
    hyp_lengths,
    ref_tokens,
    ref_lengths,
    hyp_valid=None,
    blank: int = 0,
    err: str = "token",
    space_id: int | None = None,
    scale: float = 1.0,
    reduction: str = "mean",
    score_implementation: str = "auto",
    return_aux: bool = False,
):
    """MWER loss over an externally supplied N-best list.

    Args:
      log_probs: (T, N, C) log-softmaxed activations (differentiable input).
      input_lengths: (N,) valid frame counts.
      hyp_tokens: (N, W, S_cap) N-best token ids (no blanks; padding past
        each length is ignored).
      hyp_lengths: (N, W) hypothesis lengths.
      ref_tokens: (N, S_ref) reference transcripts (padded).
      ref_lengths: (N,).
      hyp_valid: optional (N, W) bool, dead N-best slots to exclude
        (infeasible hypotheses, whose CTC score is -inf, are excluded
        anyway).
      err: 'token' (id-level edits) or 'word' (requires space_id).
      scale: posterior sharpness, p_hat = softmax(scale * score).
      reduction: 'none' | 'mean' | 'sum' over the batch.
      score_implementation: `ctc_nll`'s implementation for the hypothesis
        scores.  The default 'auto' runs the CUDA kernels (K1, K2, the
        combine) on CUDA float32 log-probs and the plain scan elsewhere.
        The JAX package defaults to 'xla' because on the TPU its scan
        vmaps over W without the W-fold copy; the port's 'xla' is the
        plain scan, a loop of T steps from the host on the card.
      return_aux: also return a dict with the posterior, per-hyp errors,
        expected error, hypothesis scores and the validity mask.

    Returns loss (scalar or (N,)), or (loss, aux) with return_aux.
    """
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(f"invalid reduction {reduction!r}")
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    hyp_tokens = torch.as_tensor(hyp_tokens, device=dev).long()
    hyp_lengths = torch.as_tensor(hyp_lengths, device=dev).long()
    ref_tokens = torch.as_tensor(ref_tokens, device=dev).long()
    ref_lengths = torch.as_tensor(ref_lengths, device=dev).long()
    il = torch.as_tensor(input_lengths, device=dev).long()
    hyp_tokens = _trim_nbest(hyp_tokens, hyp_lengths)
    score = _score_nbest(log_probs, il, hyp_tokens, hyp_lengths, blank,
                         score_implementation)
    with torch.no_grad():
        errors = _nbest_errors(hyp_tokens, hyp_lengths, ref_tokens,
                               ref_lengths, err, space_id).to(score.dtype)
    return _combine_mwer(score, errors, hyp_valid, scale, reduction,
                         return_aux)


def _trim_nbest(hyp_tokens, hyp_lengths):
    """(N, W, S') hypotheses cut (or zero-padded) to the longest length S'
    (at least 1); reading that length waits for the device once."""
    s_hyp = max(int(hyp_lengths.max()) if hyp_lengths.numel() else 0, 1)
    return F.pad(hyp_tokens[..., :s_hyp],
                 (0, max(s_hyp - hyp_tokens.shape[-1], 0)))


def _score_nbest(log_probs, il, hyp_tokens, hyp_lengths, blank,
                 score_implementation):
    """(N, W) CTC log-likelihoods of the hypotheses: `ctc_nll` on N*W rows
    against the (T, N, V) log-probs copied W times, (T, N*W, V)."""
    t_max, n, v = log_probs.shape
    w, s_hyp = hyp_tokens.shape[1:]
    rows = log_probs.unsqueeze(2).expand(t_max, n, w, v).reshape(
        t_max, n * w, v)
    nll = ctc_nll(rows, hyp_tokens.reshape(n * w, s_hyp),
                  il.repeat_interleave(w), hyp_lengths.reshape(n * w), blank,
                  score_implementation)
    return -nll.reshape(n, w)


def _combine_mwer(score, errors, hyp_valid, scale, reduction, return_aux):
    """Posterior-weighted regret over (N, W) hypothesis scores (the score
    is the only differentiable input)."""
    valid = torch.isfinite(score)
    if hyp_valid is not None:
        valid = valid & torch.as_tensor(hyp_valid, device=score.device).bool()
    any_valid = valid.any(dim=1)
    logits = torch.where(valid, scale * score, float("-inf"))
    # a row with no valid hypothesis: softmax of all -inf would be NaN
    safe_logits = torch.where(any_valid[:, None], logits, 0.0)
    posterior = torch.where(valid, torch.softmax(safe_logits, dim=1), 0.0)
    n_valid = valid.sum(dim=1).clamp(min=1).to(errors.dtype)
    mean_err = torch.where(valid, errors, 0.0).sum(dim=1) / n_valid
    regret = errors - mean_err[:, None]
    per_sample = torch.where(valid, posterior * regret, 0.0).sum(dim=1)
    per_sample = torch.where(any_valid, per_sample, 0.0)
    if reduction == "mean":
        loss = per_sample.mean()
    elif reduction == "sum":
        loss = per_sample.sum()
    else:
        loss = per_sample
    if not return_aux:
        return loss
    expected = torch.where(valid, posterior * errors, 0.0).sum(dim=1)
    aux = {
        "posterior": posterior,
        "errors": errors,
        "expected_error": torch.where(any_valid, expected, 0.0),
        "scores": score,
        "valid": valid,
    }
    return loss, aux


def mwer_loss(
    log_probs,
    targets,
    input_lengths,
    target_lengths,
    beam_width: int = 4,
    blank: int = 0,
    prune_k: int | None = 16,
    max_symbols: int | None = None,
    lm=None,
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
    err: str = "token",
    space_id: int | None = None,
    scale: float = 1.0,
    reduction: str = "mean",
    implementation: str = "auto",
    score_implementation: str = "auto",
    from_logits: bool = False,
    batch_first: bool = False,
    return_aux: bool = False,
):
    """Self-contained MWER loss: beam-decode an N-best list from the model's
    own activations (under `torch.no_grad`, on the detached log-probs;
    `implementation` routes the decode as `beam_search_decode` does), then
    `mwer_loss_from_nbest` on it (`score_implementation` routes the
    differentiable scoring; see there why its default differs from the
    JAX package's).

    Typical fine-tuning composite: `ctc_loss(...) + lambda_mwer *
    mwer_loss(...)` (the CTC term regularizes the discriminative one).
    """
    log_probs = torch.as_tensor(log_probs)
    if batch_first:
        log_probs = log_probs.transpose(0, 1)
    if from_logits:
        log_probs = torch.log_softmax(log_probs, dim=-1)
    with torch.no_grad():
        tokens, lengths, scores = beam_search_decode(
            log_probs.detach(), input_lengths, beam_width=beam_width,
            blank=blank, prune_k=prune_k, max_symbols=max_symbols, lm=lm,
            lm_alpha=lm_alpha, lm_beta=lm_beta,
            implementation=implementation)
    # dead beam slots surface as -inf decode scores
    return mwer_loss_from_nbest(
        log_probs, input_lengths, tokens, lengths, targets, target_lengths,
        hyp_valid=torch.isfinite(scores), blank=blank, err=err,
        space_id=space_id, scale=scale, reduction=reduction,
        score_implementation=score_implementation, return_aux=return_aux)


def rnnt_mwer_loss(
    encoder_out,
    input_lengths,
    targets,
    target_lengths,
    predictor_step,
    init_hidden,
    joint_fn,
    beam_width: int = 4,
    blank: int = 0,
    prune_k: int | None = None,
    max_symbols: int | None = None,
    lm=None,
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
    err: str = "token",
    space_id: int | None = None,
    scale: float = 1.0,
    reduction: str = "mean",
    score_implementation: str = "auto",
    return_aux: bool = False,
):
    """MWER / MBR loss for the transducer: `mwer_loss` with an ALSD N-best
    and each hypothesis scored exactly by `rnnt_nll`.

    The N-best list comes from `rnnt_beam_decode` under `torch.no_grad`
    (a constant of the gradient; an LM only shapes it).  Each hypothesis
    is scored by its sequence log-probability: the predictor unrolled over
    its tokens, the joint lattice (N, T, S'+1, V) built for one hypothesis
    at a time (a loop over the W beams; S' the longest hypothesis), and
    `rnnt_nll(implementation=score_implementation)`: on the card, K8
    forward and K9 in the backward, once each per hypothesis.  Gradients
    flow through `encoder_out` and whatever predictor and joint parameters
    the protocol functions close over.  Posterior-weighted regret as in
    `mwer_loss`.

    Args mirror `rnnt_beam_decode`'s and `mwer_loss`'s.  Returns loss
    (scalar or (N,)), or (loss, aux) with return_aux.
    """
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(f"invalid reduction {reduction!r}")
    enc = torch.as_tensor(encoder_out).to(torch.float32)
    il = torch.as_tensor(input_lengths, device=enc.device).long()
    hyp_tokens, hyp_lengths, dec_scores = rnnt_beam_decode(
        enc.detach(), il, predictor_step, init_hidden, joint_fn,
        beam_width=beam_width, prune_k=prune_k, blank=blank,
        max_symbols=max_symbols, lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta)
    return _rnnt_mwer_from_nbest(
        enc, il, hyp_tokens, hyp_lengths,
        torch.isfinite(dec_scores) & (dec_scores > -1e29), targets,
        target_lengths, predictor_step, init_hidden, joint_fn, blank, err,
        space_id, scale, reduction, score_implementation, return_aux)


def _rnnt_mwer_from_nbest(enc, il, hyp_tokens, hyp_lengths, hyp_valid,
                          targets, target_lengths, predictor_step,
                          init_hidden, joint_fn, blank, err, space_id, scale,
                          reduction, score_implementation, return_aux):
    """`rnnt_mwer_loss` after its decode, in the encoder output's dtype:
    the N-best scored, its errors counted and the regret combined."""
    dev = enc.device
    hyp_lengths = hyp_lengths.long()
    hyp_tokens = _trim_nbest(hyp_tokens.long(), hyp_lengths)
    score = _rnnt_score_nbest(enc, il, hyp_tokens, hyp_lengths,
                              predictor_step, init_hidden, joint_fn, blank,
                              score_implementation)
    with torch.no_grad():
        errors = _nbest_errors(
            hyp_tokens, hyp_lengths,
            torch.as_tensor(targets, device=dev).long(),
            torch.as_tensor(target_lengths, device=dev).long(), err,
            space_id).to(score.dtype)
    return _combine_mwer(score, errors, hyp_valid, scale, reduction,
                         return_aux)


def _rnnt_score_nbest(enc, il, hyp_tokens, hyp_lengths, predictor_step,
                      init_hidden, joint_fn, blank, score_implementation):
    """(N, W) transducer log-likelihoods of the trimmed (N, W, S')
    hypotheses: for each beam in turn, the predictor's prefix states over
    its tokens, the joint lattice (N, T, S'+1, V) and `rnnt_nll`."""
    scores = []
    for w in range(hyp_tokens.shape[1]):
        toks = hyp_tokens[:, w].clamp(min=0)                     # (N, S')
        hs = _prefix_states(predictor_step, init_hidden, toks)
        logits = joint_fn(enc[:, :, None], hs[:, None])
        scores.append(-rnnt_nll(logits, toks, il, hyp_lengths[:, w],
                                blank=blank,
                                implementation=score_implementation))
    return torch.stack(scores, 1)

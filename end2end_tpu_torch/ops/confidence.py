"""Confidence estimation for CTC and transducer decodes (torch port of
`end2end_tpu/ops/confidence.py`).

Entropy-family frame confidences computed from the log-probability
lattice (for a transducer, from the joint's rows at each token's frame and
prefix state), gathered per emitted token, and aggregated per word and
utterance, on the lattice's device.

Methods (all map a frame's distribution to [0, 1]; 1 = fully peaked):

  * ``max_prob``  — probability of the argmax token.
  * ``shannon``   — 1 − H(p)/ln V (linearly normalized Shannon entropy).
  * ``tsallis``   — 1 − S_α(p)/S_α(uniform), S_α = (Σp^α − 1)/(1 − α);
                    the NeMo default family, α ∈ (0, 1), default 1/3.
  * ``renyi``     — 1 − H_α(p)/ln V, H_α = ln(Σp^α)/(1 − α).

``exclude_blank=True`` conditions the distribution on "a token is emitted"
(renormalizes over non-blank symbols) before measuring.  Aggregations:
mean / min / prod.  An empty hypothesis aggregates to 1.0; gate on length
separately.

The JAX package's float32 `exp32`/`log32` polynomials (written because the
TPU's native exp and log are ~1e-5 off) become libm's `torch.exp` and
`torch.log`; ln V stays a float64 constant from the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .greedy import greedy_decode_with_timestamps
from .rnnt_decode import _prefix_states, rnnt_greedy_decode

_METHODS = ("max_prob", "shannon", "tsallis", "renyi")
_AGGREGATIONS = ("mean", "min", "prod")


def frame_confidence(log_probs, method: str = "tsallis", alpha: float = 1 / 3,
                     blank: int = 0, exclude_blank: bool = False):
    """Per-frame confidence from a (T, N, V) (or any (..., V)) log-prob
    lattice.  Returns (...,) float32 in [0, 1]."""
    if method not in _METHODS:
        raise ValueError(f"invalid method {method!r} (want one of {_METHODS})")
    lp = torch.as_tensor(log_probs).float()
    v = lp.shape[-1]
    if exclude_blank:
        if v < 3:
            raise ValueError("exclude_blank needs at least 2 non-blank symbols")
        is_blank = torch.arange(v, device=lp.device) == blank
        lp = torch.where(is_blank, float("-inf"), lp)
        lp = lp - torch.logsumexp(lp, dim=-1, keepdim=True)
        v = v - 1
    if method == "max_prob":
        return torch.exp(lp.amax(dim=-1))
    log_v = math.log(float(v))
    if method == "shannon":
        p = torch.exp(lp)
        h = -torch.where(p > 0, p * lp, 0.0).sum(dim=-1)
        return torch.clamp(1.0 - h / log_v, 0.0, 1.0)
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    # each term p^alpha is in [0, 1] (alpha * lp <= 0; the -inf of an
    # excluded blank gives 0), so the direct sum needs no logsumexp
    sum_pa = torch.exp(alpha * lp).sum(dim=-1)
    if method == "tsallis":
        s = (sum_pa - 1.0) / (1.0 - alpha)
        s_max = (float(v) ** (1.0 - alpha) - 1.0) / (1.0 - alpha)
        return torch.clamp(1.0 - s / s_max, 0.0, 1.0)
    # renyi; sum p^alpha >= 1 for alpha < 1
    h = torch.log(sum_pa) / (1.0 - alpha)
    return torch.clamp(1.0 - h / log_v, 0.0, 1.0)


def token_confidence(frame_conf, times, lengths, time_axis_first: bool = True):
    """Gather per-token confidence at each token's emission frame.

    frame_conf: (T, N) (or (N, T) with time_axis_first=False) from
    `frame_confidence`; times: (N, ..., S) emission frames as the
    timestamped decoders return them (greedy (N, S); beam (N, W, S));
    lengths: (N, ...) decoded lengths.  Positions at or beyond the length
    return 0.  One gather."""
    conf_nt = torch.as_tensor(frame_conf).float()
    if time_axis_first:
        conf_nt = conf_nt.T
    dev = conf_nt.device
    times = torch.as_tensor(times, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    n, t = conf_nt.shape
    s = times.shape[-1]
    flat_idx = times.reshape(n, -1).clamp(0, t - 1)
    conf = conf_nt.gather(1, flat_idx).reshape(times.shape)
    valid = torch.arange(s, device=dev) < lengths[..., None]
    return torch.where(valid, conf, 0.0)


def aggregate_confidence(token_conf, lengths, how: str = "mean"):
    """Reduce per-token confidences (..., S) over each hypothesis's valid
    prefix.  how: 'mean' | 'min' | 'prod'.  Empty hypotheses give 1.0."""
    if how not in _AGGREGATIONS:
        raise ValueError(
            f"invalid aggregation {how!r} (want one of {_AGGREGATIONS})")
    token_conf = torch.as_tensor(token_conf).float()
    dev = token_conf.device
    lengths = torch.as_tensor(lengths, device=dev).long()
    s = token_conf.shape[-1]
    valid = torch.arange(s, device=dev) < lengths[..., None]
    if how == "mean":
        total = torch.where(valid, token_conf, 0.0).sum(dim=-1)
        return torch.where(lengths > 0, total / lengths.clamp(min=1), 1.0)
    if how == "min":
        return torch.where(valid, token_conf, float("inf")).amin(
            dim=-1).clamp(max=1.0)
    return torch.where(valid, token_conf, 1.0).prod(dim=-1)


def greedy_decode_with_confidence(log_probs, input_lengths=None,
                                  blank: int = 0, method: str = "tsallis",
                                  alpha: float = 1 / 3,
                                  exclude_blank: bool = True,
                                  aggregation: str = "mean",
                                  pad_id: int = -1,
                                  from_logits: bool = False,
                                  batch_first: bool = False):
    """`greedy_decode_with_timestamps` + per-token and per-utterance
    confidence.

    Returns (tokens (N, T), lengths (N,), scores (N,), times (N, T),
    token_conf (N, T) float32 [0 where padded], utt_conf (N,) float32).
    """
    lp = torch.as_tensor(log_probs)
    if batch_first:
        lp = lp.transpose(0, 1)
    if from_logits:
        lp = torch.log_softmax(lp, dim=-1)
    tokens, lengths, scores, times = greedy_decode_with_timestamps(
        lp, input_lengths, blank=blank, pad_id=pad_id)
    fc = frame_confidence(lp, method=method, alpha=alpha, blank=blank,
                          exclude_blank=exclude_blank)
    tc = token_confidence(fc, torch.where(times == pad_id, 0, times), lengths)
    return tokens, lengths, scores, times, tc, aggregate_confidence(
        tc, lengths, aggregation)


def word_confidences(ids, times, token_conf, space_id=None, alphabet=None,
                     boundary_ids=None, how: str = "min"):
    """Word-level (word, start_frame, end_frame, confidence) tuples —
    `utils.text.word_spans` joined with per-token confidences.

    ids/times/token_conf: ONE hypothesis's decoded ids, emission frames,
    and token confidences, trimmed to the decoded length.  Boundary
    regimes as in word_spans (exactly one of space_id / boundary_ids).
    Host-side convenience for presenting results."""
    if how not in _AGGREGATIONS:
        raise ValueError(
            f"invalid aggregation {how!r} (want one of {_AGGREGATIONS})")
    ids = [int(i) for i in ids]
    times_l = [int(t) for t in times]
    conf = [float(c) for c in token_conf]
    boundary = frozenset(int(b) for b in boundary_ids or ())
    if (space_id is None) == (not boundary):
        raise ValueError("pass exactly one of space_id / boundary_ids")
    out = []
    cur = []  # list of (id, time, conf)

    def flush():
        if cur:
            word = (alphabet.decode([i for i, _, _ in cur])
                    if alphabet is not None else [i for i, _, _ in cur])
            cs = [c for _, _, c in cur]
            agg = (float(np.mean(cs)) if how == "mean"
                   else float(min(cs)) if how == "min"
                   else float(np.prod(cs)))
            out.append((word, cur[0][1], cur[-1][1], agg))
        cur.clear()

    for i, t, c in zip(ids, times_l, conf):
        if space_id is not None and i == int(space_id):
            flush()
            continue
        if boundary and i in boundary:
            flush()
        cur.append((i, t, c))
    flush()
    return out


def rnnt_token_confidence(encoder_out, tokens, lengths, times,
                          predictor_step, init_hidden, joint_fn,
                          method: str = "tsallis", alpha: float = 1 / 3,
                          blank: int = 0, exclude_blank: bool = True,
                          aggregation: str = "mean"):
    """Entropy-family confidence of decoded transducer hypotheses.

    The distribution that emitted token u is the joint's softmax at frame
    times[u] and the predictor state after tokens[:u], both functions of
    the decode's outputs, so the rows are recomputed here as the decoder
    saw them: one batched predictor sweep over the hypotheses, then one
    joint call on every (frame, prefix state) pair.  `predictor_step`,
    `init_hidden` and `joint_fn` are ops/rnnt_decode.py's batched
    protocol.  Greedy shapes (tokens, times (N, S), lengths (N,)) and beam
    shapes ((N, W, S), (N, W)) both work.

    Returns (token_conf, utterance_conf): token_conf shaped as tokens (0
    where padded), utterance_conf (N,) or (N, W).
    """
    enc = torch.as_tensor(encoder_out).to(torch.float32)
    dev = enc.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    times = torch.as_tensor(times, device=dev).long()
    n, t_max, _ = enc.shape
    lead, s = tokens.shape[:-1], tokens.shape[-1]
    m = int(np.prod(lead))
    toks = tokens.reshape(m, s).clamp(min=0)
    lens = lengths.reshape(m)
    tms = times.reshape(m, s).clamp(0, t_max - 1)
    # the prefix state before token u, u = 0 .. S-1
    states = _prefix_states(predictor_step, init_hidden, toks)[:, :s]
    samp = torch.arange(m, device=dev)[:, None] // max(m // n, 1)
    lp = torch.log_softmax(joint_fn(enc[samp, tms], states),
                           dim=-1)                               # (M, S, V)
    fc = frame_confidence(lp, method=method, alpha=alpha, blank=blank,
                          exclude_blank=exclude_blank)
    valid = torch.arange(s, device=dev)[None] < lens[:, None]
    tc = torch.where(valid, fc, 0.0)
    utt = aggregate_confidence(tc, lens, aggregation)
    return tc.reshape(*lead, s), utt.reshape(lead)


def rnnt_greedy_decode_with_confidence(encoder_out, input_lengths,
                                       predictor_step, init_hidden,
                                       joint_fn, blank: int = 0,
                                       max_symbols=None,
                                       max_symbols_per_frame: int = 4,
                                       method: str = "tsallis",
                                       alpha: float = 1 / 3,
                                       exclude_blank: bool = True,
                                       aggregation: str = "mean"):
    """`rnnt_greedy_decode` plus per-token and per-utterance confidences
    (the transducer twin of `greedy_decode_with_confidence`).

    Returns (tokens, lengths, scores, times, token_conf, utt_conf).
    """
    tokens, lengths, scores, times = rnnt_greedy_decode(
        encoder_out, input_lengths, predictor_step, init_hidden, joint_fn,
        blank=blank, max_symbols=max_symbols,
        max_symbols_per_frame=max_symbols_per_frame, return_timestamps=True)
    with torch.no_grad():
        tc, utt = rnnt_token_confidence(
            encoder_out, tokens, lengths, times.clamp(min=0), predictor_step,
            init_hidden, joint_fn, method=method, alpha=alpha, blank=blank,
            exclude_blank=exclude_blank, aggregation=aggregation)
    return tokens, lengths, scores, times, tc, utt

"""Batched CTC prefix beam search, with LM shallow fusion (torch port of
`end2end_tpu/ops/beam_search.py`).

The beam kernel's semantics throughout: a top-k over the vocabulary
(`topk_cuda.topk`), all frames' beam steps (`beam_search_cuda.beam_step`)
and a backtrace.  On CUDA tensors the top-k and the beam step are the CUDA
kernels, at every vocabulary size; on CPU tensors their plain versions.
Extensions come from the first K = prune_k slots and the repeat term reads
a ks = min(K + 8, V) window, so at prune_k = V (the default) this is the
exact prefix beam search.

Routing follows the JAX package:
  * the kernel path takes beam_width <= 32, prune_k <= 128, float32, and
    as its LM a dense `NGramLM` with V + 1 <= 64, fused per frame (K5),
    with the end-of-sequence bonus added after the kernel; 'auto' and
    'pallas' (the JAX name of the forced-kernel mode, kept so callers'
    code carries over) run it there, and 'pallas' raises ValueError
    outside it;
  * the prefix-beam scan (`_beam_search_scan`, the counterpart of JAX's
    `_beam_search_batched`) runs under 'xla', and under 'auto' where the
    kernel's envelope refuses the configuration (logged at info level):
    plain torch, one step of a loop over T vectorised over the sequences,
    with any LM of the shallow-fusion protocol (ops/lm.py) fused per
    frame, in the lattice's float type (float64 stays float64);
  * implementation='chunked' runs any LM with `score_chunk` through the
    chunked decode (ops/beam_chunked.py), optionally steered per frame by
    `guide_lm`.
`approx_topk` selects `lax.approx_max_k` on the TPU, which XLA computes
exactly off the TPU; the port's top-k is always exact (K3 on the card).
"""

from __future__ import annotations

import logging
import warnings

import torch

from ..utils.profiling import span
from .beam_chunked import beam_search_chunked_lm
from .lm import _where_rows
from .beam_search_cuda import (
    _DEADBASE,
    _M1,
    _M2,
    _SEED1,
    _SEED2,
    _wrap32,
    apply_token_min_logp,
    backtrace,
    beam_step,
    beam_supported,
    check_lm_device,
    lm_fusion_supported,
)
from .semiring import LOG0, LOG0_THRESHOLD, logaddexp2
from .topk_cuda import topk

def _top_w_iterative(scores, w: int):
    """Exact top-w of each row of scores (N, M) by repeated argmax (the
    first index among equal maxima, as lax.top_k), a pick leaving as -inf.
    Returns values and indices, (N, w) each."""
    s = scores.clone()
    rows = torch.arange(s.shape[0], device=s.device)
    vals, idxs = [], []
    for _ in range(w):
        i = s.argmax(dim=1)
        vals.append(s[rows, i])
        idxs.append(i)
        s[rows, i] = float("-inf")
    return torch.stack(vals, 1), torch.stack(idxs, 1)


def _masked_logsumexp(x, mask, dims):
    """logsumexp of x (broadcast to mask) over dims counting only mask;
    none -> LOG0."""
    m = torch.where(mask, x, LOG0).amax(dim=dims)
    m_safe = m.clamp(min=LOG0)
    for d in sorted(dims):
        m_safe = m_safe.unsqueeze(d)
    s = torch.where(mask, torch.exp(x - m_safe), 0.0).sum(dim=dims)
    out = m_safe.reshape(m.shape) + torch.log(s.clamp(min=1e-38))
    return torch.where(m > LOG0_THRESHOLD, out, LOG0)


def _gather_w(x, idx):
    """x (N, W, ...) at beams idx (N, W') -> (N, W', ...)."""
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                    .expand(idx.shape + x.shape[2:]))


def _beam_scan_state0(n: int, W: int, s_cap: int, lm, dtype, dev):
    """JAX's `_beam_init_state` for N sequences: (tokens, times, lens,
    last, pb, pnb, h1, h2, lm_state, lm_score), (N, W, ...) each but the
    LM state's N*W rows; beam 0 the live empty prefix."""
    w_idx = torch.arange(W, device=dev)
    tokens = torch.full((n, W, s_cap), -1, dtype=torch.long, device=dev)
    live0 = (w_idx == 0).expand(n, W)
    # the kernel's rolling prefix hashes, held as the signed int32 value of
    # their bits; dead beams get slot-unique ones
    dead_h = _wrap32(_DEADBASE + w_idx).expand(n, W)
    return (tokens, tokens.clone(),
            torch.zeros((n, W), dtype=torch.long, device=dev),
            torch.full((n, W), -1, dtype=torch.long, device=dev),
            torch.where(live0, 0.0, torch.tensor(LOG0, dtype=dtype,
                                                 device=dev)),
            torch.full((n, W), LOG0, dtype=dtype, device=dev),
            torch.where(live0, _SEED1, dead_h),
            torch.where(live0, _SEED2, dead_h),
            lm.init_state(n * W) if lm is not None else None,
            torch.zeros((n, W), dtype=dtype, device=dev))


def _beam_scan_steps(log_probs, il, state, W: int, K: int, s_cap: int,
                     blank: int, lm=None, lm_alpha: float = 0.0,
                     lm_beta: float = 0.0, token_min_logp=None,
                     candidates=None, t0=None):
    """The prefix-beam scan's frames from `state` (`_beam_scan_state0`'s
    layout), vectorised over the N sequences: JAX's `_beam_search_single`
    under `vmap`, resumable.  Frames t >= il (N,) leave a sequence's
    state alone; `t0` (N,) is each sequence's global frame offset, added
    to the recorded emission frames (streaming chunks); no tensor of the
    given state is written.  Per frame: top-K candidates (a stable sort:
    lax.top_k's order among equal values), W stay and W*K extension
    candidates, extensions that recreate a live prefix merged into it by
    hash (logsumexp) and removed, top-W of acoustic + LM bonus by repeated
    argmax.  The stay term reads the full vocabulary row, or with
    `token_min_logp` the masked candidate set.  With log_probs None,
    `candidates` = (lpk, ck, lpb), (T, N, K) top-K values and ids and
    (T, N) blank log-probs, are decoded alone (JAX's candidate-only mode):
    the stay term reads the candidates.  The LM scores extensions through
    its `score`/`select` protocol on N*W rows."""
    if log_probs is None:
        lpk_all, ck_all, lpb_all = candidates
        t_max, n, _ = lpk_all.shape
        ck_all = ck_all.long()
    else:
        t_max, n, v = log_probs.shape
        lpk_all, ck_all = torch.sort(log_probs, dim=-1, descending=True,
                                     stable=True)
        lpk_all, ck_all = apply_token_min_logp(
            lpk_all[..., :K].contiguous(), ck_all[..., :K], token_min_logp)
        lpb_all = log_probs[:, :, blank]
    stay_from_cands = log_probs is None or token_min_logp is not None
    dev, dt = lpk_all.device, lpk_all.dtype
    il = il.to(dev).long()
    rows = torch.arange(n, device=dev)[:, None]
    log0 = torch.tensor(LOG0, dtype=dt, device=dev)
    tokens, times, lens, last, pb, pnb, h1, h2, lm_state, lm_score = state
    dead_h = _wrap32(_DEADBASE + torch.arange(W, device=dev)).expand(n, W)
    pos = torch.arange(s_cap, device=dev)
    t_glob = (torch.zeros((n, 1, 1), dtype=torch.long, device=dev)
              if t0 is None else t0.to(dev).long()[:, None, None])
    for t in range(t_max):
        lpk, ck = lpk_all[t], ck_all[t].long()  # (N, K)
        total = logaddexp2(pb, pnb)
        # stay candidates: the same prefix
        if stay_from_cands:  # a dropped token is no repeat
            lp_last = torch.where(ck[:, None, :] == last[:, :, None],
                                  lpk[:, None, :], log0).amax(-1)
        else:
            lp_last = log_probs[t].gather(1, last.clamp(0, v - 1))
        pb_stay = total + lpb_all[t][:, None]
        pnb_stay = torch.where(last >= 0, pnb + lp_last, log0)
        # extension candidates: prefix + c
        same = ck[:, None, :] == last[:, :, None]  # (N, W, K)
        pnb_ext = (torch.where(same, pb[..., None], total[..., None])
                   + lpk[:, None, :])
        invalid = ((ck == blank) | (ck < 0))[:, None, :] | (
            lens >= s_cap)[..., None]
        pnb_ext = torch.where(invalid, log0, pnb_ext)
        h1e = _wrap32(h1[..., None] * _M1 + ck[:, None, :] + 1)
        h2e = _wrap32(h2[..., None] * _M2 + ck[:, None, :] + 1)
        if lm is not None:
            ck_rows = ck[:, None, :].expand(n, W, K).reshape(n * W, K)
            lm_lp, lm_state_ext = lm.score(lm_state, ck_rows)
            lm_delta = (lm_alpha * lm_lp + lm_beta).to(dt).reshape(n, W, K)
        else:
            lm_delta = torch.zeros((n, W, K), dtype=dt, device=dev)
        lm_score_ext = lm_score[..., None] + lm_delta
        # merge the extensions that recreate an existing beam's prefix
        match = ((h1[:, :, None, None] == h1e[:, None])
                 & (h2[:, :, None, None] == h2e[:, None])
                 & ~invalid[:, None])  # (N, W_stay, W, K)
        add = _masked_logsumexp(pnb_ext[:, None].expand_as(match), match,
                                (2, 3))
        pnb_stay = logaddexp2(pnb_stay, add)
        pnb_ext = torch.where(match.any(1), log0, pnb_ext)
        # rank all W + W*K candidates with their LM bonus, keep W
        cand_pb = torch.cat([pb_stay, log0.expand(n, W * K)], 1)
        cand_pnb = torch.cat([pnb_stay, pnb_ext.reshape(n, W * K)], 1)
        cand_lm = torch.cat([lm_score, lm_score_ext.reshape(n, W * K)], 1)
        vals, sel = _top_w_iterative(
            logaddexp2(cand_pb, cand_pnb) + cand_lm, W)
        # fewer live candidates than W: the argmax re-picks a removed one,
        # whose mass must not come along (a zombie duplicate)
        alive = vals > LOG0_THRESHOLD
        is_stay = sel < W
        parent = torch.where(is_stay, sel, (sel - W) // K)
        kk = torch.where(is_stay, 0, (sel - W) % K)
        c_sel = ck.gather(1, kk)
        parent_len = lens.gather(1, parent)
        emit_slot = (pos == parent_len[..., None]) & ~is_stay[..., None]
        new_tokens = torch.where(emit_slot, c_sel[..., None],
                                 _gather_w(tokens, parent))
        new_times = torch.where(emit_slot, t + t_glob,
                                _gather_w(times, parent))
        new_lens = torch.where(alive, torch.where(
            is_stay, parent_len, parent_len + 1).clamp(max=s_cap), 0)
        new_last = torch.where(alive & ~is_stay, c_sel, torch.where(
            alive, last.gather(1, parent), -1))
        ext_at = parent * K + kk
        new_h1 = torch.where(alive, torch.where(
            is_stay, h1.gather(1, parent),
            h1e.reshape(n, W * K).gather(1, ext_at)), dead_h)
        new_h2 = torch.where(alive, torch.where(
            is_stay, h2.gather(1, parent),
            h2e.reshape(n, W * K).gather(1, ext_at)), dead_h)
        new_pb = torch.where(alive, cand_pb.gather(1, sel), log0)
        new_pnb = torch.where(alive, cand_pnb.gather(1, sel), log0)
        new_lm_score = torch.where(alive, cand_lm.gather(1, sel), 0.0)
        upd = (t < il)[:, None]  # freeze past each sequence's length
        if lm is not None:
            new_state = lm.select(lm_state, lm_state_ext,
                                  (rows * W + parent).reshape(-1),
                                  kk.reshape(-1), is_stay.reshape(-1))
            lm_state = _where_rows(upd.expand(n, W).reshape(-1), new_state,
                                   lm_state)
        tokens = torch.where(upd[..., None], new_tokens, tokens)
        times = torch.where(upd[..., None], new_times, times)
        lens, last, pb, pnb, h1, h2, lm_score = (
            torch.where(upd, new, old) for new, old in (
                (new_lens, lens), (new_last, last), (new_pb, pb),
                (new_pnb, pnb), (new_h1, h1), (new_h2, h2),
                (new_lm_score, lm_score)))
    return tokens, times, lens, last, pb, pnb, h1, h2, lm_state, lm_score


def _beam_scan_rank(state, lm=None, lm_alpha: float = 0.0):
    """JAX's `_beam_rank` (pure): tokens (N, W, s_cap) int32 (-1 pad, best
    first), lengths (N, W) int32, scores (N, W) (-inf for dead beams) and
    times (N, W, s_cap) int32 emission frames."""
    tokens, times, lens, last, pb, pnb, h1, h2, lm_state, lm_score = state
    scores = logaddexp2(pb, pnb) + lm_score
    if lm is not None:
        scores = scores + (lm_alpha * lm.final(lm_state)).to(
            scores.dtype).reshape(scores.shape)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    scores = torch.where(scores > LOG0_THRESHOLD, scores, float("-inf"))
    return (_gather_w(tokens, order).to(torch.int32),
            lens.gather(1, order).to(torch.int32), scores,
            _gather_w(times, order).to(torch.int32))


def _beam_search_scan(log_probs, il, W: int, K: int, s_cap: int, blank: int,
                      lm=None, lm_alpha: float = 0.0, lm_beta: float = 0.0,
                      token_min_logp=None, candidates=None):
    """Batched CTC prefix beam search as a loop over frames (log_probs
    (T, N, V) float32 or float64, il (N,) frame counts; see
    `_beam_scan_steps`), from the empty state to the ranked beams:
    tokens, lengths, scores and times as `_beam_scan_rank` returns them.
    The LM's `final` adds its end-of-sequence term."""
    ref = log_probs if log_probs is not None else candidates[0]
    state = _beam_scan_state0(ref.shape[1], W, s_cap, lm, ref.dtype,
                              ref.device)
    state = _beam_scan_steps(log_probs, il, state, W, K, s_cap, blank, lm=lm,
                             lm_alpha=lm_alpha, lm_beta=lm_beta,
                             token_min_logp=token_min_logp,
                             candidates=candidates)
    return _beam_scan_rank(state, lm=lm, lm_alpha=lm_alpha)


def beam_search_from_topk(lpk, ck, lpb, input_lengths, beam_width: int,
                          blank: int, max_symbols: int, lm=None,
                          lm_alpha: float = 0.0, lm_beta: float = 0.0,
                          return_timestamps: bool = False):
    """Batched beam search from precomputed per-frame candidates.

    lpk/ck: (T, N, K) top-K log-probs / token ids, best first; lpb: (T, N)
    blank log-probs.  The JAX package's candidate-only semantics: every
    extension and the repeat ("stay") term read the K candidates only,
    so this is exact when they cover the vocabulary and otherwise the beam
    kernel's documented prune.  With no LM, or a dense bigram `NGramLM`
    of at most 63 symbols, it is the beam kernel's contract with its stay
    window ks = K: all frames' steps (`beam_step`, K4, or K5 with the
    bigram, its end-of-sequence bonus added after) and the backtrace
    kernel on CUDA tensors, their plain versions on CPU ones; outside the
    kernel's envelope (beam_width > 32, K > 128, not float32) the CUDA
    path raises.  Any other LM of the protocol is fused per frame by the
    prefix-beam scan over the candidates (JAX's candidate-only scan).
    Returns (tokens (N, W, max_symbols) int32, lengths (N, W) int32,
    scores (N, W) and, with return_timestamps, times (N, W, max_symbols)
    emission frames).
    """
    lpk = torch.as_tensor(lpk)
    dev = lpk.device
    ck = torch.as_tensor(ck, device=dev).to(torch.int32)
    lpb = torch.as_tensor(lpb, device=dev).to(lpk.dtype)
    il = torch.as_tensor(input_lengths, device=dev).to(torch.int32)
    W, K, s_cap = int(beam_width), lpk.shape[2], int(max_symbols)
    inc = None
    if lm is not None:
        check_lm_device(lm, dev)
        # the candidates carry no vocabulary size: the LM's own is taken
        ok, _ = lm_fusion_supported(lm, getattr(lm, "_v", 0), W)
        if not ok:
            out = _beam_search_scan(
                None, il, W, K, s_cap, int(blank), lm=lm,
                lm_alpha=float(lm_alpha), lm_beta=float(lm_beta),
                candidates=(lpk, ck, lpb))
            return out if return_timestamps else out[:3]
        inc = lm_alpha * lm._table + lm_beta
    bp, scores, last, _ = beam_step(lpk.contiguous(), ck.contiguous(),
                                    lpb.contiguous(), il, W, K, s_cap,
                                    int(blank), inc=inc)
    if lm is not None:  # end-of-sequence bonus, after the last frame
        eos = lm._eos[last.long().clamp(0, lm._v - 1)]
        scores = scores + torch.where(last >= 0, lm_alpha * eos, 0.0)
    out = backtrace(bp, ck, scores, W, K, s_cap)
    return out if return_timestamps else out[:3]


def beam_search_decode(
    log_probs,
    input_lengths=None,
    beam_width: int = 8,
    blank: int = 0,
    prune_k: int | None = None,
    max_symbols: int | None = None,
    lm=None,
    lm_alpha: float = 0.0,
    lm_beta: float = 0.0,
    approx_topk: bool = False,
    implementation: str = "auto",
    lm_chunk_t: int = 128,
    return_timestamps: bool = False,
    token_min_logp: float | None = None,
    guide_lm=None,
    from_logits: bool = False,
    batch_first: bool = False,
):
    """Batched CTC prefix beam search.

    Args:
      log_probs: (T, N, C) log-probabilities; (N, T, C) with batch_first;
        logits with from_logits (log_softmax is applied first).
      input_lengths: (N,) valid frame counts (default T).
      beam_width: live prefixes W (the kernel path takes <= 32).
      prune_k: extension candidates per frame (the kernel path takes
        <= 128); None = the full vocabulary.
      max_symbols: cap on the decoded length (default min(T, 512)); a
        prefix stops growing there.
      lm / lm_alpha / lm_beta: shallow-fusion LM (ops/lm.py, tables on the
        lattice's device), its weight and per-token insertion bonus.
      approx_topk: accepted; the top-k is exact (as XLA computes JAX's
        approximate one off the TPU).
      implementation: 'auto' (the kernel path where its envelope takes
        the configuration, else the scan), 'pallas' (the kernel path;
        ValueError outside its envelope), 'xla' (the scan: any
        configuration, any LM of the protocol fused per frame) or
        'chunked' (LM steering once per `lm_chunk_t` frames, exact scores;
        any LM with score_chunk).
      lm_chunk_t: frames per chunk of the chunked decode.
      return_timestamps: also return per-token emission frames.
      token_min_logp: drop candidates with log p below this, except each
        frame's best.
      guide_lm: only with 'chunked': a dense `NGramLM` or a
        `QuantizedBigramGuide` fused in the kernel to steer pruning
        between chunk boundaries (scores stay those of `lm`).

    Returns:
      tokens (N, W, max_symbols) int32 (-1 pad, best beam first), lengths
      (N, W) int32, scores (N, W) f32 log p(prefix) plus the LM bonus
      (-inf for dead beams), and times (N, W, max_symbols) int32 with
      return_timestamps.
    """
    with span("ctc.beam"):
        if implementation not in ("auto", "pallas", "chunked", "xla"):
            raise ValueError(f"invalid implementation {implementation!r}")
        if guide_lm is not None and implementation != "chunked":
            raise ValueError("guide_lm is only meaningful with "
                             "implementation='chunked' (it steers between "
                             "chunk boundaries)")
        log_probs = torch.as_tensor(log_probs)
        if batch_first:
            log_probs = log_probs.transpose(0, 1)
        if log_probs.dtype in (torch.bfloat16, torch.float16):
            log_probs = log_probs.float()
        if from_logits:
            log_probs = torch.log_softmax(log_probs, dim=-1)
        t_max, n, v = log_probs.shape
        if implementation == "chunked":
            if lm is None or not hasattr(lm, "score_chunk"):
                raise ValueError("implementation='chunked' requires an lm "
                                 "with score_chunk")
            return beam_search_chunked_lm(
                log_probs, input_lengths, beam_width=beam_width, blank=blank,
                prune_k=prune_k, max_symbols=max_symbols, lm=lm,
                lm_alpha=lm_alpha, lm_beta=lm_beta, chunk_t=lm_chunk_t,
                return_timestamps=return_timestamps,
                token_min_logp=token_min_logp, guide_lm=guide_lm)
        W = int(beam_width)
        K = min(int(prune_k or v), v)
        s_cap = int(max_symbols or min(t_max, 512))
        ok, reason = beam_supported(W, K, log_probs.dtype)
        if ok and lm is not None:
            ok, reason = lm_fusion_supported(lm, v, W)
        if implementation == "pallas" and not ok:
            raise ValueError(f"implementation='pallas' unsupported: {reason}")
        check_lm_device(lm, log_probs.device)
        if input_lengths is None:
            il = torch.full((n,), t_max, dtype=torch.int32)
        else:
            il = torch.as_tensor(input_lengths).to(torch.int32)
        il = il.to(log_probs.device)
        log_probs = log_probs.contiguous()
        if implementation == "xla" or not ok:
            if implementation == "auto":
                hint = ("; implementation='chunked' runs this LM on the "
                        "kernel (chunk-granular steering, exact scores)"
                        if lm is not None and hasattr(lm, "score_chunk")
                        else "")
                logging.getLogger(__name__).info(
                    "beam_search_decode: running the prefix-beam scan (%s)%s",
                    reason, hint)
            out = _beam_search_scan(
                log_probs, il, W, K, s_cap, int(blank), lm=lm,
                lm_alpha=float(lm_alpha), lm_beta=float(lm_beta),
                token_min_logp=(None if token_min_logp is None
                                else float(token_min_logp)))
            return out if return_timestamps else out[:3]
        ks = min(K + 8, v)  # the stay term's window (see module docstring)
        with span("ctc.beam.topk"):
            lpk, ck = topk(log_probs, ks)
            lpk, ck = apply_token_min_logp(lpk, ck, token_min_logp)
        with span("ctc.beam.step"):
            lpb = log_probs[:, :, blank].contiguous()
            inc = None if lm is None else lm_alpha * lm._table + lm_beta
            bp, scores, last, _ = beam_step(lpk, ck, lpb, il, W, K, s_cap,
                                            int(blank), inc=inc)
        if lm is not None:  # end-of-sequence bonus, after the last frame
            eos = lm._eos[last.long().clamp(0, v - 1)]
            scores = scores + torch.where(last >= 0, lm_alpha * eos, 0.0)
        with span("ctc.beam.backtrace"):
            out = backtrace(bp, ck, scores, W, K, s_cap)
        return out if return_timestamps else out[:3]


class BeamSearchCTCDecoder:
    """Class-style beam decoder: static config; `decode()` returns the best
    hypothesis per sample, `decode_beams()` every live beam with its score."""

    def __init__(self, beam_width: int = 8, blank: int = 0, labels=None,
                 prune_k: int | None = None, max_symbols: int | None = None,
                 lm=None, lm_alpha: float = 0.0, lm_beta: float = 0.0,
                 implementation: str = "auto", lm_chunk_t: int = 128,
                 token_min_logp: float | None = None,
                 from_logits: bool = False, batch_first: bool = False):
        self.beam_width = beam_width
        self.blank = blank
        self.labels = list(labels) if labels is not None else None
        self.prune_k = prune_k
        self.max_symbols = max_symbols
        self.lm = lm
        self.lm_alpha = lm_alpha
        self.lm_beta = lm_beta
        self.implementation = implementation
        self.lm_chunk_t = lm_chunk_t
        self.token_min_logp = token_min_logp
        self.from_logits = from_logits
        self.batch_first = batch_first

    def _to_text(self, ids):
        return "".join(self.labels[c] for c in ids) if self.labels else ids

    def decode_beams(self, log_probs, input_lengths=None,
                     return_timestamps=False):
        log_probs = torch.as_tensor(log_probs)
        t_max = log_probs.shape[1 if self.batch_first else 0]
        out = beam_search_decode(
            log_probs, input_lengths, beam_width=self.beam_width,
            blank=self.blank, prune_k=self.prune_k,
            max_symbols=self.max_symbols, lm=self.lm,
            lm_alpha=self.lm_alpha, lm_beta=self.lm_beta,
            implementation=self.implementation, lm_chunk_t=self.lm_chunk_t,
            return_timestamps=return_timestamps,
            token_min_logp=self.token_min_logp,
            from_logits=self.from_logits, batch_first=self.batch_first)
        tokens, lengths, scores = (x.cpu() for x in out[:3])
        times = out[3].cpu() if return_timestamps else None
        s_cap = self.max_symbols or min(t_max, 512)
        if bool((lengths >= s_cap).any()):
            warnings.warn(
                f"beam(s) saturated the max_symbols cap ({s_cap}); prefix "
                "growth was frozen there: raise max_symbols for very long "
                "transcripts")
        res = []
        for i in range(tokens.shape[0]):
            beams = []
            for w in range(self.beam_width):
                if not torch.isfinite(scores[i, w]):
                    continue
                ids = tokens[i, w, : int(lengths[i, w])].tolist()
                entry = (self._to_text(ids), float(scores[i, w]))
                if return_timestamps:
                    entry += (times[i, w, : int(lengths[i, w])].tolist(),)
                beams.append(entry)
            res.append(beams)
        return res

    def decode(self, log_probs, input_lengths=None):
        beams = self.decode_beams(log_probs, input_lengths)
        texts = [b[0][0] if b else self._to_text([]) for b in beams]
        scores = [b[0][1] if b else float("-inf") for b in beams]
        return texts, scores

"""Batched CTC prefix beam search, with LM shallow fusion (torch port of
`end2end_tpu/ops/beam_search.py`).

The beam kernel's semantics throughout: a top-k over the vocabulary
(`topk_cuda.topk`), all frames' beam steps (`beam_search_cuda.beam_step`)
and a backtrace.  On CUDA tensors the top-k and the beam step are the CUDA
kernels, at every vocabulary size; on CPU tensors their plain versions.
Extensions come from the first K = prune_k slots and the repeat term reads
a ks = min(K + 8, V) window, so at prune_k = V (the default) this is the
exact prefix beam search.

LM routing follows the JAX package's kernel envelope:
  * a dense `NGramLM` with V + 1 <= 64 fuses in the kernel, per frame
    (K5), under 'auto' and 'pallas' (the JAX name of the forced-kernel
    mode, kept so callers' code carries over), with the end-of-sequence
    bonus added after the kernel;
  * implementation='chunked' runs any LM with `score_chunk` through the
    chunked decode (ops/beam_chunked.py), optionally steered per frame by
    `guide_lm`.
Not ported yet, each raising NotImplementedError that names ROADMAP.md
queue 1 item 5: the per-frame LM scan (implementation='xla', and 'auto'
with an LM outside the kernel's envelope) and the approximate top-k.
"""

from __future__ import annotations

import warnings

import torch

from .beam_chunked import beam_search_chunked_lm
from .beam_search_cuda import (
    apply_token_min_logp,
    backtrace,
    beam_step,
    beam_supported,
    check_lm_device,
    lm_fusion_supported,
)
from .topk_cuda import topk

_ITEM5 = "ROADMAP.md queue 1 item 5, what is left of LM fusion"


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
      beam_width: live prefixes W (<= 32).
      prune_k: extension candidates per frame (<= 128); None = the full
        vocabulary.
      max_symbols: cap on the decoded length (default min(T, 512)); a
        prefix stops growing there.
      lm / lm_alpha / lm_beta: shallow-fusion LM (ops/lm.py, tables on the
        lattice's device), its weight and per-token insertion bonus.
      implementation: 'auto' or 'pallas' (the kernel path; 'pallas' raises
        ValueError for an LM outside the in-kernel envelope), or 'chunked'
        (LM steering once per `lm_chunk_t` frames, exact scores; any LM
        with score_chunk).
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
    if implementation not in ("auto", "pallas", "chunked", "xla"):
        raise ValueError(f"invalid implementation {implementation!r}")
    if guide_lm is not None and implementation != "chunked":
        raise ValueError("guide_lm is only meaningful with "
                         "implementation='chunked' (it steers between "
                         "chunk boundaries)")
    if implementation == "xla":
        raise NotImplementedError(
            f"the per-frame LM scan (implementation='xla') is not ported "
            f"yet: {_ITEM5}")
    if approx_topk:
        raise NotImplementedError(f"approx_topk is not ported yet: {_ITEM5}")
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
            raise ValueError("implementation='chunked' requires an lm with "
                             "score_chunk")
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
    if not ok:
        raise ValueError(reason)
    if lm is not None:
        ok, reason = lm_fusion_supported(lm, v, W)
        if not ok and implementation == "pallas":
            raise ValueError(f"implementation='pallas' unsupported: {reason}")
        if not ok:
            raise NotImplementedError(
                f"{reason}; the per-frame LM scan that takes other LMs is "
                f"not ported yet ({_ITEM5}); implementation='chunked' runs "
                "any LM with score_chunk")
        check_lm_device(lm, log_probs.device)
    if input_lengths is None:
        il = torch.full((n,), t_max, dtype=torch.int32)
    else:
        il = torch.as_tensor(input_lengths).to(torch.int32)
    il = il.to(log_probs.device)
    log_probs = log_probs.contiguous()
    ks = min(K + 8, v)  # the stay term's window (see module docstring)
    lpk, ck = topk(log_probs, ks)
    lpk, ck = apply_token_min_logp(lpk, ck, token_min_logp)
    lpb = log_probs[:, :, blank].contiguous()
    inc = None if lm is None else lm_alpha * lm._table + lm_beta
    bp, scores, last, _ = beam_step(lpk, ck, lpb, il, W, K, s_cap,
                                    int(blank), inc=inc)
    if lm is not None:  # end-of-sequence bonus, after the last frame
        eos = lm._eos[last.long().clamp(0, v - 1)]
        scores = scores + torch.where(last >= 0, lm_alpha * eos, 0.0)
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

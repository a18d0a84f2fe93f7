"""Chunked beam search with LM steering (torch port of
`end2end_tpu/ops/beam_chunked.py`): kernel-speed decoding for LMs the beam
kernel cannot fuse per frame (word LMs, large vocabularies).

A host loop over chunks of `chunk_t` frames.  Each chunk:
  * resumes the beam kernel from the carried 10-field state (K7), so the
    accumulated LM bonus of each beam ranks this chunk's candidates;
  * walks the chunk's backpointers back to each surviving lane's ancestor
    at the chunk start, and re-homes the LM state to it with `gather`;
  * replays each beam's tokens emitted in the chunk through the LM's
    vectorised `score_chunk`;
  * writes `bonus + alpha * lm_logp + beta * n_tokens` into the carried
    `lm` field.
Every surviving hypothesis's score is exact (as after rescoring, see
ops/rescore.py); what chunking changes is which tail hypotheses survive
pruning.  One chunk equals no-LM decoding plus rescoring.

`guide_lm` (a dense `NGramLM`, symbol-keyed: K5 inside K7; or a
`QuantizedBigramGuide`, class-keyed: K6 inside K7) adds per-frame
increments in the kernel to steer pruning between boundaries.  Its bonus
is thrown away at each boundary: the pre-chunk exact bonus is re-homed and
the chunk's exact bonus added, so scores are always those of `lm`.

Extensions come from the top-K slots with no +8 stay window (the JAX
chunked path's candidate set).  The last chunk may be short: JAX pads T to
a multiple of chunk_t with frozen frames, which change nothing.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .beam_search_cuda import (
    MAX_BEAM_WIDTH,
    MAX_CTX_ROWS,
    apply_token_min_logp,
    backtrace,
    beam_state_init,
    beam_step,
    beam_supported,
    check_lm_device,
    lane_walk,
    lm_fusion_supported,
)
from .indexing import compact_rows
from .lm import NGramLM, QuantizedBigramGuide
from .semiring import logaddexp2
from .topk_cuda import topk


def _rehome(state, src):
    """Rows w*N + n of an LM state (a tensor or a nest of tuples, lists
    and dicts of them) take the values of row src[w, n]*N + n: each lane
    inherits its ancestor's."""
    W, n = src.shape

    def one(x):
        xw = x.reshape(W, n, *x.shape[1:])
        idx = src.reshape(W, n, *(1,) * (x.dim() - 1)).expand_as(xw)
        return xw.gather(0, idx).reshape(x.shape)

    return tree_map(one, state)


def _resolve_guide(guide_lm, v: int, W: int, lm_alpha, lm_beta):
    """A guide's kernel inputs: (inc (C, V) = alpha * table + beta,
    cls_map (V,) or None), or (None, None) without a guide."""
    if guide_lm is None:
        return None, None
    if isinstance(guide_lm, QuantizedBigramGuide):
        if guide_lm._v != v:
            raise ValueError(f"guide_lm vocab ({guide_lm._v}) != lattice "
                             f"vocab ({v})")
        if guide_lm._n_classes + 1 > MAX_CTX_ROWS:
            raise ValueError(
                f"QuantizedBigramGuide supports n_classes + 1 <= "
                f"{MAX_CTX_ROWS} context rows (got "
                f"{guide_lm._n_classes + 1})")
        if W > MAX_BEAM_WIDTH:
            raise ValueError(f"guide_lm fusion supports beam_width <= "
                             f"{MAX_BEAM_WIDTH}")
        cls_map = guide_lm._cls_map
    elif not isinstance(guide_lm, NGramLM):
        raise ValueError("guide_lm must be a dense NGramLM (symbol-keyed, "
                         "fused in-kernel) or a QuantizedBigramGuide "
                         "(class-keyed, any vocab)")
    else:
        ok, why = lm_fusion_supported(guide_lm, v, W)
        if not ok:
            raise ValueError(f"guide_lm outside the fused-kernel envelope: "
                             f"{why}")
        cls_map = None
    return lm_alpha * guide_lm._table + lm_beta, cls_map


def decode_chunks(lpk, ck, lpb, il, W: int, s_cap: int, blank: int, lm,
                  lm_alpha: float, lm_beta: float, chunk_t: int, inc=None,
                  cls_map=None, step=beam_step, walk=None):
    """The chunk loop.  lpk/ck (T, N, K) candidates, lpb (T, N), il (N,)
    int32; inc/cls_map: the guide's kernel inputs; `step` is the beam step
    and `walk` the boundary's lane walk (`beam_step` and, for None,
    `lane_walk` route by device; the card's checks pass the plain twins).
    Returns bp (T, W, N) codes, scores (W, N) and the final kernel
    state."""
    walk = lane_walk if walk is None else walk
    t_max, n, k = lpk.shape
    state = beam_state_init(W, n, lpk.device)
    lm_state = lm.init_state(W * n)  # row w * N + n
    bps = []
    for t0 in range(0, t_max, chunk_t):
        t1 = min(t0 + chunk_t, t_max)
        pre_bonus = state[8]  # the exact bonus up to this chunk
        bp_c, _, _, state = step(lpk[t0:t1], ck[t0:t1], lpb[t0:t1], il - t0,
                                 W, k, s_cap, blank, inc=inc,
                                 cls_map=cls_map, state_in=state)
        # each end-of-chunk lane's ancestor lane at the chunk start, its
        # frame-aligned emitted tokens (-1 where it emitted nothing) and
        # their count
        lane0, toks, n_emit = walk(bp_c, ck[t0:t1], W, k)
        src = lane0.T  # (W, N)
        lm_state = _rehome(lm_state, src)
        toks = compact_rows(toks.transpose(0, 1).reshape(W * n, t1 - t0))
        delta, lm_state = lm.score_chunk(lm_state, toks)
        bonus = (lm_alpha * delta.reshape(W, n)
                 + lm_beta * n_emit.T.to(torch.float32))
        # with a guide the kernel's bonus is the guide's: start from the
        # exact pre-chunk bonus of each lane's ancestor instead
        base = (state[8] if inc is None
                else _rehome(pre_bonus.reshape(-1), src).reshape(W, n))
        state = state[:8] + (base + bonus,) + state[9:]
        bps.append(bp_c)
    scores = (logaddexp2(state[0], state[1]) + state[8]
              + lm_alpha * lm.final(lm_state).reshape(W, n))
    return torch.cat(bps), scores, state


def beam_search_chunked_lm_from_topk(lpk, ck, lpb, input_lengths, *, v: int,
                                     beam_width: int = 8, blank: int = 0,
                                     max_symbols: int | None = None,
                                     lm=None, lm_alpha: float = 0.0,
                                     lm_beta: float = 0.0,
                                     chunk_t: int = 128, interpret=None,
                                     return_timestamps: bool = False,
                                     guide_lm=None):
    """`beam_search_chunked_lm` from precomputed candidates: lpk/ck
    (T, N, K) top-K values and ids, lpb (T, N) blank log-probs, `v` the
    vocabulary size the ids index.  The values are decoded in float32, as
    in JAX; `interpret` (the JAX package's Pallas switch) is accepted and
    changes nothing."""
    del interpret
    if lm is None or not hasattr(lm, "score_chunk"):
        raise ValueError("beam_search_chunked_lm_from_topk requires an lm "
                         "with score_chunk")
    lpk = torch.as_tensor(lpk).to(torch.float32)
    lpb = torch.as_tensor(lpb, device=lpk.device).to(torch.float32)
    ck = torch.as_tensor(ck, device=lpk.device)
    t_max, n, k = lpk.shape
    W = int(beam_width)
    ok, reason = beam_supported(W, k, lpk.dtype)
    if not ok:  # the acoustic envelope (the LM side is chunk-scored)
        raise ValueError(f"beam_search_chunked_lm_from_topk: {reason}")
    check_lm_device(lm, lpk.device)
    check_lm_device(guide_lm, lpk.device)
    inc, cls_map = _resolve_guide(guide_lm, int(v), W, lm_alpha, lm_beta)
    s_cap = int(max_symbols or min(t_max, 512))
    il = torch.as_tensor(input_lengths).to(device=lpk.device,
                                           dtype=torch.int32)
    bp, scores, _ = decode_chunks(
        lpk.contiguous(), ck.to(torch.int32).contiguous(), lpb.contiguous(),
        il, W, s_cap, int(blank), lm, float(lm_alpha), float(lm_beta),
        int(chunk_t), inc, cls_map)
    out = backtrace(bp, ck, scores, W, k, s_cap)
    return out if return_timestamps else out[:3]


def beam_search_chunked_lm(log_probs, input_lengths=None, beam_width: int = 8,
                           blank: int = 0, prune_k: int | None = None,
                           max_symbols: int | None = None, lm=None,
                           lm_alpha: float = 0.0, lm_beta: float = 0.0,
                           chunk_t: int = 128, interpret=None,
                           return_timestamps: bool = False,
                           token_min_logp: float | None = None,
                           guide_lm=None):
    """Beam search with the LM steering once per `chunk_t` frames.

    Same returns as `beam_search_decode`; `lm` must implement
    `score_chunk`.  `guide_lm` (optional, steered with the same
    lm_alpha/lm_beta) fuses a dense `NGramLM` (V + 1 <= 64) or a
    `QuantizedBigramGuide` (any V, n_classes + 1 <= 64) in the kernel to
    steer pruning per frame; scores stay exactly those of `lm`.  The
    lattice is decoded in float32 (float64 log-probs are cast, as in JAX).
    `interpret`, the JAX package's Pallas switch, stands in its position
    and changes nothing.
    """
    del interpret
    if lm is None:
        raise ValueError("beam_search_chunked_lm requires an lm; use "
                         "beam_search_decode for no-LM decoding")
    if not hasattr(lm, "score_chunk"):
        raise ValueError(f"{type(lm).__name__} does not implement "
                         "score_chunk")
    log_probs = torch.as_tensor(log_probs).to(torch.float32)
    t_max, n, v = log_probs.shape
    K = min(int(prune_k or v), v)
    ok, reason = beam_supported(int(beam_width), K, log_probs.dtype)
    if not ok:
        raise ValueError(f"beam_search_chunked_lm: {reason}")
    if input_lengths is None:
        input_lengths = torch.full((n,), t_max, dtype=torch.int32)
    lpk, ck = topk(log_probs.contiguous(), K)  # no +8 stay window here
    lpk, ck = apply_token_min_logp(lpk, ck, token_min_logp)
    lpb = log_probs[:, :, blank].contiguous()
    return beam_search_chunked_lm_from_topk(
        lpk, ck, lpb, input_lengths, v=v, beam_width=beam_width, blank=blank,
        max_symbols=max_symbols, lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta,
        chunk_t=chunk_t, return_timestamps=return_timestamps,
        guide_lm=guide_lm)

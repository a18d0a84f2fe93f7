"""Incremental (streaming) decoding with explicit carried state (torch port
of `end2end_tpu/ops/streaming_decode.py`).

Feed lattice (CTC) or encoder (transducer) chunks as they arrive and carry
the decoder's state across calls.  Every decoder here runs a left-to-right
loop that the chunk edge only splits, so stepping chunks reproduces the
one-shot decode: the CTC greedy collapse and prefix-beam scan
(ops/greedy.py, ops/beam_search.py) and the transducer's greedy and ALSD
loops (ops/rnnt_decode.py).

A state is a tuple of tensors (and an LM's state nest): `torch.save` and
`torch.load` carry it, and no call writes into a state it was given, so
`finish()` is pure: call it mid-stream for the best hypotheses so far and
keep streaming.  The CTC decoders' `init` builds the state on `device=`
(the card by default, utils/device.py); the transducer decoders' on the
device of `init_hidden`.  A chunk must be on the state's device.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .beam_search import _beam_scan_rank, _beam_scan_state0, _beam_scan_steps
from .beam_search_cuda import check_lm_device
from .rnnt_decode import (_as_encoder_out, _bcast, _beam_carry0,
                          _greedy_carry0, _lengths, _prune_k,
                          _rnnt_beam_finish,
                          _rnnt_beam_scan, _rnnt_greedy_scan, _vocab_size)


# --------------------------------------------------------------------------
# CTC: greedy and prefix beam
# --------------------------------------------------------------------------

class StreamingGreedyDecoder:
    """Chunk-at-a-time greedy CTC decoding, exact against `greedy_decode`.

    Usage::

        dec = StreamingGreedyDecoder(blank=0, max_symbols=512)
        state = dec.init(batch_size)
        for chunk, chunk_len in stream:      # chunk: (Tc, N, V)
            state = dec.step(state, chunk, chunk_len)
        tokens, lengths, scores = dec.finish(state)

    The collapse carries across the chunk edge: a chunk's first frame is
    compared with the path symbol at the last valid frame before it.
    """

    def __init__(self, blank: int = 0, max_symbols: int = 512,
                 pad_id: int = -1):
        self.blank = int(blank)
        self.max_symbols = int(max_symbols)
        self.pad_id = int(pad_id)

    def init(self, batch_size: int, *, device=None):
        """(buffer (N, S), count (N,), the path symbol before the next
        frame (N,), score (N,))."""
        dev = resolve_device(device)
        n = batch_size
        return (torch.full((n, self.max_symbols), self.pad_id,
                           dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.float32, device=dev))

    def step(self, state, log_probs, chunk_lengths=None):
        buf, count, prev_id, score = state
        log_probs = torch.as_tensor(log_probs)
        t_max, n, _ = log_probs.shape
        dev = log_probs.device
        il = _lengths(chunk_lengths, n, t_max, dev)
        s_cap = self.max_symbols
        best, ids = log_probs.max(dim=-1)
        ids_nt = ids.T.to(torch.int32)                           # (N, T)
        t_mask = torch.arange(t_max, device=dev)[None] < il[:, None]
        prev = torch.cat([prev_id[:, None], ids_nt[:, :-1]], dim=1)
        keep = (ids_nt != self.blank) & (ids_nt != prev) & t_mask
        pos = count[:, None] + torch.cumsum(keep.to(torch.int32), dim=1) - 1
        # dropped symbols go to a spare column s_cap, sliced off
        slot = torch.where(keep & (pos < s_cap), pos, s_cap).long()
        buf = torch.cat([buf, buf[:, :1]], dim=1).scatter(
            1, slot, ids_nt)[:, :s_cap]
        count = count + keep.sum(dim=1).to(torch.int32)
        last = ids_nt.gather(1, (il - 1).clamp(0, max(t_max - 1, 0))
                             .long()[:, None])[:, 0] if t_max else prev_id
        prev_id = torch.where(il > 0, last, prev_id)
        score = score + torch.where(t_mask, best.T.float(), 0.0).sum(dim=1)
        return buf, count, prev_id, score

    def finish(self, state):
        buf, count, _, score = state
        return buf, count.clamp(max=self.max_symbols), score


class StreamingBeamDecoder:
    """Chunk-at-a-time prefix beam search, exact against
    `beam_search_decode(implementation='xla')` (the prefix-beam scan).

    The state is the scan's: token and time buffers, (p_blank,
    p_non_blank), prefix hashes and the LM's carry, and each sequence's
    global frame offset (timestamps are utterance frames).  For finished
    sequences pass `chunk_lengths=0` in later steps (their state freezes,
    as frames past `input_lengths` do in the one-shot call).
    `approx_topk` is accepted; the top-K is exact.
    """

    def __init__(self, beam_width: int = 8, blank: int = 0,
                 prune_k: int | None = None, max_symbols: int = 512,
                 lm=None, lm_alpha: float = 0.0, lm_beta: float = 0.0,
                 approx_topk: bool = False):
        self.beam_width = int(beam_width)
        self.blank = int(blank)
        self.prune_k = prune_k
        self.max_symbols = int(max_symbols)
        self.lm = lm
        self.lm_alpha = float(lm_alpha)
        self.lm_beta = float(lm_beta)
        self.approx_topk = bool(approx_topk)

    def init(self, batch_size: int, *, device=None):
        """(the scan's state, global frame offsets (N,)); on the LM's
        device when there is an LM and no `device`."""
        if device is None and self.lm is not None:
            dev = self.lm.device
        else:
            dev = resolve_device(device)
        core = _beam_scan_state0(batch_size, self.beam_width,
                                 self.max_symbols, self.lm, torch.float32,
                                 dev)
        return core, torch.zeros(batch_size, dtype=torch.int32, device=dev)

    def step(self, state, log_probs, chunk_lengths=None):
        core, offset = state
        log_probs = torch.as_tensor(log_probs).to(torch.float32)
        t_max, n, v = log_probs.shape
        dev = log_probs.device
        check_lm_device(self.lm, dev)
        cl = _lengths(chunk_lengths, n, t_max, dev)
        k = min(int(self.prune_k or v), v)
        core = _beam_scan_steps(
            log_probs, cl, core, self.beam_width, k, self.max_symbols,
            self.blank, lm=self.lm, lm_alpha=self.lm_alpha,
            lm_beta=self.lm_beta, t0=offset)
        return core, offset + cl

    def finish(self, state, return_timestamps: bool = False):
        out = _beam_scan_rank(state[0], lm=self.lm, lm_alpha=self.lm_alpha)
        return out if return_timestamps else out[:3]


# --------------------------------------------------------------------------
# Transducer (RNN-T): greedy and ALSD beam
# --------------------------------------------------------------------------

class StreamingRNNTGreedyDecoder:
    """Chunk-at-a-time greedy transducer decoding, exact against the
    one-shot `rnnt_greedy_decode` (the same loop; the cursor freezes at
    the chunk edge and resumes there).

    The transducer consumes ENCODER chunks (N, Tc, E); the joint runs
    inside.  The greedy cursor never looks back, so no frame history is
    carried.  Tokens, lengths and times are exact; scores past a binding
    symbol cap match to float32 sum order (the blank tail's batched sum).

    Usage::

        dec = StreamingRNNTGreedyDecoder(pred_step, init_hidden, joint_fn)
        state = dec.init(batch_size)
        for chunk, chunk_len in stream:      # chunk: (N, Tc, E)
            state = dec.step(state, chunk, chunk_len)
        tokens, lengths, scores = dec.finish(state)
    """

    def __init__(self, predictor_step, init_hidden, joint_fn, *,
                 blank: int = 0, max_symbols: int = 256,
                 max_symbols_per_frame: int = 4, lookahead: int = 1):
        self.pred_step = predictor_step
        self.init_hidden = torch.as_tensor(init_hidden)
        self.joint_fn = joint_fn
        self.blank = int(blank)
        self.s_cap = int(max_symbols)
        self.mpf = int(max_symbols_per_frame)
        self.lookahead = int(lookahead)

    def init(self, batch_size: int):
        """(the greedy carry, frames available so far (N,))."""
        n = batch_size
        carry = _greedy_carry0(n, self.s_cap, _bcast(self.init_hidden, (n,)))
        return carry, torch.zeros_like(carry[0])

    @torch.no_grad()
    def step(self, state, encoder_chunk, chunk_lengths=None):
        carry, avail = state
        enc = _as_encoder_out(encoder_chunk)
        n, tc, _ = enc.shape
        avail_new = avail + _lengths(chunk_lengths, n, tc, enc.device)
        carry = _rnnt_greedy_scan(
            enc, avail_new, avail_new, avail, carry, self.pred_step,
            self.joint_fn, self.blank, self.s_cap, self.mpf, tc + self.s_cap,
            self.lookahead)
        return carry, avail_new

    def finish(self, state, return_timestamps: bool = False):
        _, u, _, _, tokens, times, score = state[0]
        out = (tokens, u.clamp(max=self.s_cap), score, times)
        return out if return_timestamps else out[:3]


class StreamingRNNTBeamDecoder:
    """Chunk-at-a-time ALSD transducer beam search, exact against the
    one-shot `rnnt_beam_decode` (the same loop; a sample freezes whole,
    all beams together, whenever a live beam needs a frame past the chunk
    edge, which keeps their alignment length d = t + u in step).

    Beams of one step sit at different frames (t = d - u), so resuming
    needs a lookback: the state carries each sample's last `max_symbols`
    encoder frames, the largest spread of the beams' t (their u differ by
    at most the symbol cap).  Scores past a binding cap match to float32
    sum order (the blank tail's batched sum); tokens, lengths and times
    are exact.  An LM (`lm=`) rides the carried state across chunks.

    `finish()` is pure: it closes the stream (the remaining frames and the
    trailing blanks) on the state as given, and every step of that drain
    makes new tensors, so mid-stream calls leave the stream as it was.
    """

    def __init__(self, predictor_step, init_hidden, joint_fn, *,
                 beam_width: int = 4, prune_k: int | None = None,
                 blank: int = 0, max_symbols: int = 256,
                 lm=None, lm_alpha: float = 0.0, lm_beta: float = 0.0,
                 lookahead: int = 1):
        self.pred_step = predictor_step
        self.init_hidden = torch.as_tensor(init_hidden)
        self.joint_fn = joint_fn
        self.W = int(beam_width)
        self.prune_k = prune_k
        self.blank = int(blank)
        self.s_cap = int(max_symbols)
        self.lm = lm
        self.lm_alpha = float(lm_alpha)
        self.lm_beta = float(lm_beta)
        self.lookahead = int(lookahead)
        self._ks = {}

    def _k(self, h_enc):
        if h_enc not in self._ks:
            self._ks[h_enc] = _prune_k(self.prune_k, self.W, _vocab_size(
                self.joint_fn, h_enc, self.init_hidden))
        return self._ks[h_enc]

    def init(self, batch_size: int, h_enc: int):
        """(the beam carry, the last `max_symbols` frames (N, S, h_enc),
        frames available so far (N,)); h_enc is the encoder's width."""
        n = batch_size
        dev = self.init_hidden.device
        check_lm_device(self.lm, dev)
        carry = _beam_carry0(n, self.W, self.s_cap,
                             _bcast(self.init_hidden, (n, self.W)), self.lm)
        hist = torch.zeros((n, self.s_cap, h_enc), device=dev)
        return carry, hist, torch.zeros(n, dtype=torch.int32, device=dev)

    def _scan(self, enc, il, avail, t_off, carry, n_steps):
        return _rnnt_beam_scan(
            enc, il, avail, t_off, carry, self.pred_step, self.joint_fn,
            self.blank, self.W, self._k(enc.shape[2]), self.s_cap, n_steps,
            lm=self.lm, lm_alpha=self.lm_alpha, lm_beta=self.lm_beta,
            lookahead=self.lookahead)

    @torch.no_grad()
    def step(self, state, encoder_chunk, chunk_lengths=None):
        carry, hist, avail = state
        enc = _as_encoder_out(encoder_chunk)
        n, tc, _ = enc.shape
        cl = _lengths(chunk_lengths, n, tc, enc.device)
        lb = self.s_cap
        enc_eff = torch.cat([hist, enc], dim=1)  # frames avail - lb ..
        avail_new = avail + cl
        far = torch.full_like(avail, 2 ** 30)  # the stream is still open
        carry = self._scan(enc_eff, far, avail_new, avail - lb, carry,
                           tc + self.s_cap)
        # each sample's last lb frames: rows cl .. cl + lb of enc_eff
        at = cl.long()[:, None] + torch.arange(lb, device=enc.device)
        hist = enc_eff.gather(1, at[..., None].expand(n, lb, enc.shape[2]))
        return carry, hist, avail_new

    @torch.no_grad()
    def finish(self, state, return_timestamps: bool = False):
        carry, hist, avail = state
        lb = hist.shape[1]
        # the remaining lookback frames and the trailing blanks, until
        # every live hypothesis has consumed frame avail - 1
        carry = self._scan(hist, avail, avail, avail - lb, carry,
                           lb + self.s_cap + 1)
        out = _rnnt_beam_finish(carry, self.W, lm=self.lm,
                                lm_alpha=self.lm_alpha)
        return out if return_timestamps else out[:3]

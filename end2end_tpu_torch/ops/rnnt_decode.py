"""Transducer (RNN-T) decoding: greedy and ALSD beam search (torch port of
`end2end_tpu/ops/rnnt_decode.py`).

Greedy: the batch advances in lockstep, one joint evaluation per step;
each sample's (t, u) cursor moves on its own through masks: a blank (or a
forced blank) consumes the frame, a label is emitted and advances the
predictor.  `lookahead = F > 1` evaluates F consecutive frames a step
(the predictor state cannot change while blanks are consumed) and takes
the leading run of blanks plus at most one emission; its decisions are
the same per-frame argmaxes, so tokens, lengths and times equal F = 1's.

Beam: alignment-length synchronous decoding (ALSD, Saon et al. 2020).
Every live hypothesis at step d has consumed t frames and emitted u
tokens with t + u = d, so two hypotheses with the same label prefix are
the same lattice state, and merging them by a dual rolling prefix hash
with logaddexp is exact.  A step: one joint call on the N*W beams, the
per-beam top-K of the blank-masked logits (`topk_cuda.topk`: kernel K3
on the card), W*(K+1) candidates (a hold/blank and K extensions, each
extension paying its shallow-fusion LM delta up front), the exact merge,
the top-W (`topk` again, so lax.top_k's order among ties), then one
batched predictor step for the surviving emissions (the deferred advance)
and the LM state re-homed through the protocol's `select`.

Both loops are resumable: they take a carry with global frame cursors,
`avail` (N,) frames available so far and `t_off` (N,) the global frame
of the chunk's first row, and a sample whose cursor reaches the chunk's
edge freezes (ALSD: the whole sample, keeping its beams at one d).  The
one-shot decode is the call with avail = il and t_off = 0; the streaming
decoders (ops/streaming_decode.py) step chunks through the same loops.
The loops exit as soon as nothing but blank tails can progress (one host
check a step); a symbol-capped hypothesis then takes the blank at every
remaining frame, which one batched joint pass accounts for.  Tokens,
lengths and timestamps equal the JAX package's; scores agree to float32
sum order.

Protocol, batched (the JAX package vmaps per-sample functions instead):
  predictor_step(hidden (M, H), tokens (M,)) -> hidden' (M, H);
  joint_fn(f (..., E), hidden (..., H)) -> (..., V) logits, broadcasting
  over the leading axes.
A joint with ``precompute_frames`` / ``from_projected``
(`FactoredAdditiveJoint`) gets the frame projection done once per call.
The encoder output is decoded in float32 whatever type it comes in, as
in the JAX package.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .beam_search import _gather_w, _masked_logsumexp
from .beam_search_cuda import _wrap32, check_lm_device
from .lm import _where_rows
from .semiring import LOG0, LOG0_THRESHOLD
from .topk_cuda import topk

# ALSD's dual rolling hash: h' = h * M + token mod 2**32 (no + 1, unlike
# the CTC prefix scan), held as the signed value of the uint32 bits
_M1 = 2654435761
_M2 = 0x85EBCA6B
_SEED1, _SEED2 = 1, 7
_DEAD = 0xDEAD0000


class FactoredAdditiveJoint:
    """``logits = tanh(f @ W_enc + h @ W_pred + b) @ W_out + b_out`` with
    the frame projection ``f @ W_enc`` computable once per utterance
    (`precompute_frames`) and the per-step half on projected frames
    (`from_projected`).  Calling the instance applies the whole joint.
    The weights are held as float32 tensors (on the device they come on),
    whatever type they are given in, as in the JAX package."""

    def __init__(self, w_enc, w_pred, b_joint, w_out, b_out):
        self.w_enc, self.w_pred, self.b_joint, self.w_out, self.b_out = (
            torch.as_tensor(w).float()
            for w in (w_enc, w_pred, b_joint, w_out, b_out))

    def precompute_frames(self, enc):
        """(..., E) -> (..., J)."""
        return enc @ self.w_enc

    def from_projected(self, f_proj, h_vec):
        z = torch.tanh(f_proj + h_vec @ self.w_pred + self.b_joint)
        return z @ self.w_out + self.b_out

    def __call__(self, f_vec, h_vec):
        return self.from_projected(self.precompute_frames(f_vec), h_vec)


def additive_joint(w_enc, w_pred, b_joint, w_out, b_out):
    """The standard additive joint as a protocol `joint_fn`."""
    def joint_fn(f_vec, h_vec):
        z = torch.tanh(f_vec @ w_enc + h_vec @ w_pred + b_joint)
        return z @ w_out + b_out
    return joint_fn


def _resolve_joint(joint_fn, enc):
    """Project the frames once when the joint is factored."""
    if hasattr(joint_fn, "precompute_frames"):
        return joint_fn.precompute_frames(enc), joint_fn.from_projected
    return enc, joint_fn


def _as_encoder_out(encoder_out):
    enc = torch.as_tensor(encoder_out).to(torch.float32)
    if enc.ndim != 3:
        raise ValueError(f"encoder_out must be (N, T, E), got "
                         f"{tuple(enc.shape)}")
    return enc


def _lengths(input_lengths, n, t_max, dev):
    if input_lengths is None:
        return torch.full((n,), t_max, dtype=torch.int32, device=dev)
    return torch.as_tensor(input_lengths, device=dev).to(torch.int32)


def _prefix_states(predictor_step, init_hidden, tokens):
    """(M, S) token ids -> (M, S+1, H): the predictor state before each
    token and after the last, from `init_hidden` (H,) on every row."""
    with span("rnnt.predictor"):
        h = torch.as_tensor(init_hidden).to(tokens.device)
        hs = [h.expand(tokens.shape[0], *h.shape)]
        for col in tokens.T:
            hs.append(predictor_step(hs[-1], col))
        return torch.stack(hs, 1)


def _lse(logits):
    """logsumexp over the last axis as max + log(sum(exp(x - max)))."""
    m = logits.amax(-1)
    return m + torch.log(torch.exp(logits - m[..., None]).sum(-1))


def _bcast(x, lead):
    """x expanded to lead + x.shape, as a tensor of its own."""
    x = torch.as_tensor(x)
    return x.reshape((1,) * len(lead) + x.shape).expand(
        *lead, *x.shape).clone()


# --------------------------------------------------------------------------
# Greedy
# --------------------------------------------------------------------------

def _greedy_carry0(n, s_cap, hidden0):
    """(t, u, syms, hidden, tokens, times, score): the empty carry of N
    samples; hidden0 (N, H)."""
    dev = hidden0.device
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    return (zi, zi, zi, hidden0,
            torch.full((n, s_cap), -1, dtype=torch.int32, device=dev),
            torch.full((n, s_cap), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.float32, device=dev))


def _rnnt_greedy_scan(enc, il, avail, t_off, carry, pred_step, joint_fn,
                      blank, s_cap, max_per_frame, n_steps, lookahead=1):
    """The greedy decode over one encoder chunk, resumable: `enc` holds
    global frames [t_off, t_off + Tc) of each sample, `avail` (N,) the
    global frame count available so far, the carry's cursors are global.
    Returns the new carry; no tensor of the old one is written."""
    enc, joint_one = _resolve_joint(joint_fn, enc)
    n, t_max, _ = enc.shape
    dev = enc.device
    t, u, syms, hidden, tokens, times, score = carry
    rows = torch.arange(n, device=dev)
    u_iota = torch.arange(s_cap, device=dev)[None]
    limit = torch.minimum(il, avail)
    F = int(lookahead)
    f_iota = torch.arange(F, device=dev)[None]
    for _ in range(n_steps):
        if not bool(((t < limit) & (u < s_cap)).any()):
            break
        if F == 1:
            t_loc = (t - t_off).clamp(0, t_max - 1).long()
            logits = joint_one(enc[rows, t_loc], hidden)       # (N, V)
            lse = _lse(logits)
            k = logits.argmax(-1).to(torch.int32)
            active = t < limit
            forced = (syms >= max_per_frame) | (u >= s_cap)
            is_blank = (k == blank) | forced | ~active
            emit = active & ~is_blank
            t_emit = t
            lp_blank = logits[:, blank] - lse
            lp_k = logits.gather(1, k[:, None].long())[:, 0] - lse
            score = score + torch.where(
                active, torch.where(is_blank, lp_blank, lp_k),
                torch.zeros_like(lse))
            t_new = t + (is_blank & active).to(torch.int32)
            syms = torch.where(is_blank, torch.zeros_like(syms),
                               torch.where(emit, syms + 1, syms))
        else:
            # the F-frame window: the leading run of (forced) blanks, then
            # at most one emission at the stop frame
            t_glob = t[:, None] + f_iota                         # (N, F)
            t_loc = (t_glob - t_off[:, None]).clamp(0, t_max - 1).long()
            logits = joint_one(enc[rows[:, None], t_loc],
                               hidden[:, None])                  # (N, F, V)
            lse = _lse(logits)
            k_f = logits.argmax(-1).to(torch.int32)
            valid = t_glob < limit[:, None]
            # the symbol cap binds at every frame (u is fixed until the
            # window's one emission), the per-frame cap at frame 0 only
            blank_eff = ((k_f == blank) | (u >= s_cap)[:, None]
                         | ((f_iota == 0) & (syms >= max_per_frame)[:, None]))
            lead = torch.cumprod((valid & blank_eff).to(torch.int32),
                                 dim=1).bool()
            j = lead.sum(1)                                      # (N,) 0..F
            jj = j.clamp(max=F - 1)[:, None]
            stop_valid = valid.gather(1, jj)[:, 0]
            stop_blank = blank_eff.gather(1, jj)[:, 0]
            emit = (j < F) & stop_valid & ~stop_blank
            k = k_f.gather(1, jj)[:, 0]
            t_emit = t + j.to(torch.int32)
            lp_blank = logits[..., blank] - lse                  # (N, F)
            score = score + torch.where(lead, lp_blank, 0.0).sum(1)
            row = logits.gather(1, jj[:, :, None].expand(n, 1,
                                                         logits.shape[-1]))
            lp_k = (row[:, 0].gather(1, k[:, None].long())[:, 0]
                    - lse.gather(1, jj)[:, 0])
            score = score + torch.where(emit, lp_k, 0.0)
            t_new = t_emit
            syms = torch.where(emit, torch.where(j > 0, 1, syms + 1),
                               torch.where(j > 0, 0, syms)).to(torch.int32)
        wmask = emit[:, None] & (u_iota == u[:, None])
        tokens = torch.where(wmask, k[:, None], tokens)
        times = torch.where(wmask, t_emit[:, None], times)
        hidden = _where_rows(emit, pred_step(hidden, k), hidden)
        t = t_new
        u = u + emit.to(torch.int32)
    capped = (u >= s_cap) & (t < limit)
    if bool(capped.any()):  # the all-blank tail of symbol-capped samples
        lpb = torch.log_softmax(joint_one(enc, hidden[:, None]),
                                -1)[..., blank]                  # (N, Tc)
        t_iota = torch.arange(t_max, device=dev)[None]
        tmask = ((t_iota >= (t - t_off)[:, None])
                 & (t_iota < (limit - t_off)[:, None]))
        tail = torch.where(tmask, lpb, 0.0).sum(1)
        score = score + torch.where(capped, tail, 0.0)
        t = torch.where(capped, limit, t)
    return (t, u, syms, hidden, tokens, times, score)


@torch.no_grad()
def rnnt_greedy_decode(encoder_out, input_lengths, predictor_step,
                       init_hidden, joint_fn, *, blank: int = 0,
                       max_symbols: int | None = None,
                       max_symbols_per_frame: int = 4, lookahead: int = 1,
                       return_timestamps: bool = False):
    """Batched greedy transducer decoding.

    Args:
      encoder_out: (N, T, E) encoder outputs (decoded in float32).
      input_lengths: (N,) valid frames per sample (None: all T).
      predictor_step, joint_fn: the batched protocol (module docstring).
      init_hidden: (H,) predictor state of the empty prefix.
      blank: blank id.
      max_symbols: cap on emitted tokens (default min(T, 256)); also the
        width of the token buffer.
      max_symbols_per_frame: cap on consecutive emissions at one frame.
      lookahead: frames evaluated a step (>= 1); tokens, lengths and times
        are the same for every value, scores to float32 sum order.
      return_timestamps: also return the emission frame of each token.

    Returns (tokens (N, S) int32, -1-padded; lengths (N,); scores (N,),
    the log-probability of the greedy alignment) and, with
    `return_timestamps`, times (N, S).
    """
    if int(lookahead) < 1:
        raise ValueError(f"lookahead must be >= 1, got {lookahead}")
    enc = _as_encoder_out(encoder_out)
    n, t_max, _ = enc.shape
    il = _lengths(input_lengths, n, t_max, enc.device)
    s_cap = int(max_symbols or min(t_max, 256))
    hidden0 = _bcast(torch.as_tensor(init_hidden).to(enc.device), (n,))
    _, u, _, _, tokens, times, score = _rnnt_greedy_scan(
        enc, il, il, torch.zeros_like(il), _greedy_carry0(n, s_cap, hidden0),
        predictor_step, joint_fn, int(blank), s_cap,
        int(max_symbols_per_frame), t_max + s_cap, int(lookahead))
    out = (tokens, u, score, times)
    return out if return_timestamps else out[:3]


# --------------------------------------------------------------------------
# ALSD beam search
# --------------------------------------------------------------------------

def _dead_hashes(count, offset, dev):
    """Slot-unique hashes that match no live prefix."""
    return _wrap32(_DEAD + offset + torch.arange(count, device=dev))


def _beam_carry0(n, W, s_cap, hidden0, lm):
    """(t, u, score, h1, h2, tokens, times, hidden, lm_state): beam 0 the
    live empty prefix, the others dead; hidden0 (N, W, H); the LM state
    has N*W rows (None without an LM)."""
    dev = hidden0.device
    live0 = torch.arange(W, device=dev) == 0
    dead = _dead_hashes(W, 0, dev)
    zi = torch.zeros((n, W), dtype=torch.int32, device=dev)
    score0 = torch.where(live0, 0.0, LOG0).expand(n, W).clone()
    h1 = torch.where(live0, _SEED1, dead).expand(n, W).clone()
    h2 = torch.where(live0, _SEED2, dead).expand(n, W).clone()
    buf = torch.full((n, W, s_cap), -1, dtype=torch.int32, device=dev)
    lm_state = lm.init_state(n * W) if lm is not None else None
    return (zi, zi, score0, h1, h2, buf, buf.clone(), hidden0, lm_state)


def _select_core(t, u, score, h1, h2, lp_blank, lpk, ck, il, avail, s_cap,
                 lm, lm_state, lm_alpha, lm_beta):
    """One exact ALSD step from normalised candidate log-probs (lp_blank
    (N, W); lpk, ck (N, W, K)): candidates, merge, top-W.  Shared by the
    stepwise body and the lookahead window's mini-steps."""
    n, W, K = lpk.shape
    C = W * (K + 1)
    dev = lpk.device
    alive = score > LOG0_THRESHOLD
    finished = (t >= il[:, None]) & alive
    live = alive & ~finished
    # the chunk-edge freeze (never in a one-shot decode: avail == il)
    frozen = (live & (t >= avail[:, None])).any(1)
    sc_b = torch.where(alive, score + torch.where(live, lp_blank, 0.0), LOG0)
    can_emit = live & (u < s_cap)
    lm_ext = None
    if lm is not None:  # the LM delta of each extension, paid up front
        lm_lp, lm_ext = lm.score(lm_state, ck.reshape(n * W, K))
        lpk = lpk + lm_alpha * lm_lp.reshape(n, W, K) + lm_beta
    sc_k = torch.where(can_emit[..., None], score[..., None] + lpk, LOG0)
    cand_sc = torch.cat([sc_b[..., None], sc_k], 2).reshape(n, C)
    cand_tok = torch.cat([torch.full_like(ck[..., :1], -1), ck],
                         2).reshape(n, C)
    ckl = ck.long()
    ch1 = torch.cat([h1[..., None], _wrap32(h1[..., None] * _M1 + ckl)],
                    2).reshape(n, C)
    ch2 = torch.cat([h2[..., None], _wrap32(h2[..., None] * _M2 + ckl)],
                    2).reshape(n, C)
    cand_dead = cand_sc <= LOG0_THRESHOLD
    dead_c = _dead_hashes(C, 0x100, dev)
    ch1 = torch.where(cand_dead, dead_c, ch1)
    ch2 = torch.where(cand_dead, dead_c, ch2)
    # the exact merge: an equal prefix is the same (t, u) state, so the
    # candidates' masses add; the first of a set represents it
    eq = ((ch1[:, :, None] == ch1[:, None, :])
          & (ch2[:, :, None] == ch2[:, None, :]))               # (N, C, C)
    first = eq.to(torch.uint8).argmax(2)
    is_rep = first == torch.arange(C, device=dev)[None]
    merged = _masked_logsumexp(cand_sc[:, None, :], eq, (2,))
    merged = torch.where(is_rep, merged, LOG0)
    new_score, sel = topk(merged, W)                           # (N, W)
    sel = sel.long()
    parent = sel // (K + 1)
    emit = (sel % (K + 1)) > 0
    tok = cand_tok.gather(1, sel)
    nh1, nh2 = ch1.gather(1, sel), ch2.gather(1, sel)
    new_alive = new_score > LOG0_THRESHOLD
    emit = emit & new_alive
    pt, pu = t.gather(1, parent), u.gather(1, parent)
    pfin = finished.gather(1, parent)
    new_t = torch.where(pfin | emit, pt, pt + 1)
    new_u = pu + emit.to(torch.int32)
    dead_w = _dead_hashes(W, 0, dev)[None]
    return dict(t=torch.where(new_alive, new_t, 0),
                u=torch.where(new_alive, new_u, 0), score=new_score,
                h1=torch.where(new_alive, nh1, dead_w),
                h2=torch.where(new_alive, nh2, dead_w),
                parent=parent, emit=emit, tok=tok, pt=pt, pu=pu, sel=sel,
                lm_ext=lm_ext, frozen=frozen)


def _rnnt_beam_scan(enc, il, avail, t_off, carry, pred_step, joint_fn,
                    blank, W, K, s_cap, n_steps, lm=None, lm_alpha=0.0,
                    lm_beta=0.0, lookahead=1):
    """ALSD over one encoder chunk, resumable (module docstring): `enc`
    holds each sample's global frames [t_off, t_off + Tc).  A sample
    freezes whole the moment any live beam needs a frame >= avail, which
    keeps its beams at one alignment length, so resuming reproduces the
    one-shot trajectory.  Returns the new carry; no tensor of the old one
    is written."""
    F = int(lookahead)
    if F > 1 and lm is not None:
        raise ValueError("lookahead > 1 requires lm=None (shallow-fusion "
                         "LM state advances per step)")
    enc, joint_one = _resolve_joint(joint_fn, enc)
    n, t_max, _ = enc.shape
    dev = enc.device
    rows = torch.arange(n, device=dev)
    u_iota = torch.arange(s_cap, device=dev)[None, None]
    beam_rows = (rows[:, None] * W).expand(n, W)  # a sample's first LM row
    t_off_w = t_off[:, None]
    blank_idx = torch.tensor([blank], device=dev)

    def joint_rows(hidden, t, frames):
        """Normalised candidates of every beam at frames t .. t + frames-1:
        lp_blank (N, W, F), lpk and ck (N, W, F, K)."""
        f_iota = torch.arange(frames, device=dev)
        t_loc = (t[..., None] + f_iota - t_off_w[..., None]).clamp(
            0, t_max - 1).long()                                 # (N, W, F)
        logits = joint_one(enc[rows[:, None, None], t_loc],
                           hidden[:, :, None])                   # (N,W,F,V)
        lse = _lse(logits)
        lp_blank = logits[..., blank] - lse
        lgk, ck = topk(logits.index_fill(-1, blank_idx, LOG0), K)
        return lp_blank, lgk - lse[..., None], ck

    def body(carry):
        t, u, score, h1, h2, tokens, times, hidden, lm_state = carry
        lp_blank, lpk, ck = (x[:, :, 0] for x in joint_rows(hidden, t, 1))
        s = _select_core(t, u, score, h1, h2, lp_blank, lpk, ck, il, avail,
                         s_cap, lm, lm_state, lm_alpha, lm_beta)
        parent, emit, tok = s["parent"], s["emit"], s["tok"]
        wmask = emit[..., None] & (u_iota == s["pu"][..., None])
        new_tokens = torch.where(wmask, tok[..., None],
                                 _gather_w(tokens, parent))
        new_times = torch.where(wmask, s["pt"][..., None],
                                _gather_w(times, parent))
        # the deferred predictor advance: one batched step of all N*W beams
        phid = _gather_w(hidden, parent)
        adv = pred_step(phid.reshape(n * W, *phid.shape[2:]),
                        tok.clamp(min=0).reshape(-1)).reshape(phid.shape)
        new_hidden = _where_rows(emit, adv, phid)
        new_lm = lm_state
        if lm is not None:  # the representative's state, as the predictor
            kk = (s["sel"] % (K + 1) - 1).clamp(min=0)
            new_lm = lm.select(lm_state, s["lm_ext"],
                               (beam_rows + parent).reshape(-1),
                               kk.reshape(-1), (~emit).reshape(-1))
        # a frozen sample holds its whole carry (the step never happened)
        frozen = s["frozen"]
        held = _where_rows(frozen, carry[:8], (
            s["t"], s["u"], s["score"], s["h1"], s["h2"], new_tokens,
            new_times, new_hidden))
        if lm is not None:
            new_lm = _where_rows(frozen.repeat_interleave(W), lm_state,
                                 new_lm)
        return held + (new_lm,)

    def window_body(carry):
        """F frames' joints of every beam in one batched call, then up to
        F exact ALSD mini-steps replayed from them, stopping at the first
        that selects an emission (applied in full) or freezes.  The blank
        steps only permute the buffers, so their moves and the predictor
        advance are applied once, through the composed permutation."""
        t, u, score, h1, h2, tokens, times, hidden, lm_state = carry
        lpb_w, lpk_w, ck_w = joint_rows(hidden, t, F)
        stopped = torch.zeros(n, dtype=torch.bool, device=dev)
        mt, mu, msc = t, u, score
        perm = torch.arange(W, device=dev).expand(n, W)
        emit_p = torch.zeros((n, W), dtype=torch.bool, device=dev)
        tok_p = torch.full((n, W), -1, dtype=ck_w.dtype, device=dev)
        pu_p = torch.zeros_like(t)
        pt_p = torch.zeros_like(t)
        for j in range(F):
            s = _select_core(
                mt, mu, msc, h1.gather(1, perm), h2.gather(1, perm),
                lpb_w[:, :, j].gather(1, perm),
                _gather_w(lpk_w[:, :, j], perm),
                _gather_w(ck_w[:, :, j], perm), il, avail, s_cap, None, None,
                0.0, 0.0)
            apply = ~stopped & ~s["frozen"]
            mt, mu, msc, perm = _where_rows(apply, (
                s["t"], s["u"], s["score"], perm.gather(1, s["parent"])),
                (mt, mu, msc, perm))
            rec = apply & s["emit"].any(1)  # the stop step
            emit_p, tok_p, pu_p, pt_p = _where_rows(
                rec, (s["emit"], s["tok"], s["pu"], s["pt"]),
                (emit_p, tok_p, pu_p, pt_p))
            stopped = stopped | s["frozen"] | rec
            if bool(stopped.all()):
                break
        alive_f = msc > LOG0_THRESHOLD
        dead_w = _dead_hashes(W, 0, dev)[None]
        tok_u = tok_p.clamp(min=0).long()
        base_h1, base_h2 = h1.gather(1, perm), h2.gather(1, perm)
        nh1 = torch.where(emit_p, _wrap32(base_h1 * _M1 + tok_u), base_h1)
        nh2 = torch.where(emit_p, _wrap32(base_h2 * _M2 + tok_u), base_h2)
        wmask = emit_p[..., None] & (u_iota == pu_p[..., None])
        new_tokens = torch.where(wmask, tok_p[..., None],
                                 _gather_w(tokens, perm))
        new_times = torch.where(wmask, pt_p[..., None],
                                _gather_w(times, perm))
        phid = _gather_w(hidden, perm)
        adv = pred_step(phid.reshape(n * W, *phid.shape[2:]),
                        tok_u.reshape(-1)).reshape(phid.shape)
        return (mt, mu, msc, torch.where(alive_f, nh1, dead_w),
                torch.where(alive_f, nh2, dead_w), new_tokens, new_times,
                _where_rows(emit_p, adv, phid), lm_state)

    step = window_body if F > 1 else body
    for _ in range(n_steps):
        t, u, score = carry[:3]
        live = (score > LOG0_THRESHOLD) & (t < il[:, None])
        frozen = (live & (t >= avail[:, None])).any(1)
        if not bool((live & (u < s_cap) & ~frozen[:, None]).any()):
            break
        carry = step(carry)
    t, u, score, h1, h2, tokens, times, hidden, lm_state = carry
    # the all-blank tail of symbol-capped live beams, one batched pass
    lim = torch.minimum(il, avail)
    tailable = (score > LOG0_THRESHOLD) & (u >= s_cap) & (t < lim[:, None])
    if bool(tailable.any()):
        lpb = torch.log_softmax(joint_one(enc[:, None], hidden[:, :, None]),
                                -1)[..., blank]                  # (N,W,Tc)
        t_iota = torch.arange(t_max, device=dev)[None, None]
        tmask = ((t_iota >= (t - t_off_w)[..., None])
                 & (t_iota < (lim - t_off)[:, None, None]))
        tail = torch.where(tmask, lpb, 0.0).sum(2)
        score = torch.where(tailable, score + tail, score)
        t = torch.where(tailable, lim[:, None], t)
    return (t, u, score, h1, h2, tokens, times, hidden, lm_state)


def _rnnt_beam_finish(carry, W, lm=None, lm_alpha=0.0):
    """Rank a beam carry (pure, so mid-stream partials are fine): the
    end-of-sequence LM bonus, then the sort by final score."""
    t, u, score, h1, h2, tokens, times, hidden, lm_state = carry
    if lm is not None:
        bonus = lm_alpha * lm.final(lm_state).reshape(score.shape)
        score = torch.where(score > LOG0_THRESHOLD, score + bonus, score)
    score, order = topk(score, W)
    order = order.long()
    return (_gather_w(tokens, order), u.gather(1, order), score,
            _gather_w(times, order))


def _vocab_size(joint_fn, e, init_hidden):
    """The joint's output width, from one row."""
    h = torch.as_tensor(init_hidden)
    return joint_fn(torch.zeros((1, e), device=h.device), h[None]).shape[-1]


def _prune_k(prune_k, W, v):
    k = int(prune_k) if prune_k is not None else min(2 * W, v - 1)
    return max(1, min(k, v - 1))


@torch.no_grad()
def rnnt_beam_decode(encoder_out, input_lengths, predictor_step, init_hidden,
                     joint_fn, *, beam_width: int = 4,
                     prune_k: int | None = None, blank: int = 0,
                     max_symbols: int | None = None, lookahead: int = 1,
                     return_timestamps: bool = False, lm=None,
                     lm_alpha: float = 0.0, lm_beta: float = 0.0):
    """Batched transducer beam search: ALSD with exact prefix merging.

    Args are as `rnnt_greedy_decode`'s plus:
      beam_width: beams kept per sample (W).
      prune_k: non-blank tokens proposed per beam a step (default
        min(2 W, V-1); V-1 is exhaustive).
      max_symbols: emitted-token cap per hypothesis, the buffer's width
        (default min(T, 256)).
      lookahead: frames whose joints one step evaluates (>= 1; needs
        lm=None); up to that many exact ALSD steps are replayed from them,
        so beams, tokens, lengths and times equal lookahead=1's.
      lm / lm_alpha / lm_beta: optional shallow-fusion LM, any object of
        the ops/lm.py protocol or a `NeuralLM`, its tables on the encoder
        output's device: each extension is ranked with `lm_alpha * log
        p_LM + lm_beta` added, and `lm_alpha * lm.final(state)` is added at
        the end.  Returned scores include the bonus.

    Returns (tokens (N, W, S) int32 -1-padded, lengths (N, W), scores
    (N, W); LOG0 for dead beams) plus times (N, W, S) with
    `return_timestamps`, beams sorted by descending score.  With
    `beam_width` at least the number of reachable states and `prune_k =
    V-1`, a score is the hypothesis's exact total log-probability.
    """
    if int(lookahead) < 1:
        raise ValueError(f"lookahead must be >= 1, got {lookahead}")
    enc = _as_encoder_out(encoder_out)
    n, t_max, e = enc.shape
    dev = enc.device
    check_lm_device(lm, dev)
    il = _lengths(input_lengths, n, t_max, dev)
    s_cap = int(max_symbols or min(t_max, 256))
    W = int(beam_width)
    h0 = torch.as_tensor(init_hidden).to(dev)
    K = _prune_k(prune_k, W, _vocab_size(joint_fn, e, h0))
    carry = _rnnt_beam_scan(
        enc, il, il, torch.zeros_like(il),
        _beam_carry0(n, W, s_cap, _bcast(h0, (n, W)), lm), predictor_step,
        joint_fn, int(blank), W, K, s_cap, t_max + s_cap, lm=lm,
        lm_alpha=float(lm_alpha), lm_beta=float(lm_beta),
        lookahead=int(lookahead))
    out = _rnnt_beam_finish(carry, W, lm=lm, lm_alpha=float(lm_alpha))
    return out if return_timestamps else out[:3]

"""Transducer (RNN-T) greedy decoding (torch port of the greedy part of
`end2end_tpu/ops/rnnt_decode.py`).

The batch advances in lockstep, one joint evaluation per step; each
sample's (t, u) cursor moves on its own through masks: a blank (or a
forced blank) consumes the frame, a label is emitted and advances the
predictor.  The loop exits as soon as no sample is live (one host check
per step); a sample that hit the symbol cap then takes the blank at every
remaining frame, which one batched joint pass accounts for (its predictor
state can no longer change).  Tokens, lengths and timestamps equal the
JAX package's; scores agree to float32 sum order.

Protocol, batched (the JAX package vmaps per-sample functions instead):
  predictor_step(hidden (N, H), tokens (N,)) -> hidden' (N, H);
  joint_fn(f (..., E), hidden (..., H)) -> (..., V) logits, broadcasting
  over the leading axes.
A joint with ``precompute_frames`` / ``from_projected``
(`FactoredAdditiveJoint`) gets the frame projection done once before the
loop.

Not ported yet (ROADMAP.md queue 1, item 7): ``lookahead > 1``, the ALSD
beam search `rnnt_beam_decode`, the streaming decoders.
"""

from __future__ import annotations

import torch


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


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item 7)")


@torch.no_grad()
def rnnt_greedy_decode(encoder_out, input_lengths, predictor_step,
                       init_hidden, joint_fn, *, blank: int = 0,
                       max_symbols: int | None = None,
                       max_symbols_per_frame: int = 4, lookahead: int = 1,
                       return_timestamps: bool = False):
    """Batched greedy transducer decoding.

    Args:
      encoder_out: (N, T, E) encoder outputs.
      input_lengths: (N,) valid frames per sample (None: all T).
      predictor_step, joint_fn: the batched protocol (module docstring).
      init_hidden: (H,) predictor state of the empty prefix.
      blank: blank id.
      max_symbols: cap on emitted tokens (default min(T, 256)); also the
        width of the token buffer.
      max_symbols_per_frame: cap on consecutive emissions at one frame.
      lookahead: 1 only.
      return_timestamps: also return the emission frame of each token.

    Returns (tokens (N, S) int32, -1-padded; lengths (N,); scores (N,),
    the log-probability of the greedy alignment) and, with
    `return_timestamps`, times (N, S).
    """
    if int(lookahead) != 1:
        raise _not_ported("rnnt_greedy_decode(lookahead > 1)")
    enc = torch.as_tensor(encoder_out)
    if enc.ndim != 3:
        raise ValueError(f"encoder_out must be (N, T, E), got "
                         f"{tuple(enc.shape)}")
    n, t_max, _ = enc.shape
    dev = enc.device
    il = (torch.full((n,), t_max, dtype=torch.int32, device=dev)
          if input_lengths is None
          else torch.as_tensor(input_lengths, device=dev).to(torch.int32))
    s_cap = int(max_symbols or min(t_max, 256))
    enc, joint_one = _resolve_joint(joint_fn, enc)
    rows = torch.arange(n, device=dev)
    u_iota = torch.arange(s_cap, device=dev)[None]
    hidden = torch.as_tensor(init_hidden).to(dev).expand(
        n, *init_hidden.shape).clone()
    t = torch.zeros(n, dtype=torch.int32, device=dev)
    u = torch.zeros_like(t)
    syms = torch.zeros_like(t)
    tokens = torch.full((n, s_cap), -1, dtype=torch.int32, device=dev)
    times = torch.full_like(tokens, -1)
    score = torch.zeros(n, dtype=enc.dtype, device=dev)
    for _ in range(t_max + s_cap):
        if not bool(((t < il) & (u < s_cap)).any()):
            break
        logits = joint_one(enc[rows, t.clamp(0, t_max - 1).long()], hidden)
        m = logits.amax(-1)
        lse = m + torch.log(torch.exp(logits - m[:, None]).sum(-1))
        k = logits.argmax(-1).to(torch.int32)
        active = t < il
        forced = (syms >= max_symbols_per_frame) | (u >= s_cap)
        is_blank = (k == blank) | forced | ~active
        emit = active & ~is_blank
        wmask = emit[:, None] & (u_iota == u[:, None])
        tokens = torch.where(wmask, k[:, None], tokens)
        times = torch.where(wmask, t[:, None], times)
        hidden = torch.where(emit[:, None], predictor_step(hidden, k), hidden)
        lp_blank = logits[:, blank] - lse
        lp_k = logits.gather(1, k[:, None].long())[:, 0] - lse
        score = score + torch.where(
            active, torch.where(is_blank, lp_blank, lp_k),
            torch.zeros_like(lse))
        t = t + (is_blank & active).to(torch.int32)
        u = u + emit.to(torch.int32)
        syms = torch.where(is_blank, torch.zeros_like(syms),
                           torch.where(emit, syms + 1, syms))
    capped = (u >= s_cap) & (t < il)
    if bool(capped.any()):  # the all-blank tail of symbol-capped samples
        lpb = torch.log_softmax(joint_one(enc, hidden[:, None, :]),
                                -1)[..., blank]               # (N, T)
        t_iota = torch.arange(t_max, device=dev)[None]
        tmask = (t_iota >= t[:, None]) & (t_iota < il[:, None])
        tail = torch.where(tmask, lpb, torch.zeros_like(lpb)).sum(1)
        score = score + torch.where(capped, tail, torch.zeros_like(tail))
    out = (tokens, u, score, times)
    return out if return_timestamps else out[:3]


def rnnt_beam_decode(encoder_out, input_lengths, predictor_step, init_hidden,
                     joint_fn, *, beam_width: int = 4,
                     prune_k: int | None = None, blank: int = 0,
                     max_symbols: int | None = None, lookahead: int = 1,
                     return_timestamps: bool = False, lm=None,
                     lm_alpha: float = 0.0, lm_beta: float = 0.0):
    """ALSD beam search (the JAX package's signature): not ported yet."""
    raise _not_ported("rnnt_beam_decode (ALSD beam search)")

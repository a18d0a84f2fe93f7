"""Neural-LM shallow fusion (torch port of `end2end_tpu/ops/neural_lm.py`):
`NeuralLM`, the protocol wrapper around any stateful next-token model, and
the functional GRU cell (`gru_step`, `gru_logits`, `random_gru_params`;
also the transducer's predictor, whose states over a whole target sequence
are `gru_prefix_states`: on the card one kernel launch a direction,
`ops/gru_cuda.py`, held to the plain twins `gru_seq_forward_plain` and
`gru_seq_backward_plain`).

`NeuralLM`'s state defers each beam's last token: (hidden, pending), the
hidden state after the prefix less its last token and that token (-1:
none).  `score` advances every beam by its pending token once and all K
candidates share the advanced distribution; `select` commits the advanced
hidden for stay and extend alike.  A consumed token costs one network
step per surviving beam.  The model's `step_fn` and `logp_fn` are
unbatched, as in JAX, and batched over the beams with `torch.func.vmap`.

This GRU is not `torch.nn.GRU`'s: the reset gate scales the hidden state
BEFORE the candidate's matmul, ``cand = tanh([x, r*h] @ wh + bh)``, where
torch applies it after the hidden matmul.  Parameters are a dict of
tensors in the JAX layout: emb (V, E); wz, wr, wh (E+H, H) applied to
concat([x, h]); bz, br, bh (H,); wo (H, V), bo (V,) for `gru_logits`.
`gru_step` and `gru_logits` take one beam (h (H,), a token scalar) or a
batch (h (N, H), tokens (N,)).

The LSTM predictor (NeMo's RNN-T prediction network) is `torch.nn.LSTM`
itself: `lstm_prefix_states` runs it over [blank, y_1 .. y_U] in one call
(on the card one cuDNN call forward and one backward) and `lstm_step`
advances packed decoder states one token.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from ..utils.device import resolve_device
from ..utils.profiling import span
from . import gru_cuda
from .lm import _state_device, _where_rows
from .rnnt_decode import _prefix_states


class NeuralLM:
    """Shallow-fusion adapter for any stateful next-token model.

    step_fn(hidden, token) -> hidden' consumes one token and logp_fn(hidden)
    -> (V,) scores the next; both take ONE beam (a hidden nest of tensors
    without the beam axis, a 0-d token) and are vmapped over the beams
    here.  init_hidden: one beam's initial hidden (condition on <s> by
    baking it in), moved to `device` (the card by default).  `eos_id`: a
    token whose log-prob `final` adds once (KenLM's </s>); None = none.
    normalize: log-softmax logp_fn's output.  The decoder adds
    `lm_alpha * logp + lm_beta` per emitted token, as for the n-gram LMs.
    """

    def __init__(self, step_fn, logp_fn, init_hidden, vocab_size,
                 eos_id=None, normalize=True, *, device=None):
        dev = resolve_device(device)
        self._step = step_fn
        self._raw_logp = logp_fn
        self._h0 = tree_map(lambda x: torch.as_tensor(x, device=dev),
                            init_hidden)
        self._v = int(vocab_size)
        self._eos = None if eos_id is None else int(eos_id)
        self._norm = bool(normalize)

    @property
    def device(self) -> torch.device:
        return _state_device(self._h0)

    def _logp_rows(self, h):
        """(W, V) next-token log-probs of batched hidden states."""
        out = torch.func.vmap(self._raw_logp)(h)
        return torch.log_softmax(out, dim=-1) if self._norm else out

    def _advance(self, h, pending):
        """Consume each beam's pending token (none where pending < 0)."""
        stepped = torch.func.vmap(self._step)(h, pending.clamp(min=0))
        return _where_rows(pending >= 0, stepped, h)

    def init_state(self, w):
        h = tree_map(lambda x: x[None].expand(w, *x.shape).clone(), self._h0)
        return h, torch.full((w,), -1, dtype=torch.long, device=self.device)

    def score(self, state, ck):
        h, pending = state
        h_eff = self._advance(h, pending)
        logp = self._logp_rows(h_eff)  # (W, V)
        ck = ck.long()
        ckb = ck.expand(logp.shape[0], ck.shape[-1]) if ck.dim() == 1 else ck
        return logp.gather(1, ckb.clamp(0, self._v - 1)), (h_eff, ckb)

    def select(self, state, state_ext, parent, kk, is_stay):
        h_eff, ckb = state_ext
        # every survivor's prefix holds its parent's pending token, so the
        # advanced hidden is committed for stay and extend alike
        return (tree_map(lambda x: x[parent], h_eff),
                torch.where(is_stay, -1, ckb[parent, kk]))

    def final(self, state):
        h, pending = state
        if self._eos is None:
            return torch.zeros(pending.shape, device=pending.device)
        return self._logp_rows(self._advance(h, pending))[:, self._eos]

    def score_chunk(self, state, toks):
        """toks (M, C) in emission order, -1 padded at the end: exactly
        folding score/select token by token (the same advances, the same
        gathered rows), over the columns up to the longest row."""
        h, pending = state
        toks = toks.long()
        valid = toks >= 0
        lp_sum = torch.zeros(toks.shape[0], device=toks.device)
        for j in range(int(valid.sum(dim=1).max()) if toks.shape[0] else 0):
            h_eff = self._advance(h, pending)
            lp = self._logp_rows(h_eff).gather(
                1, toks[:, j:j + 1].clamp(0, self._v - 1))[:, 0]
            h = _where_rows(valid[:, j], h_eff, h)
            pending = torch.where(valid[:, j], toks[:, j], pending)
            lp_sum = lp_sum + torch.where(valid[:, j], lp, 0.0)
        return lp_sum, (h, pending)

    @classmethod
    def gru(cls, params, eos_id=None, normalize=True, precision=None, *,
            device=None):
        """A single-layer GRU LM from a dict of arrays (`gru_step`'s
        layout), hidden0 = zeros(H).  `precision` (the JAX package's MXU
        pass) is accepted and changes nothing: the port's matmuls are
        float32 (with TF32 off, torch's default for matmuls)."""
        del precision
        dev = resolve_device(device)
        p = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
             for k, v in params.items()}
        return cls(partial(gru_step, p), partial(gru_logits, p),
                   torch.zeros(p["wz"].shape[1], device=dev),
                   p["emb"].shape[0], eos_id=eos_id, normalize=normalize,
                   device=dev)


def gru_step(params, h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """One step: hidden (N, H) consumes token ids (N,), or (H,) one."""
    x = params["emb"][tok.long()]
    xh = torch.cat([x, h], -1)
    z = torch.sigmoid(xh @ params["wz"] + params["bz"])
    r = torch.sigmoid(xh @ params["wr"] + params["br"])
    cand = torch.tanh(torch.cat([x, r * h], -1) @ params["wh"]
                      + params["bh"])
    return (1.0 - z) * h + z * cand


def gru_logits(params, h: torch.Tensor) -> torch.Tensor:
    """Next-token logits (..., V) from hidden states (..., H)."""
    return h @ params["wo"] + params["bo"]


def gru_prefix_states(params, init_hidden, tokens):
    """(N, U) token ids -> (N, U+1, H): the GRU's state before each token
    and after the last, from `init_hidden` (H,) on every row (the
    transducer's predictor states).  CUDA weights: the sequence as one
    autograd Function, one launch of `csrc/gru_seq.cu` forward and one
    backward (`ops/gru_cuda.py`; float32 only, it raises on anything
    else).  CPU weights: the step loop, `rnnt_decode._prefix_states`."""
    if not params["wz"].is_cuda:
        return _prefix_states(partial(gru_step, params), init_hidden,
                              tokens)
    with span("rnnt.predictor"):
        return _gru_sequence(params, init_hidden, tokens)


def gru_seq_forward_plain(gx, wz_h, wr_h, wh_h, h0):
    """The kernel's forward in torch: gx (N, U, 3H), the x-side terms and
    biases of every step (z, r, candidate); the hidden-side weights
    (H, H); h0 (H,).  Returns the states (N, U+1, H) and the tape
    (N, U, 4H) of z, r, the candidate c and q = r * h."""
    h = wz_h.shape[0]
    hs = [h0.expand(gx.shape[0], h)]
    tape = []
    for g in gx.unbind(1):
        hp = hs[-1]
        z = torch.sigmoid(g[:, :h] + hp @ wz_h)
        r = torch.sigmoid(g[:, h:2 * h] + hp @ wr_h)
        q = r * hp
        c = torch.tanh(g[:, 2 * h:] + q @ wh_h)
        hs.append((1.0 - z) * hp + z * c)
        tape.append(torch.cat([z, r, c, q], 1))
    return torch.stack(hs, 1), torch.stack(tape, 1)


def gru_seq_backward_plain(d_states, states, tape, wz_h, wr_h, wh_h):
    """The kernel's backward in torch, derived by hand: from the states'
    cotangent (N, U+1, H) and the forward's states and tape, the
    gradients of the pre-activations (N, U, 3H) and of each row's h_0
    (N, H)."""
    h = wz_h.shape[0]
    g = d_states[:, -1]
    dgx = []
    for t in range(tape.shape[1] - 1, -1, -1):
        z, r, c, _ = tape[:, t].split(h, 1)
        hp = states[:, t]
        dac = g * z * (1.0 - c * c)
        daz = g * (c - hp) * z * (1.0 - z)
        dq = dac @ wh_h.T
        dar = dq * hp * r * (1.0 - r)
        g = (g * (1.0 - z) + dq * r + daz @ wz_h.T + dar @ wr_h.T
             + d_states[:, t])
        dgx.append(torch.cat([daz, dar, dac], 1))
    return torch.stack(dgx[::-1], 1), g


class _GRUSequence(torch.autograd.Function):
    """The predictor's whole sequence as one node: the x-side terms of
    every step in one matmul, the recurrence where the tensors are (the
    kernels on the card, raising on what they do not take; the plain
    twins on the CPU, which `gru_prefix_states` does not send here: the
    CPU tests hold this backward's matmuls to the loop through them), and
    in the backward the weight, bias and embedding gradients over all N U
    rows in a few matmuls and one index_add_."""

    @staticmethod
    def forward(ctx, tokens, emb, wz, wr, wh, bz, br, bh, h0):
        n, u = tokens.shape
        e, h = emb.shape[1], wz.shape[1]
        wx = torch.cat([wz[:e], wr[:e], wh[:e]], 1)
        x = emb[tokens].reshape(n * u, e)
        gx = torch.addmm(torch.cat([bz, br, bh]), x, wx).view(n, u, 3 * h)
        hidden = (wz[e:], wr[e:], wh[e:])
        fwd = gru_cuda.gru_forward if gx.is_cuda else gru_seq_forward_plain
        states, tape = fwd(gx, *hidden, h0)
        ctx.save_for_backward(tokens, emb, x, wx, states, tape, *hidden)
        return states

    @staticmethod
    def backward(ctx, d_states):
        tokens, emb, x, wx, states, tape, *hidden = ctx.saved_tensors
        bwd = (gru_cuda.gru_backward if states.is_cuda
               else gru_seq_backward_plain)
        dgx, dh0 = bwd(d_states.contiguous(), states, tape, *hidden)
        h = states.shape[2]
        dg = dgx.reshape(-1, 3 * h)
        hp = states[:, :-1].reshape(-1, h)
        q = tape[..., 3 * h:].reshape(-1, h)
        dwzr = torch.cat([x, hp], 1).T @ dg[:, :2 * h]
        dwh = torch.cat([x, q], 1).T @ dg[:, 2 * h:]
        demb = torch.zeros_like(emb).index_add_(
            0, tokens.reshape(-1).remainder(emb.shape[0]), dg @ wx.T)
        return (None, demb, dwzr[:, :h], dwzr[:, h:], dwh,
                *dg.sum(0).split(h), dh0.sum(0))


def _gru_sequence(params, init_hidden, tokens):
    """`_GRUSequence` on the predictor's parameters; tokens (N, U) long
    (-1 is the last row, as in `gru_step`'s indexing)."""
    h0 = torch.as_tensor(init_hidden).to(params["wz"].device)
    if tokens.shape[0] == 0 or tokens.shape[1] == 0:
        return h0.expand(tokens.shape[0], 1, *h0.shape).clone()
    return _GRUSequence.apply(
        tokens.long(), *(params[k] for k in (
            "emb", "wz", "wr", "wh", "bz", "br", "bh")), h0)


def _lstm_inputs(emb, ids, blank):
    """The embeddings of token ids, the blank's held at zero (NeMo's
    blank-as-padding embedding)."""
    return emb[ids] * (ids != blank)[..., None].to(emb.dtype)


def lstm_prefix_states(lstm, emb, tokens, blank: int = 0):
    """(N, U) token ids -> (N, U+1, H): the top layer's output after each
    of [blank, y_1 .. y_U] from zero states, the transducer's predictor
    outputs.  One call of `lstm` (a batch-first `torch.nn.LSTM`): no host
    loop.  Ids past a row's length are read as the blank."""
    with span("rnnt.predictor"):
        ids = F.pad(tokens.long(), (1, 0), value=blank)
        return lstm(_lstm_inputs(emb, ids, blank))[0]


def lstm_step(lstm, emb, state, tok, blank: int = 0):
    """One step of `lstm` from packed states (N, 2 L H): [h_1 .. h_L,
    c_1 .. c_L], the top layer's output h_L at (L - 1) H.  Consumes token
    ids (N,)."""
    n, L = state.shape[0], lstm.num_layers
    hc = state.view(n, 2, L, -1).permute(1, 2, 0, 3)
    x = _lstm_inputs(emb, tok.long(), blank)[:, None]
    _, (h, c) = lstm(x, (hc[0].contiguous(), hc[1].contiguous()))
    return torch.stack([h, c]).permute(2, 0, 1, 3).reshape(n, -1)


def random_gru_params(rng: np.random.Generator, vocab_size, emb_dim=32,
                      hidden_dim=64, scale=0.5):
    """Random GRU parameters as float32 numpy arrays, drawn from `rng` in
    the JAX package's order, so one seed gives the same weights."""
    def w(*shape):
        return (rng.standard_normal(shape) * scale
                / np.sqrt(shape[0])).astype(np.float32)

    e, h, v = emb_dim, hidden_dim, vocab_size
    return {
        "emb": w(v, e),
        "wz": w(e + h, h), "bz": np.zeros((h,), np.float32),
        "wr": w(e + h, h), "br": np.zeros((h,), np.float32),
        "wh": w(e + h, h), "bh": np.zeros((h,), np.float32),
        "wo": w(h, v), "bo": np.zeros((v,), np.float32),
    }

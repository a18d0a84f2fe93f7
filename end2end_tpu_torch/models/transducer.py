"""Conformer-Transducer: encoder + GRU predictor + additive joint (torch
port of `end2end_tpu/models/transducer.py`).

    model = ConformerTransducer(TransducerConfig(), seed=0)
    loss = model.loss(feats, lengths, targets, target_lengths)
    loss.backward()                      # gradients on model.parameters()
    tokens, lengths, scores = model.decode(feats, lengths)

Three parts: ``encoder``, the port's `ConformerEncoder` whose last Linear
projects to ``enc_dim`` features; ``pred``, the GRU predictor of
ops/neural_lm.py (its parameters in the JAX layout; training's states
over the targets are `gru_prefix_states`, on the card one kernel launch
forward and one backward); ``joint``, the additive joint
``W_out tanh(W_enc f + W_pred h + b) + b_out`` with (in, out) matrices.
Training builds the (N, T', U+1, V) joint logits and feeds
`rnnt_loss` (on the card: kernels K8/K9); decoding is greedy or ALSD beam
search (ops/rnnt_decode.py; the beam's top-k is kernel K3 on the card).
The predictor and joint weights are drawn from
``np.random.default_rng(seed)`` in the JAX model's order, so one seed gives
JAX's weights; the encoder's from a torch generator seeded the same.  Load
JAX parameters with `load_jax_params`.  Built on the card unless `device`
says otherwise (utils/device.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch import nn

from ..ops.neural_lm import gru_prefix_states, gru_step, random_gru_params
from ..ops.rnnt_decode import (FactoredAdditiveJoint, rnnt_beam_decode,
                               rnnt_greedy_decode)
from ..ops.rnnt_loss import rnnt_loss
from ..utils.convert import transducer_state_dict_from_jax
from ..utils.device import resolve_device
from ..utils.profiling import span
from .conformer import ConformerEncoder


@dataclass(frozen=True)
class TransducerConfig:
    vocab_size: int = 32          # includes blank at id 0
    n_mels: int = 80              # input feature dim
    d_model: int = 144
    num_layers: int = 2
    num_heads: int = 4
    conv_kernel: int = 15
    subsample: bool = True
    enc_dim: int = 144            # encoder output feature width
    emb_dim: int = 64             # predictor token embedding
    pred_hidden: int = 128        # predictor GRU state
    joint_dim: int = 128


def _params(arrays, dev):
    return nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v).to(dev))
                             for k, v in arrays.items()})


class ConformerTransducer(nn.Module):
    """Features (N, T, F) + lengths -> transducer loss / decode."""

    def __init__(self, config: TransducerConfig = TransducerConfig(), *,
                 device=None, seed: int = 0):
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        self.encoder = ConformerEncoder(
            vocab_size=c.enc_dim, d_model=c.d_model,
            num_layers=c.num_layers, num_heads=c.num_heads,
            conv_kernel=c.conv_kernel, n_mels=c.n_mels,
            subsample=c.subsample, device=dev,
            generator=torch.Generator().manual_seed(seed))
        rng = np.random.default_rng(seed)
        self.pred = _params(random_gru_params(
            rng, c.vocab_size, emb_dim=c.emb_dim, hidden_dim=c.pred_hidden),
            dev)

        def w(*shape):
            return (rng.standard_normal(shape)
                    / np.sqrt(shape[0])).astype(np.float32)

        self.joint = _params({
            "w_enc": w(c.enc_dim, c.joint_dim),
            "w_pred": w(c.pred_hidden, c.joint_dim),
            "b": np.zeros((c.joint_dim,), np.float32),
            "w_out": w(c.joint_dim, c.vocab_size),
            "b_out": np.zeros((c.vocab_size,), np.float32),
        }, dev)

    @property
    def device(self) -> torch.device:
        return self.joint["w_out"].device

    def load_jax_params(self, params) -> None:
        """Load the JAX model's {"enc", "pred", "joint"} params (nested
        dicts of numpy arrays)."""
        self.load_state_dict(transducer_state_dict_from_jax(params))

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def encode(self, feats, lengths):
        """(N, T, F) features + (N,) lengths -> (N, T', enc_dim) and the
        (N,) encoder lengths."""
        return self.encoder(self._tensor(feats, torch.float32),
                            self._tensor(lengths))

    def _pred_states(self, targets):
        """(N, U) target ids -> (N, U+1, H) prefix states (h_0 = 0); on
        the card one GRU kernel launch forward and one backward."""
        return gru_prefix_states(
            self.pred,
            torch.zeros(self.config.pred_hidden, device=self.device),
            self._tensor(targets).long())

    def joint_logits(self, enc, pred_states):
        """(N, T, E) x (N, U+1, H) -> (N, T, U+1, V) joint logits."""
        j = self.joint
        with span("rnnt.joint"):
            z = torch.tanh((enc @ j["w_enc"])[:, :, None]
                           + (pred_states @ j["w_pred"])[:, None] + j["b"])
            return z @ j["w_out"] + j["b_out"]

    def loss(self, feats, lengths, targets, target_lengths,
             reduction: str = "mean", implementation: str = "auto"):
        """The transducer loss of a batch (blank 0, from logits),
        differentiable wrt every parameter."""
        with span("transducer.loss"):
            enc, enc_len = self.encode(feats, lengths)
            logits = self.joint_logits(enc, self._pred_states(targets))
            return rnnt_loss(logits, self._tensor(targets),
                             enc_len, self._tensor(target_lengths), blank=0,
                             reduction=reduction, from_logits=True,
                             implementation=implementation)

    def decoder_fns(self):
        """(predictor_step, init_hidden, joint_fn) for ops/rnnt_decode.py;
        the joint is factored, so the decoder projects the frames once."""
        j = self.joint
        return (partial(gru_step, self.pred),
                torch.zeros(self.config.pred_hidden, device=self.device),
                FactoredAdditiveJoint(j["w_enc"], j["w_pred"], j["b"],
                                      j["w_out"], j["b_out"]))

    @torch.no_grad()
    def decode(self, feats, lengths, beam_width: int = 0,
               prune_k: int | None = None, max_symbols: int | None = None,
               return_timestamps: bool = False, lm=None,
               lm_alpha: float = 0.0, lm_beta: float = 0.0,
               lookahead: int = 1):
        """Greedy when beam_width == 0, else ALSD beam search (optionally
        LM-fused: any ops/lm.py protocol LM or a NeuralLM, on the model's
        device).

        Greedy returns (tokens (N, S), lengths, scores); beam the whole
        sorted beam (tokens (N, W, S), lengths, scores).  Timestamps, in
        encoder frames, are appended when asked for.  `lookahead` frames
        are evaluated a step (greedy, and beam without an LM); tokens,
        lengths and times are the same for every value.
        """
        enc, enc_len = self.encode(feats, lengths)
        pred, init_h, joint = self.decoder_fns()
        if beam_width == 0:
            return rnnt_greedy_decode(
                enc, enc_len, pred, init_h, joint, blank=0,
                max_symbols=max_symbols, lookahead=lookahead,
                return_timestamps=return_timestamps)
        return rnnt_beam_decode(
            enc, enc_len, pred, init_h, joint, blank=0,
            beam_width=beam_width, prune_k=prune_k,
            max_symbols=max_symbols, return_timestamps=return_timestamps,
            lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta,
            lookahead=lookahead if lm is None else 1)

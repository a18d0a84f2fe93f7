"""Conformer-Transducer: encoder + GRU predictor + additive joint (torch
port of `end2end_tpu/models/transducer.py`).

    model = ConformerTransducer(TransducerConfig(), seed=0)
    loss = model.loss(feats, lengths, targets, target_lengths)
    loss.backward()                      # gradients on model.parameters()
    tokens, lengths, scores = model.decode(feats, lengths)

Three parts: ``encoder``, the port's `ConformerEncoder` whose last Linear
projects to ``enc_dim`` features (with the config's FastConformer
options, models/conformer.py); ``pred``, the GRU predictor of
ops/neural_lm.py (its parameters in the JAX layout; training's states
over the targets are `gru_prefix_states`, on the card one kernel launch
forward and one backward) or, with ``predictor="lstm"``, NeMo's
prediction network `LSTMPredictor` (`lstm_prefix_states`: one
`torch.nn.LSTM` call, cuDNN's on the card); ``joint``, the additive joint
``W_out act(W_enc f + W_pred h + b) + b_out`` with (in, out) matrices and
act tanh (``joint_activation="relu"``: ReLU).  Parakeet-RNNT 1.1B is
``TransducerConfig(subsampling="dw_striding", subsampling_factor=8,
subsampling_conv_channels=256, self_attention="rel_pos", xscaling=True,
conv_norm="batch_norm", predictor="lstm", pred_layers=2,
joint_activation="relu")`` at its widths.
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

from ..ops.neural_lm import (gru_prefix_states, gru_step, lstm_prefix_states,
                             lstm_step, random_gru_params)
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
    subsampling: str = "striding"           # or "dw_striding"
    subsampling_factor: int = 4
    subsampling_conv_channels: int | None = None   # None: d_model
    self_attention: str = "abs_pos"         # or "rel_pos"
    xscaling: bool = False
    conv_norm: str = "layer_norm"           # or "batch_norm"
    predictor: str = "gru"                  # or "lstm"
    pred_layers: int = 1                    # the LSTM's layers
    joint_activation: str = "tanh"          # or "relu"


def _params(arrays, dev):
    return nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v).to(dev))
                             for k, v in arrays.items()})


class _ActivatedJoint(FactoredAdditiveJoint):
    """`FactoredAdditiveJoint` with `activation` in place of tanh, reading
    the predictor state's features [pred_offset, pred_offset + H): the
    top layer's output in a packed LSTM state (`lstm_step`)."""

    def __init__(self, w_enc, w_pred, b_joint, w_out, b_out, activation,
                 pred_offset: int):
        super().__init__(w_enc, w_pred, b_joint, w_out, b_out)
        self.activation, self.pred_offset = activation, pred_offset

    def from_projected(self, f_proj, h_vec):
        h = h_vec[..., self.pred_offset:self.pred_offset
                  + self.w_pred.shape[0]]
        z = self.activation(f_proj + h @ self.w_pred + self.b_joint)
        return z @ self.w_out + self.b_out


class LSTMPredictor(nn.Module):
    """NeMo's prediction network: an embedding `emb` (V, E) whose blank
    row is read as zeros, and a batch-first `torch.nn.LSTM` `lstm` of
    `layers` (gates i, f, g, o; torch's names and layout).  Drawn from
    `rng`: N(0, 1/fan_in) weights, N(0, 1) embeddings, zero biases but the
    input-side forget gate's 1.0 (NeMo's forget_gate_bias)."""

    def __init__(self, vocab: int, emb_dim: int, hidden: int, layers: int,
                 rng: np.random.Generator, device):
        super().__init__()
        self.emb = nn.Parameter(torch.from_numpy(rng.standard_normal(
            (vocab, emb_dim)).astype(np.float32)).to(device))
        self.lstm = nn.LSTM(emb_dim, hidden, layers, batch_first=True,
                            device=device)
        with torch.no_grad():
            for name, p in self.lstm.named_parameters():
                if name.startswith("weight"):
                    p.copy_(torch.from_numpy((rng.standard_normal(
                        p.shape) / np.sqrt(p.shape[1])).astype(np.float32)))
                else:
                    p.zero_()
                    if name.startswith("bias_ih"):
                        p[hidden:2 * hidden] = 1.0


class ConformerTransducer(nn.Module):
    """Features (N, T, F) + lengths -> transducer loss / decode."""

    def __init__(self, config: TransducerConfig = TransducerConfig(), *,
                 device=None, seed: int = 0):
        super().__init__()
        c = self.config = config
        if c.predictor not in ("gru", "lstm") or (
                c.predictor == "gru" and c.pred_layers != 1):
            raise ValueError(f"predictor {c.predictor!r} of "
                             f"{c.pred_layers} layers: the GRU has one")
        if c.joint_activation not in ("tanh", "relu"):
            raise ValueError(f"unknown joint_activation "
                             f"{c.joint_activation!r}")
        dev = resolve_device(device)
        self.encoder = ConformerEncoder(
            vocab_size=c.enc_dim, d_model=c.d_model,
            num_layers=c.num_layers, num_heads=c.num_heads,
            conv_kernel=c.conv_kernel, n_mels=c.n_mels,
            subsample=c.subsample, device=dev,
            generator=torch.Generator().manual_seed(seed),
            subsampling=c.subsampling,
            subsampling_factor=c.subsampling_factor,
            subsampling_conv_channels=c.subsampling_conv_channels,
            self_attention=c.self_attention, xscaling=c.xscaling,
            conv_norm=c.conv_norm)
        rng = np.random.default_rng(seed)
        if c.predictor == "lstm":
            self.pred = LSTMPredictor(c.vocab_size, c.emb_dim,
                                      c.pred_hidden, c.pred_layers, rng, dev)
        else:
            self.pred = _params(random_gru_params(
                rng, c.vocab_size, emb_dim=c.emb_dim,
                hidden_dim=c.pred_hidden), dev)
        self.activation = (torch.relu if c.joint_activation == "relu"
                           else torch.tanh)

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
        (N,) encoder lengths (in the encoder's dtype, float32 unless the
        model was cast)."""
        return self.encoder(self._tensor(feats, self.encoder.out.weight.dtype),
                            self._tensor(lengths))

    def _pred_states(self, targets):
        """(N, U) target ids -> (N, U+1, H) prefix states: the GRU's (h_0
        = 0; on the card one GRU kernel launch forward and one backward)
        or the LSTM's outputs over [blank, y_1 .. y_U]."""
        if self.config.predictor == "lstm":
            return lstm_prefix_states(self.pred.lstm, self.pred.emb,
                                      self._tensor(targets))
        return gru_prefix_states(
            self.pred,
            torch.zeros(self.config.pred_hidden, device=self.device),
            self._tensor(targets).long())

    def joint_logits(self, enc, pred_states):
        """(N, T, E) x (N, U+1, H) -> (N, T, U+1, V) joint logits."""
        j = self.joint
        with span("rnnt.joint"):
            z = self.activation((enc @ j["w_enc"])[:, :, None]
                                + (pred_states @ j["w_pred"])[:, None]
                                + j["b"])
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
        the joint is factored, so the decoder projects the frames once.
        The LSTM's state is packed (`lstm_step`); its initial one has read
        the blank."""
        j, c = self.joint, self.config
        w = (j["w_enc"], j["w_pred"], j["b"], j["w_out"], j["b_out"])
        if c.predictor == "lstm":
            step = partial(lstm_step, self.pred.lstm, self.pred.emb)
            zeros = torch.zeros(1, 2 * c.pred_layers * c.pred_hidden,
                                device=self.device)
            blank = torch.zeros(1, dtype=torch.long, device=self.device)
            return (step, step(zeros, blank)[0],
                    _ActivatedJoint(*w, self.activation,
                                    (c.pred_layers - 1) * c.pred_hidden))
        joint = (FactoredAdditiveJoint(*w) if c.joint_activation == "tanh"
                 else _ActivatedJoint(*w, self.activation, 0))
        return (partial(gru_step, self.pred),
                torch.zeros(c.pred_hidden, device=self.device), joint)

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

"""Parakeet-RNNT (NeMo's FastConformer transducer): the FastConformer
encoder, an LSTM predictor and a ReLU joint, and the transducer loss.

    x_0 = 0 (the blank's embedding);  x_u = emb[y_u]
    each LSTM layer, from h = c = 0, over u = 0 .. U:
      i, f, g, o = split(W_ih x_u + b_ih + W_hh h + b_hh)   (torch's order)
      c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c)
    g_u = the top layer's h after x_u
    logits(t, u) = ReLU(f_t W_enc + g_u W_pred + b) W_out + b_out

The loss is `transducer.nll`'s float64 lattice over the (T', U + 1)
log-softmax planes, averaged over the batch.  Weights as the port's
state-dict keys (`spec`); NeMo starts the forget gate's input bias at 1.0
(`init_forget_bias`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import fastconformer, frontend
from .transducer import nll

FORGET_BIAS = 1.0


def spec(cfg: dict):
    v, e, h = cfg["vocab_size"], cfg["pred_emb_dim"], cfg["pred_hidden"]
    j, f = cfg["joint_hidden"], cfg["enc_dim"]
    out = fastconformer.encoder_spec("encoder.", cfg, f)
    out.append(("pred.emb", (v, e), ("normal", 1.0)))
    for layer in range(cfg["pred_rnn_layers"]):
        n_in = e if layer == 0 else h
        out.append((f"pred.lstm.weight_ih_l{layer}", (4 * h, n_in),
                    ("normal", 1 / math.sqrt(n_in))))
        out.append((f"pred.lstm.weight_hh_l{layer}", (4 * h, h),
                    ("normal", 1 / math.sqrt(h))))
        out.append((f"pred.lstm.bias_ih_l{layer}", (4 * h,), ("zeros",)))
        out.append((f"pred.lstm.bias_hh_l{layer}", (4 * h,), ("zeros",)))
    out.append(("joint.w_enc", (f, j), ("normal", 1 / math.sqrt(f))))
    out.append(("joint.w_pred", (h, j), ("normal", 1 / math.sqrt(h))))
    out.append(("joint.b", (j,), ("zeros",)))
    out.append(("joint.w_out", (j, v), ("normal", 1 / math.sqrt(j))))
    out.append(("joint.b_out", (v,), ("zeros",)))
    return out


def init_forget_bias(w: dict, cfg: dict) -> dict:
    """Set each layer's input-side forget-gate bias of a drawn dict to
    FORGET_BIAS, in place (NeMo's forget_gate_bias); returns it."""
    h = cfg["pred_hidden"]
    for layer in range(cfg["pred_rnn_layers"]):
        w[f"pred.lstm.bias_ih_l{layer}"][h:2 * h] = FORGET_BIAS
    return w


def predictor(w, targets, cfg, p):
    """(N, U) ids -> (N, U + 1, H): g_0 .. g_U."""
    ids = F.pad(targets.long(), (1, 0), value=cfg["blank"])
    x = w["pred.emb"][ids] * (ids != cfg["blank"])[..., None]
    for layer in range(cfg["pred_rnn_layers"]):
        wi, wh = (w[f"pred.lstm.weight_{s}_l{layer}"] for s in ("ih", "hh"))
        b = w[f"pred.lstm.bias_ih_l{layer}"] + w[f"pred.lstm.bias_hh_l{layer}"]
        h = x.new_zeros((x.shape[0], wh.shape[1]))
        c = torch.zeros_like(h)
        outs = []
        for u in range(x.shape[1]):
            i, f, g, o = (p.mm(x[:, u], wi.T) + p.mm(h, wh.T) + b).chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, 1)
    return x


def loss_from_features(w, cfg, feats, frames, targets, target_lengths, p):
    """The training objective (batch mean, float64) from log-mel
    features (N, T, n_mels) and their frame counts."""
    enc, t_len = fastconformer.encode(w, "encoder.", feats, frames, cfg, p)
    pred = predictor(w, targets, cfg, p)
    hidden = F.relu(p.mm(enc, w["joint.w_enc"])[:, :, None]
                    + p.mm(pred, w["joint.w_pred"])[:, None] + w["joint.b"])
    lp = torch.log_softmax(p.mm(hidden, w["joint.w_out"]) + w["joint.b_out"],
                           dim=-1)
    y = F.pad(targets.long(), (0, 1))  # (N, U + 1)
    label = lp.gather(3, y[:, None, :, None].expand(-1, lp.shape[1], -1, 1))
    return nll(lp[..., cfg["blank"]].double(), label[..., 0].double(), t_len,
               target_lengths).mean()


def loss(w, cfg, wave, num_samples, targets, target_lengths, p):
    """The training objective (batch mean), float64, from waveforms."""
    feats = frontend.log_mel(wave, cfg, p)
    frames = frontend.num_frames(num_samples, cfg["n_fft"], cfg["hop_length"])
    return loss_from_features(w, cfg, feats, frames, targets, target_lengths,
                              p)

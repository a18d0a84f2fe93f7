"""The functional GRU cell of `end2end_tpu/ops/neural_lm.py`, batched (torch
port of `gru_step`, `gru_logits` and `random_gru_params`; the transducer's
predictor).  `NeuralLM`, the LM wrapper around it, is not ported yet
(ROADMAP.md queue 1, item 5).

This GRU is not `torch.nn.GRU`'s: the reset gate scales the hidden state
BEFORE the candidate's matmul, ``cand = tanh([x, r*h] @ wh + bh)``, where
torch applies it after the hidden matmul.  Parameters are a dict of
tensors in the JAX layout: emb (V, E); wz, wr, wh (E+H, H) applied to
concat([x, h]); bz, br, bh (H,); wo (H, V), bo (V,) for `gru_logits`.
"""

from __future__ import annotations

import numpy as np
import torch


def gru_step(params, h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """One step for a batch: hidden (N, H) consumes token ids (N,)."""
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

"""The FastConformer encoder (Rekesh et al., arXiv:2305.05084, as NeMo's
ConformerEncoder builds it for Parakeet) from its equations, on a flat
dict of weights.

    x = subsample(features)   Conv2d(1, C, 3, s2) + ReLU, then per further
                              halving a depthwise Conv2d(C, C, 3, s2) and a
                              pointwise Conv2d(C, C, 1) + ReLU, then a
                              Linear of (freq, channel) -> d
    x = x * sqrt(d)           (xscaling; no absolute positions)
    each block:  x += ff1(x) / 2;  x += mhsa(x);  x += conv(x);
                 x += ff2(x) / 2;  x = LayerNorm(x)
    out = Linear(x)

ff as in `conformer`.  mhsa is Transformer-XL's relative attention:

    score_ij = ((q_i + u) . k_j + (q_i + v) . p_{i-j}) / sqrt(d_k)
    p_r = W_pos sinusoid(r)  (no bias), r = i - j in T-1 .. -(T-1)

where (q_i + v) . p_r is computed for every offset and read at r = i - j
by direct indexing (a gather), not by a pad-and-reshape shift.  conv =
Linear(SiLU(BN(depthwise_conv(GLU(Linear(LN(x))) * valid)))), BN the
batch's statistics over every (n, t) of the padded batch (biased
variance, eps 1e-5), as NeMo's BatchNorm1d in training mode.

Padded frames: zeroed after each subsampling stage and after the GLU;
every score of a padded query or key is float's min, so a padded frame's
query attends evenly over all frames.  BatchNorm's statistics read
padded frames, so their values are part of the result.  The weight
names are the port's state-dict keys (`encoder_spec`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .conformer import _ff, _lin, _ln, _valid

BN_EPS = 1e-5
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _stages(cfg: dict) -> int:
    return int(math.log2(cfg["subsampling_factor"]))


def encoder_spec(prefix: str, cfg: dict, out_dim: int):
    """[(name, shape, init)] of the encoder's weights (and BatchNorm's
    buffers, names ending in `BUFFERS`) in draw order; init ('normal',
    1 / sqrt(fan in)), ('zeros',) or ('ones',)."""
    d, k, mels = cfg["d_model"], cfg["conv_kernel_size"], cfg["n_mels"]
    ch, heads = cfg["subsampling_conv_channels"], cfg["num_heads"]
    f = mels
    for _ in range(_stages(cfg)):
        f = (f + 1) // 2
    spec = []

    def lin(name, n_in, n_out, bias=True):
        spec.append((f"{name}.weight", (n_out, n_in),
                     ("normal", 1 / math.sqrt(n_in))))
        if bias:
            spec.append((f"{name}.bias", (n_out,), ("zeros",)))

    def ln(name):
        spec.append((f"{name}.weight", (d,), ("ones",)))
        spec.append((f"{name}.bias", (d,), ("zeros",)))

    s = f"{prefix}subsample."
    spec.append((s + "conv0.weight", (ch, 1, 3, 3), ("normal", 1 / 3)))
    spec.append((s + "conv0.bias", (ch,), ("zeros",)))
    for i in range(1, _stages(cfg)):
        spec.append((f"{s}dw{i}.weight", (ch, 1, 3, 3), ("normal", 1 / 3)))
        spec.append((f"{s}dw{i}.bias", (ch,), ("zeros",)))
        spec.append((f"{s}pw{i}.weight", (ch, ch, 1, 1),
                     ("normal", 1 / math.sqrt(ch))))
        spec.append((f"{s}pw{i}.bias", (ch,), ("zeros",)))
    lin(s + "dense", f * ch, d)
    e = cfg["ff_expansion_factor"] * d
    for i in range(cfg["num_layers"]):
        b = f"{prefix}blocks.{i}."
        for ff in ("ff1", "ff2"):
            ln(b + ff + ".ln")
            lin(b + ff + ".fc1", d, e)
            lin(b + ff + ".fc2", e, d)
        ln(b + "mhsa.ln")
        for m in ("query", "key", "value", "out"):
            lin(b + "mhsa." + m, d, d)
        lin(b + "mhsa.linear_pos", d, d, bias=False)
        for uv in ("u", "v"):
            spec.append((f"{b}mhsa.pos_bias_{uv}", (heads, d // heads),
                         ("zeros",)))
        ln(b + "conv.ln0")
        lin(b + "conv.pw1", d, 2 * d)
        spec.append((b + "conv.dw.weight", (d, 1, k),
                     ("normal", 1 / math.sqrt(k))))
        spec.append((b + "conv.dw.bias", (d,), ("zeros",)))
        spec.append((b + "conv.bn.weight", (d,), ("ones",)))
        spec.append((b + "conv.bn.bias", (d,), ("zeros",)))
        spec.append((b + "conv.bn.running_mean", (d,), ("zeros",)))
        spec.append((b + "conv.bn.running_var", (d,), ("ones",)))
        spec.append((b + "conv.bn.num_batches_tracked", (), ("zeros",)))
        lin(b + "conv.pw2", d, d)
        ln(b + "ln")
    lin(f"{prefix}out", d, out_dim)
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFERS)


def relative_positions(t: int, d: int, device, dtype) -> torch.Tensor:
    """(2t-1, d) sinusoids of the offsets t-1, t-2, .., -(t-1): sin on
    even features, cos on odd, wavelengths 2 pi 10000^(2i/d); float64."""
    r = torch.arange(t - 1, -t, -1, dtype=torch.float64)[:, None]
    inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(2 * t - 1, d, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(r * inv)
    pe[:, 1::2] = torch.cos(r * inv)
    return pe.to(device=device, dtype=dtype)


def out_lengths(lengths, cfg: dict):
    for _ in range(_stages(cfg)):
        lengths = (lengths + 1) // 2
    return lengths


def encode(w: dict, prefix: str, feats, lengths, cfg: dict, p):
    """(N, T, n_mels) features + (N,) frame counts -> ((N, T', out)
    outputs, (N,) lengths T' = T halved, rounding up, log2(factor)
    times)."""
    lengths = lengths.to(feats.device).long()
    x = (feats * _valid(lengths, feats.shape[1])[..., None])[:, None]
    s = prefix + "subsample."
    ch = cfg["subsampling_conv_channels"]
    for i in range(_stages(cfg)):
        if i == 0:
            x = p.conv2d(x, w[s + "conv0.weight"], w[s + "conv0.bias"],
                         stride=2, padding=1)
        else:
            x = p.conv2d(x, w[f"{s}dw{i}.weight"], w[f"{s}dw{i}.bias"],
                         stride=2, padding=1, groups=ch)
            x = p.conv2d(x, w[f"{s}pw{i}.weight"], w[f"{s}pw{i}.bias"])
        lengths = (lengths + 1) // 2
        x = F.relu(x) * _valid(lengths, x.shape[2])[:, None, :, None]
    n, c, t, f = x.shape
    x = _lin(p, x.permute(0, 2, 3, 1).reshape(n, t, f * c), w, s + "dense")
    d = x.shape[-1]
    x = x * math.sqrt(d)
    pe = relative_positions(t, d, x.device, x.dtype)
    valid = _valid(lengths, t)
    for i in range(cfg["num_layers"]):
        b = f"{prefix}blocks.{i}."
        x = x + 0.5 * _ff(p, x, w, b + "ff1")
        x = x + _mhsa(p, x, w, b + "mhsa", valid, cfg["num_heads"], pe)
        x = x + _conv(p, x, w, b + "conv", valid, cfg["conv_kernel_size"])
        x = x + 0.5 * _ff(p, x, w, b + "ff2")
        x = _ln(x, w, b + "ln")
    return _lin(p, x, w, prefix + "out"), lengths


def _mhsa(p, x, w, name, valid, heads, pe):
    n, t, d = x.shape
    dk = d // heads
    y = _ln(x, w, name + ".ln")
    q, k, v = (_lin(p, y, w, f"{name}.{m}").view(n, t, heads, dk)
               for m in ("query", "key", "value"))
    pos = p.linear(pe, w[name + ".linear_pos.weight"]).view(-1, heads, dk)
    per_offset = p.einsum("nqhc,rhc->nhqr", q + w[name + ".pos_bias_v"],
                          pos)                          # (N, H, T, 2T-1)
    i = torch.arange(t, device=x.device)
    row = (t - 1) - (i[:, None] - i[None, :])           # the row of i - j
    s = (p.einsum("nqhc,nkhc->nhqk", q + w[name + ".pos_bias_u"], k)
         + per_offset.gather(3, row.expand(n, heads, t, t))) / math.sqrt(dk)
    both = valid[:, None, None, :] & valid[:, None, :, None]
    s = s.masked_fill(~both, torch.finfo(s.dtype).min)
    a = p.einsum("nhqk,nkhc->nqhc", torch.softmax(s, dim=-1), v)
    return _lin(p, a.reshape(n, t, d), w, name + ".out")


def _conv(p, x, w, name, valid, k):
    y = F.glu(_lin(p, _ln(x, w, name + ".ln0"), w, name + ".pw1"), dim=-1)
    y = (y * valid[..., None]).transpose(1, 2)           # (N, d, T)
    y = p.conv1d(y, w[name + ".dw.weight"], w[name + ".dw.bias"],
                 padding=k // 2, groups=y.shape[1])
    mean = y.mean(dim=(0, 2), keepdim=True)
    var = (y - mean).square().mean(dim=(0, 2), keepdim=True)
    y = ((y - mean) / torch.sqrt(var + BN_EPS)
         * w[name + ".bn.weight"][:, None] + w[name + ".bn.bias"][:, None])
    return _lin(p, F.silu(y).transpose(1, 2), w, name + ".pw2")

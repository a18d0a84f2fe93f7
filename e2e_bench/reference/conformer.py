"""The Conformer encoder from its equations, on a flat dict of weights.

    x = subsample(features)            two 3x3 stride-2 convolutions + SiLU,
                                       then a Linear of (freq, channel) -> d
    x = x + sinusoidal positions
    each block:  x += ff1(x) / 2;  x += mhsa(x);  x += conv(x);
                 x += ff2(x) / 2;  x = LayerNorm(x)
    logits = Linear(x)

with ff = Linear(SiLU(Linear(LN(x)))) of width 4d, mhsa the scaled
dot-product attention of `heads` heads over the valid frames, conv =
Linear(SiLU(LN(depthwise_conv(GLU(Linear(LN(x) * valid)))))).  Every
LayerNorm has eps 1e-6.  Frames past a sequence's length are zeroed
before each convolution of the subsampler and before the convolution
module's first Linear, and are never attended to; they take any value
elsewhere.  The weight names are the port's state-dict keys, which is the
layout the benchmark draws (`encoder_spec`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest even), as float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _RoundTf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


class Precision:
    """Where the reference computes its products.  `tf32=False` is float32
    throughout (the configurations' precision, with the card's TF32 off);
    `tf32=True` is the control's TF32.  On the card the control switches
    cuBLAS's and cuDNN's TF32 on (`on_card`); elsewhere it rounds every
    operand of a product to TF32 and each of their gradients too."""

    def __init__(self, tf32: bool = False, on_card: bool = False):
        self.tf32 = tf32
        self.emulate = tf32 and not on_card

    def r(self, x):
        return _RoundTf32.apply(x) if self.emulate else x

    def mm(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))

    def conv2d(self, x, w, b, **kw):
        return F.conv2d(self.r(x), self.r(w), b, **kw)

    def conv1d(self, x, w, b, **kw):
        return F.conv1d(self.r(x), self.r(w), b, **kw)


class card_precision:
    """Context: the card's TF32 switches set for `prec` (both off for
    float32), restored on exit."""

    def __init__(self, prec: Precision):
        self.prec = prec

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = (
            self.prec.tf32 and not self.prec.emulate)
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved[0]
        torch.backends.cudnn.allow_tf32 = self.saved[1]


def encoder_spec(prefix: str, cfg: dict, out_dim: int):
    """[(name, shape, init)] of the encoder's weights in draw order; init
    is ('normal', std) with std = 1 / sqrt(fan in), ('zeros',) or
    ('ones',)."""
    d, k, mels = cfg["d_model"], cfg["conv_kernel_size"], cfg["n_mels"]
    ch = cfg["subsampling_conv_channels"]
    f2 = ((mels + 1) // 2 + 1) // 2  # frequency bins after two stride-2 convs
    spec = []

    def lin(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in),
                     ("normal", 1 / math.sqrt(n_in))))
        spec.append((f"{name}.bias", (n_out,), ("zeros",)))

    def ln(name):
        spec.append((f"{name}.weight", (d,), ("ones",)))
        spec.append((f"{name}.bias", (d,), ("zeros",)))

    spec.append((f"{prefix}subsample.conv0.weight", (ch, 1, 3, 3),
                 ("normal", 1 / 3)))
    spec.append((f"{prefix}subsample.conv0.bias", (ch,), ("zeros",)))
    spec.append((f"{prefix}subsample.conv1.weight", (ch, ch, 3, 3),
                 ("normal", 1 / math.sqrt(9 * ch))))
    spec.append((f"{prefix}subsample.conv1.bias", (ch,), ("zeros",)))
    lin(f"{prefix}subsample.dense", f2 * ch, d)
    e = cfg["ff_expansion_factor"] * d
    for i in range(cfg["num_layers"]):
        b = f"{prefix}blocks.{i}."
        for ff in ("ff1", "ff2"):
            ln(b + ff + ".ln")
            lin(b + ff + ".fc1", d, e)
            lin(b + ff + ".fc2", e, d)
        ln(b + "mhsa.ln")
        for p in ("query", "key", "value", "out"):
            lin(b + "mhsa." + p, d, d)
        ln(b + "conv.ln0")
        lin(b + "conv.pw1", d, 2 * d)
        spec.append((b + "conv.dw.weight", (d, 1, k),
                     ("normal", 1 / math.sqrt(k))))
        spec.append((b + "conv.dw.bias", (d,), ("zeros",)))
        ln(b + "conv.ln1")
        lin(b + "conv.pw2", d, d)
        ln(b + "ln")
    lin(f"{prefix}out", d, out_dim)
    return spec


def positions(t: int, d: int, device) -> torch.Tensor:
    """(t, d) sinusoids: sin on even features, cos on odd, wavelengths
    2 pi 10000^(2i/d)."""
    pos = torch.arange(t, dtype=torch.float64)[:, None]
    inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float64)
                    * (-math.log(10000.0) / d))
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = torch.sin(pos * inv).numpy()
    pe[:, 1::2] = torch.cos(pos * inv).numpy()
    return torch.from_numpy(pe).to(device)


def _valid(lengths, t):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def _ln(x, w, name):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], LN_EPS)


def _lin(p, x, w, name):
    return p.linear(x, w[name + ".weight"], w[name + ".bias"])


def encode(w: dict, prefix: str, feats, lengths, cfg: dict, p: Precision):
    """(N, T, n_mels) features + (N,) frame counts -> ((N, T', out)
    outputs, (N,) lengths T' = ceil(ceil(T / 2) / 2))."""
    lengths = lengths.to(feats.device).long()
    x = feats * _valid(lengths, feats.shape[1])[..., None]
    s = prefix + "subsample."
    x = F.silu(p.conv2d(x[:, None], w[s + "conv0.weight"],
                        w[s + "conv0.bias"], stride=2, padding=1))
    l1 = (lengths + 1) // 2
    x = x * _valid(l1, x.shape[2])[:, None, :, None]
    x = F.silu(p.conv2d(x, w[s + "conv1.weight"], w[s + "conv1.bias"],
                        stride=2, padding=1))
    l2 = (l1 + 1) // 2
    x = x * _valid(l2, x.shape[2])[:, None, :, None]
    n, c, t, f = x.shape
    x = _lin(p, x.permute(0, 2, 3, 1).reshape(n, t, f * c), w, s + "dense")
    d = x.shape[-1]
    x = x + positions(t, d, x.device)
    valid = _valid(l2, t)
    heads = cfg["num_heads"]
    k = cfg["conv_kernel_size"]
    for i in range(cfg["num_layers"]):
        b = f"{prefix}blocks.{i}."
        x = x + 0.5 * _ff(p, x, w, b + "ff1")
        x = x + _mhsa(p, x, w, b + "mhsa", valid, heads)
        x = x + _conv(p, x, w, b + "conv", valid, k)
        x = x + 0.5 * _ff(p, x, w, b + "ff2")
        x = _ln(x, w, b + "ln")
    return _lin(p, x, w, prefix + "out"), l2


def _ff(p, x, w, name):
    h = F.silu(_lin(p, _ln(x, w, name + ".ln"), w, name + ".fc1"))
    return _lin(p, h, w, name + ".fc2")


def _mhsa(p, x, w, name, valid, heads):
    n, t, d = x.shape
    y = _ln(x, w, name + ".ln")
    q, k, v = (_lin(p, y, w, f"{name}.{m}").view(n, t, heads, d // heads)
               for m in ("query", "key", "value"))
    s = p.einsum("nqhc,nkhc->nhqk", q / math.sqrt(d // heads), k)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    a = p.einsum("nhqk,nkhc->nqhc", torch.softmax(s, dim=-1), v)
    return _lin(p, a.reshape(n, t, d), w, name + ".out")


def _conv(p, x, w, name, valid, k):
    y = _ln(x, w, name + ".ln0") * valid[..., None]
    y = F.glu(_lin(p, y, w, name + ".pw1"), dim=-1)
    y = p.conv1d(y.transpose(1, 2), w[name + ".dw.weight"],
                 w[name + ".dw.bias"], padding=k // 2,
                 groups=y.shape[-1]).transpose(1, 2)
    y = F.silu(_ln(y, w, name + ".ln1"))
    return _lin(p, y, w, name + ".pw2")

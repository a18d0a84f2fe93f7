"""Conformer encoder for CTC ASR (torch port of
`end2end_tpu/models/conformer.py`).

Same math as the flax model, so converted weights (utils/convert.py) give
the same logits:
  * LayerNorm eps is 1e-6 (flax's), not torch's 1e-5;
  * attention is written out (scaled query, matmul, mask, softmax): masked
    logits are filled with float32's min, not -inf, so a padded query row
    gets uniform weights instead of NaN (NaN * 0 would survive the
    re-masking of padded frames);
  * the subsampler convolves (N, 1, T, F) with explicit padding 1 and
    flattens (f, c) with f major, as flax's NHWC layout does;
  * with subsample=False the front end is one Linear (flax's Dense) over
    the features, frame for frame: out lengths are the input lengths.
Per-sample lengths are masks: padded frames never change valid outputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.profiling import span

_LN_EPS = 1e-6


def _length_mask(lengths: torch.Tensor, t_max: int) -> torch.Tensor:
    return (torch.arange(t_max, device=lengths.device)[None, :]
            < lengths[:, None])


def _ceil2(x):
    return (x + 1) // 2


class ConvSubsampling(nn.Module):
    """Two stride-2 3x3 convs: (N, T, F) -> (N, ceil(ceil(T/2)/2), d_model).
    Activations are re-masked after each conv so the amount of padding
    never reaches valid frames."""

    def __init__(self, d_model: int, n_mels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(1, d_model, 3, stride=2, padding=1)
        self.conv1 = nn.Conv2d(d_model, d_model, 3, stride=2, padding=1)
        self.dense = nn.Linear(_ceil2(_ceil2(n_mels)) * d_model, d_model)

    def forward(self, x, lengths):
        x = F.silu(self.conv0(x[:, None]))  # (N, C, T1, F1)
        l1 = _ceil2(lengths)
        x = x * _length_mask(l1, x.shape[2])[:, None, :, None]
        x = F.silu(self.conv1(x))
        l2 = _ceil2(l1)
        x = x * _length_mask(l2, x.shape[2])[:, None, :, None]
        n, c, t, f = x.shape
        return self.dense(x.permute(0, 2, 3, 1).reshape(n, t, f * c))

    @staticmethod
    def out_length(lengths):
        return _ceil2(_ceil2(torch.as_tensor(lengths)))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, expansion: int = 4):
        super().__init__()
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.fc1 = nn.Linear(d_model, d_model * expansion)
        self.fc2 = nn.Linear(d_model * expansion, d_model)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(self.ln(x))))


class MHSA(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x, mask):
        n, t, d = x.shape
        h = self.num_heads
        y = self.ln(x)
        q = self.query(y).view(n, t, h, d // h) / math.sqrt(d // h)
        k = self.key(y).view(n, t, h, d // h)
        v = self.value(y).view(n, t, h, d // h)
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k)
        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        scores = scores.masked_fill(~attn_mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        y = torch.einsum("nhqk,nkhd->nqhd", weights, v).reshape(n, t, d)
        return self.out(y)


class ConvModule(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 15):
        super().__init__()
        self.ln0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw = nn.Conv1d(d_model, d_model, kernel_size,
                            padding=kernel_size // 2, groups=d_model)
        self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pw2 = nn.Linear(d_model, d_model)

    def forward(self, x, mask):
        y = self.ln0(x) * mask[..., None]  # keep padding out of the mix
        y = F.glu(self.pw1(y), dim=-1)
        y = self.dw(y.transpose(1, 2)).transpose(1, 2)
        return self.pw2(F.silu(self.ln1(y)))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4,
                 conv_kernel: int = 15):
        super().__init__()
        self.ff1 = FeedForward(d_model)
        self.mhsa = MHSA(d_model, num_heads)
        self.conv = ConvModule(d_model, conv_kernel)
        self.ff2 = FeedForward(d_model)
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, x, mask):
        x = x + 0.5 * self.ff1(x)
        x = x + self.mhsa(x, mask)
        x = x + self.conv(x, mask)
        x = x + 0.5 * self.ff2(x)
        return self.ln(x)


def sinusoidal_positions(t_max: int, d: int) -> np.ndarray:
    pos = np.arange(t_max)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((t_max, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


@torch.no_grad()
def init_like_flax(module: nn.Module,
                   generator: torch.Generator | None = None) -> None:
    """flax's default initialisation, drawn from `generator` (a fresh one
    seeded 0 when None) on the CPU: LeCun-normal weights, zero biases,
    unit LayerNorm scales."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(fan_in))
            m.bias.zero_()


class ConformerEncoder(nn.Module):
    """Log-mel features (N, T, F) + lengths -> CTC logits (N, T', V) and
    out lengths (N,).  vocab_size includes the blank.  The front end is
    the 4x `ConvSubsampling` (`subsample`), or with subsample=False one
    Linear from the features to d_model (`input_proj`, T' = T).

    Parameters are drawn from `generator` (a fresh one seeded 0 when None):
    LeCun-normal weights, zero biases, unit LayerNorm scales, as flax's
    defaults.  The draw happens on the CPU, so a seed gives the same
    weights on every device.  `device` defaults to CUDA and raises without
    one (utils/device.py); pass device="cpu" for the CPU.
    """

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_layers: int = 4, num_heads: int = 4,
                 conv_kernel: int = 15, n_mels: int = 80,
                 subsample: bool = True, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d_model = d_model
        with torch.device("meta"):  # allocate once, on `device`, below
            if subsample:
                self.subsample = ConvSubsampling(d_model, n_mels)
            else:
                self.subsample = None
                self.input_proj = nn.Linear(n_mels, d_model)
            self.blocks = nn.ModuleList(
                ConformerBlock(d_model, num_heads, conv_kernel)
                for _ in range(num_layers))
            self.out = nn.Linear(d_model, vocab_size)
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        init_like_flax(self, generator)

    def forward(self, feats, lengths):
        with span("encoder"):
            lengths = lengths.to(feats.device)
            feats = feats * _length_mask(lengths, feats.shape[1])[..., None]
            if self.subsample is not None:
                with span("encoder.subsample"):
                    x = self.subsample(feats, lengths)
                out_len = ConvSubsampling.out_length(lengths)
            else:
                x, out_len = self.input_proj(feats), lengths
            t_max = x.shape[1]
            pe = torch.from_numpy(sinusoidal_positions(t_max, self.d_model))
            x = x + pe.to(x.device)
            mask = _length_mask(out_len, t_max)
            with span("encoder.blocks"):
                for block in self.blocks:
                    x = block(x, mask)
            return self.out(x), out_len

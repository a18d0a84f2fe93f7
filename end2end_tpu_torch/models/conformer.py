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
Per-sample lengths are masks: padded frames never change valid outputs
(with `conv_norm="batch_norm"`, in eval mode; see `ConvModule`).

Every module after the subsampler runs once over (R, d) rows, and a row
layout says which (n, t) rows of the padded (N, T') batch those are:
`Packing`, the valid rows alone (on CUDA, wherever a frame of the batch
is padded), or `EveryRow`, all N * T' of them.  The per-frame operations
(the front end's Linear, the FeedForwards, the projections, the
convolution module's pointwise layers, the norms, the output Linear) run
on the rows; the layout lays them out padded only for the two operations
that mix frames, the attention core and the depthwise convolution (with
BatchNorm), whose padded frames hold in either layout what the padded
computation puts there, so every valid output and every gradient is the
same mathematics.

Options whose defaults are the model above, key for key (FastConformer,
Rekesh et al. 2023, as NeMo builds it, e.g. Parakeet-RNNT 1.1B):
  * `subsampling="dw_striding"`: Conv2d(1, C, 3, s2) + ReLU, then
    [depthwise Conv2d(C, C, 3, s2) + pointwise Conv2d(C, C, 1) + ReLU]
    until `subsampling_factor`, then a Linear of (freq, channel) -> d;
  * `self_attention="rel_pos"`: Transformer-XL relative positions, the
    score ((q + u) k_j + (q + v) p_{i-j}) / sqrt(d_k) with p = linear_pos
    of the sinusoids of offsets T'-1 .. -(T'-1), no absolute positions;
  * `xscaling`: the subsampler's output times sqrt(d);
  * `conv_norm="batch_norm"`: BatchNorm1d after the depthwise convolution,
    padding zeroed after the GLU (NeMo's module) where the default zeroes
    it before the first pointwise Linear.
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


def _host_sum(x: torch.Tensor):
    """A call that returns int(x.sum()).  On CUDA the copy to the host
    starts now, into pinned memory, and the call waits for it alone (one
    event), so the work queued between the two keeps the device busy."""
    if x.device.type != "cuda":
        return lambda: int(x.sum())
    host = x.to("cpu", non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def read():
        copied.synchronize()
        return int(host.sum())
    return read


class Packing:
    """The row layout of the valid (n, t) rows of a padded (N, T', ...)
    batch: `rows` are their flat indices in N * T', in order, `t` their
    frames, `mask` the (N, T') valid frames.  Built on the lengths' device
    with no host read, from the valid-row count `total` that the caller
    holds on the host.  `scatter` and `gather` move rows between the
    (R, ...) layout and the padded one; both are differentiable."""

    def __init__(self, lengths: torch.Tensor, total: int, t_max: int):
        n, dev = lengths.shape[0], lengths.device
        lengths = lengths.long()
        sample = torch.repeat_interleave(torch.arange(n, device=dev),
                                         lengths, output_size=total)
        starts = torch.cumsum(lengths, 0) - lengths
        self.t = torch.arange(total, device=dev) - starts[sample]
        self.rows = sample * t_max + self.t
        self.mask = _length_mask(lengths, t_max)
        self.shape = (n, t_max)

    def scatter(self, x: torch.Tensor, fill=None):
        """(R, ...) -> (N, T', ...): the rows not computed hold zeros; with
        `fill` (a number, or a tensor broadcast whose gradient is theirs)
        every padded frame holds it."""
        n, t = self.shape
        size = (n * t, *x.shape[1:])
        base = (fill.expand(size).clone() if torch.is_tensor(fill)
                else x.new_full(size, fill or 0))
        return base.index_copy_(0, self.rows, x).view(n, t, *x.shape[1:])

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """(N, T', ...) -> the valid rows (R, ...)."""
        return y.reshape(-1, *y.shape[2:]).index_select(0, self.rows)


class EveryRow:
    """`Packing`'s interface over all N * T' rows of a padded batch, with
    no host read: `t` the frame of each row, `mask` the (N, T') valid
    frames; `gather` a reshape, `scatter` a view, or with `fill` the padded
    frames replaced by it."""

    def __init__(self, lengths: torch.Tensor, t_max: int):
        n = lengths.shape[0]
        self.mask = _length_mask(lengths, t_max)
        self.t = torch.arange(t_max, device=lengths.device).repeat(n)
        self.shape = (n, t_max)

    def scatter(self, x: torch.Tensor, fill=None):
        y = x.view(*self.shape, *x.shape[1:])
        return y if fill is None else torch.where(self.mask[..., None], y,
                                                  fill)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape(-1, *y.shape[2:])


class ConvSubsampling(nn.Module):
    """Stride-2 3x3 convs (`forward`), then a Linear (`dense`, which the
    encoder runs on its rows): (N, T, F) -> (N, T', d_model), T' = T
    halved (rounding up) log2(factor) times.  kind "striding":
    log2(factor) full convs with SiLU (conv0, conv1, ...; channels default
    to d_model); "dw_striding": conv0 + ReLU, then depthwise `dw<i>` and
    pointwise `pw<i>` convs + ReLU.  Activations are re-masked after each
    stage so the amount of padding never reaches valid frames."""

    def __init__(self, d_model: int, n_mels: int, channels: int | None = None,
                 kind: str = "striding", factor: int = 4):
        super().__init__()
        stages = int(math.log2(factor))
        if factor != 2 ** stages or stages < 1:
            raise ValueError(f"subsampling_factor must be a power of 2, got "
                             f"{factor}")
        if kind not in ("striding", "dw_striding"):
            raise ValueError(f"unknown subsampling {kind!r}")
        c = channels or d_model
        self.kind, self.factor = kind, factor
        self.conv0 = nn.Conv2d(1, c, 3, stride=2, padding=1)
        for i in range(1, stages):
            if kind == "striding":
                self.add_module(f"conv{i}", nn.Conv2d(c, c, 3, stride=2,
                                                      padding=1))
            else:
                self.add_module(f"dw{i}", nn.Conv2d(c, c, 3, stride=2,
                                                    padding=1, groups=c))
                self.add_module(f"pw{i}", nn.Conv2d(c, c, 1))
        f = n_mels
        for _ in range(stages):
            f = _ceil2(f)
        self.dense = nn.Linear(f * c, d_model)

    def _stages(self):
        """(modules, activation) of each stage, in order."""
        if self.kind == "striding":
            return [((getattr(self, f"conv{i}"),), F.silu)
                    for i in range(int(math.log2(self.factor)))]
        return [((self.conv0,), F.relu)] + [
            ((getattr(self, f"dw{i}"), getattr(self, f"pw{i}")), F.relu)
            for i in range(1, int(math.log2(self.factor)))]

    def forward(self, x, lengths):
        """The stages without `dense`: (N, T, F) -> (N, T', f * c), (f, c)
        flattened f major."""
        x = x[:, None]  # (N, 1, T, F)
        for convs, act in self._stages():
            for conv in convs:
                x = conv(x)
            x = act(x)
            lengths = _ceil2(lengths)
            x = x * _length_mask(lengths, x.shape[2])[:, None, :, None]
        n, c, t, f = x.shape
        return x.permute(0, 2, 3, 1).reshape(n, t, f * c)

    @staticmethod
    def out_length(lengths, factor: int = 4):
        out = torch.as_tensor(lengths)
        for _ in range(int(math.log2(factor))):
            out = _ceil2(out)
        return out


class FeedForward(nn.Module):
    def __init__(self, d_model: int, expansion: int = 4):
        super().__init__()
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.fc1 = nn.Linear(d_model, d_model * expansion)
        self.fc2 = nn.Linear(d_model * expansion, d_model)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(self.ln(x))))


class MHSA(nn.Module):
    """Multi-head self-attention over the valid frames.  With `rel_pos`,
    Transformer-XL's relative score: `linear_pos` (no bias) projects the
    (2T-1, d) sinusoids of offsets T-1 .. -(T-1) (`pos`, one table a
    forward), `pos_bias_u` / `pos_bias_v` (heads, d_k) are added to the
    query, and the (q + v) p product over the 2T-1 offsets is shifted
    into place by `rel_shift`."""

    def __init__(self, d_model: int, num_heads: int = 4,
                 rel_pos: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.rel_pos = rel_pos
        if rel_pos:
            dk = d_model // num_heads
            self.linear_pos = nn.Linear(d_model, d_model, bias=False)
            self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dk))
            self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dk))

    def forward(self, x, rows, pos=None):
        """(R, d) rows of the layout `rows` -> (R, d): the projections (q,
        k and v as one product) on the rows, then q, k and v scattered in
        one copy into the padded layout for the core, whose padded keys
        are masked, and the rows of its result gathered back."""
        h = self.num_heads
        qkv = F.linear(self.ln(x), torch.cat([self.query.weight,
                                              self.key.weight,
                                              self.value.weight]),
                       torch.cat([self.query.bias, self.key.bias,
                                  self.value.bias]))
        n, t = rows.shape
        q, k, v = rows.scatter(qkv).view(n, t, 3, h, -1).unbind(2)
        return self.out(rows.gather(self.attend(q, k, v, rows.mask, pos)))

    def attend(self, q, k, v, mask, pos=None):
        """The core over (N, T, H, d_k) q, k, v and the (N, T) valid
        frames: scores, mask, softmax, weighted sum -> (N, T, H * d_k)."""
        n, t, h, dk = q.shape
        if self.rel_pos:
            scale = 1.0 / math.sqrt(dk)
            scores = (torch.einsum("nqhd,nkhd->nhqk", q + self.pos_bias_u, k)
                      + self.positional_scores(q, pos)) * scale
        else:
            scores = torch.einsum("nqhd,nkhd->nhqk", q / math.sqrt(dk), k)
        attn_mask = mask[:, None, None, :] & mask[:, None, :, None]
        scores = scores.masked_fill(~attn_mask, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        return torch.einsum("nhqk,nkhd->nqhd", weights, v).reshape(n, t,
                                                                   h * dk)

    def positional_scores(self, q, pos):
        """(N, H, T, T) (q_i + v) . p_{i-j} from q (N, T, H, d_k) and the
        (2T-1, d) sinusoids."""
        n, t, h, dk = q.shape
        p = self.linear_pos(pos).view(2 * t - 1, h, dk)
        return rel_shift(torch.einsum("nqhd,phd->nhqp",
                                      q + self.pos_bias_v, p))


def rel_shift(x):
    """(..., T, 2T-1) scores over the offsets T-1 .. -(T-1) -> (..., T, T):
    out[..., i, j] = x[..., i, T-1-i+j], the offset i-j; by padding one
    column on the left and reading the buffer back one row on, with no
    index tensor."""
    *lead, t, p = x.shape
    x = F.pad(x, (1, 0)).view(*lead, p + 1, t)
    return x[..., 1:, :].reshape(*lead, t, p)[..., :t]


def relative_positions(t: int, d: int, device, dtype) -> torch.Tensor:
    """(2t-1, d) sinusoids of the offsets t-1 .. -(t-1) (sin on even
    features, cos on odd), computed in float64 on `device`."""
    pos = torch.arange(t - 1, -t, -1, device=device,
                       dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float64)
                    * (-math.log(10000.0) / d))
    pe = torch.empty(2 * t - 1, d, device=device, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


class ConvModule(nn.Module):
    """Pointwise Linear + GLU, depthwise conv, norm + SiLU, pointwise.
    norm "layer_norm": padded frames zeroed before the first Linear;
    "batch_norm" (NeMo's): zeroed after the GLU, and a BatchNorm1d
    (momentum 0.1, eps 1e-5) whose training statistics run over every
    (n, t) of the padded batch, as NeMo's do, so a valid frame depends on
    its batch's padding in training mode; eval mode reads the running
    statistics, and padding changes no valid output."""

    def __init__(self, d_model: int, kernel_size: int = 15,
                 norm: str = "layer_norm"):
        super().__init__()
        if norm not in ("layer_norm", "batch_norm"):
            raise ValueError(f"unknown conv_norm {norm!r}")
        self.batch_norm = norm == "batch_norm"
        self.ln0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw = nn.Conv1d(d_model, d_model, kernel_size,
                            padding=kernel_size // 2, groups=d_model)
        if self.batch_norm:
            self.bn = nn.BatchNorm1d(d_model)
        else:
            self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.pw2 = nn.Linear(d_model, d_model)

    def forward(self, x, rows):
        """(R, d) rows of the layout `rows` -> (R, d): the depthwise
        convolution (and BatchNorm, whose training statistics run over
        every (n, t)) alone in the padded layout, whose padded frames hold
        zeros with batch_norm, else glu(pw1.bias), what pw1 makes of a
        zeroed row, through which pw1.bias keeps the gradient that a
        clip's last frames send it."""
        y = F.glu(self.pw1(self.ln0(x)), dim=-1)
        fill = 0 if self.batch_norm else F.glu(self.pw1.bias, dim=-1)
        y = self.dw(rows.scatter(y, fill).transpose(1, 2))
        if self.batch_norm:
            y = self.bn(y)
        y = rows.gather(y.transpose(1, 2))
        if not self.batch_norm:
            y = self.ln1(y)
        return self.pw2(F.silu(y))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int = 4,
                 conv_kernel: int = 15, self_attention: str = "abs_pos",
                 conv_norm: str = "layer_norm"):
        super().__init__()
        if self_attention not in ("abs_pos", "rel_pos"):
            raise ValueError(f"unknown self_attention {self_attention!r}")
        self.ff1 = FeedForward(d_model)
        self.mhsa = MHSA(d_model, num_heads, self_attention == "rel_pos")
        self.conv = ConvModule(d_model, conv_kernel, conv_norm)
        self.ff2 = FeedForward(d_model)
        self.ln = nn.LayerNorm(d_model, eps=_LN_EPS)

    def forward(self, x, rows, pos=None):
        """(R, d) rows of the layout `rows` -> (R, d)."""
        x = x + 0.5 * self.ff1(x)
        x = x + self.mhsa(x, rows, pos)
        x = x + self.conv(x, rows)
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
        if isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MHSA) and m.rel_pos:
            m.pos_bias_u.zero_()
            m.pos_bias_v.zero_()


class ConformerEncoder(nn.Module):
    """Log-mel features (N, T, F) + lengths -> CTC logits (N, T', V) and
    out lengths (N,).  vocab_size includes the blank.  The front end is
    the 4x `ConvSubsampling` (`subsample`), or with subsample=False one
    Linear from the features to d_model (`input_proj`, T' = T).  The
    FastConformer options (`subsampling`, `subsampling_factor`,
    `subsampling_conv_channels`, `self_attention`, `xscaling`,
    `conv_norm`) are the module docstring's; their defaults build the
    encoder above.

    Parameters are drawn from `generator` (a fresh one seeded 0 when None):
    LeCun-normal weights, zero biases, unit LayerNorm and BatchNorm
    scales, zero `pos_bias_u` / `pos_bias_v`, as flax's defaults.  The
    draw happens on the CPU, so a seed gives the same weights on every
    device.  `device` defaults to CUDA and raises without one
    (utils/device.py); pass device="cpu" for the CPU.
    """

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_layers: int = 4, num_heads: int = 4,
                 conv_kernel: int = 15, n_mels: int = 80,
                 subsample: bool = True, *, device=None,
                 generator: torch.Generator | None = None,
                 subsampling: str = "striding", subsampling_factor: int = 4,
                 subsampling_conv_channels: int | None = None,
                 self_attention: str = "abs_pos", xscaling: bool = False,
                 conv_norm: str = "layer_norm"):
        super().__init__()
        self.d_model = d_model
        self.rel_pos = self_attention == "rel_pos"
        self.xscale = math.sqrt(d_model) if xscaling else None
        with torch.device("meta"):  # allocate once, on `device`, below
            if subsample:
                self.subsample = ConvSubsampling(
                    d_model, n_mels, subsampling_conv_channels, subsampling,
                    subsampling_factor)
            else:
                self.subsample = None
                self.input_proj = nn.Linear(n_mels, d_model)
            self.blocks = nn.ModuleList(
                ConformerBlock(d_model, num_heads, conv_kernel,
                               self_attention, conv_norm)
                for _ in range(num_layers))
            self.out = nn.Linear(d_model, vocab_size)
        self.to_empty(device=resolve_device(device))
        self.reset_parameters(generator)
        # forwards packed of those seen, rows computed of the padded rows
        self.packing = {"forwards": 0, "packed": 0, "rows": 0,
                        "padded_rows": 0}

    def reset_parameters(self, generator: torch.Generator | None = None):
        init_like_flax(self, generator)

    def forward(self, feats, lengths):
        """(N, T, F) features and (N,) lengths -> logits (N, T', V), whose
        padded frames are zeros when packed, and out lengths (N,).  On
        CUDA, where a frame of the batch is padded, the encoder runs on the
        valid rows alone (`forward_packed`); elsewhere on every row."""
        return self._encode(feats, lengths, feats.is_cuda)

    def forward_packed(self, feats, lengths):
        """`forward` on the valid rows on any device, wherever a frame is
        padded."""
        return self._encode(feats, lengths, True)

    def forward_padded(self, feats, lengths):
        """`forward` on every (n, t) row of the padded batch, on any
        device."""
        return self._encode(feats, lengths, False)

    def _encode(self, feats, lengths, packable: bool):
        with span("encoder"):
            lengths = lengths.to(feats.device)
            sub = self.subsample
            out_len = (lengths if sub is None
                       else ConvSubsampling.out_length(lengths, sub.factor))
            if packable:  # the one host read, waited for after the convs
                valid = _host_sum(out_len)
            x = feats * _length_mask(lengths, feats.shape[1])[..., None]
            if sub is not None:
                with span("encoder.subsample"):
                    x = sub(x, lengths)
            n, t_max = x.shape[:2]
            with span("encoder.pack"):  # the one choice of rows
                total = valid() if packable else n * t_max
                rows = (Packing(out_len, total, t_max) if total < n * t_max
                        else EveryRow(out_len, t_max))
            self.packing["forwards"] += 1
            self.packing["packed"] += total < n * t_max
            self.packing["rows"] += total
            self.packing["padded_rows"] += n * t_max
            project = self.input_proj if sub is None else sub.dense
            x = project(rows.gather(x))
            if self.xscale is not None:
                x = x * self.xscale
            pos = None
            if self.rel_pos:
                with span("encoder.positions"):
                    pos = relative_positions(t_max, self.d_model, x.device,
                                             x.dtype)
            else:
                pe = torch.from_numpy(sinusoidal_positions(t_max,
                                                           self.d_model))
                x = x + pe.to(x.device)[rows.t]
            with span("encoder.blocks"):
                for block in self.blocks:
                    x = block(x, rows, pos)
            return rows.scatter(self.out(x)), out_len

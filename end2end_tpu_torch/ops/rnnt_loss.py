"""Public transducer (RNN-T) loss API (torch port of
`end2end_tpu/ops/rnnt_loss.py`).

    rnnt_loss(joint, targets, input_lengths, target_lengths, blank=0,
              reduction='mean', from_logits=True)

(N, T, U+1, V) joint outputs (raw logits by default, the torchaudio
convention; `from_logits=False` takes log-softmaxed values), (N, U) padded
targets; 'mean' is the plain batch mean.  U may exceed T.  Only the two
(N, T, U+1) planes, log p(blank) and log p(y_{u+1}), enter the lattice DP
(ops/rnnt_loss_plain.py); the vocabulary axis is touched once on the way in
and once by the gradient.  Three autograd functions mirror the JAX
package's three custom VJPs:
  * from log-probs: the gradient scatters -posterior into blank and label;
  * from logits: the forward keeps e = exp(x - max) and the softmax sums s,
    so the backward is one elementwise pass e * (gb + gl) / s - scatter;
  * from planes (`rnnt_nll_from_planes`): the gradient stays in plane
    space; the fused joint (`rnnt_nll_fused`) builds on it.

`implementation` takes the JAX package's names:
  * 'auto': the CUDA kernels K8/K9 (ops/rnnt_loss_cuda.py) for CUDA
    float32 inputs; the plain scans for CPU tensors and for float64;
  * 'xla': always the plain scans;
  * 'pallas': always the kernels; raises for a CPU or float64 tensor.
Nothing falls back from the kernels to the plain scans.  bfloat16/float16
inputs compute in float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from . import rnnt_loss_cuda, rnnt_loss_plain
from .rnnt_loss_plain import log_z, mask_labels, planes

_IMPLEMENTATIONS = ("auto", "xla", "pallas")
_REDUCTIONS = ("none", "sum", "mean")


def _backend(x, implementation):
    """The module whose `alpha`/`posteriors` run the DP for input `x`."""
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {_IMPLEMENTATIONS},"
                         f" got {implementation!r}")
    on_card = x.is_cuda and x.dtype == torch.float32
    if implementation == "pallas" and not on_card:
        raise ValueError(
            "implementation='pallas' runs the CUDA kernels: it needs CUDA "
            f"float32 inputs, got {x.dtype} on {x.device}")
    if implementation == "xla" or not on_card:
        return rnnt_loss_plain
    return rnnt_loss_cuda


def _float(x):
    x = torch.as_tensor(x)
    if not torch.is_floating_point(x) or x.dtype in (torch.bfloat16,
                                                     torch.float16):
        x = x.float()
    return x


def _ints(x, dev):
    return torch.as_tensor(x, device=dev).long()


def _y_ext(targets, up):
    """(N, U) targets -> (N, U+1) int64, zero-padded."""
    return torch.nn.functional.pad(targets.long(),
                                   (0, up - targets.shape[1]))


def _nll(b_pl, l_pl, il, ul, backend):
    """The DP forward: (nll (N,), residuals for `backend.posteriors`)."""
    tape, rcum = backend.alpha(b_pl, l_pl)
    z_small, z_off = log_z(b_pl, tape, rcum, il, ul)
    return -(z_small + z_off), (tape, rcum, il, ul, z_small, z_off)


class _NllFromLogProbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp, y_ext, il, ul, blank, backend):
        b_pl, l_pl = planes(lp, y_ext, ul, blank)
        nll, res = _nll(b_pl, l_pl, il, ul, backend)
        ctx.blank, ctx.backend, ctx.v = blank, backend, lp.shape[-1]
        ctx.save_for_backward(b_pl, l_pl, y_ext, *res)
        return nll

    @staticmethod
    def backward(ctx, g):
        b_pl, l_pl, y_ext, *res = ctx.saved_tensors
        gb, gl = ctx.backend.posteriors(b_pl, l_pl, *res)
        n, t_max, up = gb.shape
        grad = gb.new_zeros((n, t_max, up, ctx.v))
        idx = y_ext[:, None, :, None].expand(n, t_max, up, 1)
        grad.scatter_(3, idx, -gl[..., None])
        grad[..., ctx.blank] -= gb
        return grad * g[:, None, None, None], None, None, None, None, None


class _NllFromLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y_ext, il, ul, blank, backend):
        n, t_max, up, _ = x.shape
        m = x.amax(-1)
        e = torch.exp(x - m[..., None])
        s = e.sum(-1)
        logs = torch.log(s)
        b_pl = (x[..., blank] - m) - logs
        idx = y_ext[:, None, :, None].expand(n, t_max, up, 1)
        l_pl = mask_labels((x.gather(3, idx)[..., 0] - m) - logs, ul)
        nll, res = _nll(b_pl, l_pl, il, ul, backend)
        ctx.blank, ctx.backend = blank, backend
        ctx.save_for_backward(e, s, b_pl, l_pl, y_ext, *res)
        return nll

    @staticmethod
    def backward(ctx, g):
        e, s, b_pl, l_pl, y_ext, *res = ctx.saved_tensors
        gb, gl = ctx.backend.posteriors(b_pl, l_pl, *res)
        gb = gb * g[:, None, None]
        gl = gl * g[:, None, None]
        grad = e * ((gb + gl) / s)[..., None]
        grad[..., ctx.blank] -= gb
        n, t_max, up = gb.shape
        idx = y_ext[:, None, :, None].expand(n, t_max, up, 1)
        grad.scatter_add_(3, idx, -gl[..., None])
        return grad, None, None, None, None, None


class _NllFromPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b_pl, l_pl, il, ul, backend):
        l_pl = mask_labels(l_pl, ul)
        nll, res = _nll(b_pl, l_pl, il, ul, backend)
        ctx.backend = backend
        ctx.save_for_backward(b_pl, l_pl, *res)
        return nll

    @staticmethod
    def backward(ctx, g):
        b_pl, l_pl, *res = ctx.saved_tensors
        gb, gl = ctx.backend.posteriors(b_pl, l_pl, *res)
        gg = g[:, None, None]
        return -gb * gg, -gl * gg, None, None, None


def rnnt_nll_from_planes(blank_plane, label_plane, input_lengths,
                         target_lengths, implementation: str = "auto"):
    """Transducer NLL (N,) from (N, T, U+1) log-prob planes: log
    p(blank | t, u) and log p(y_{u+1} | t, u) (rows u >= target_lengths
    may hold anything; they are masked to log-zero).  Differentiable in
    both planes; the gradient is -posterior * g in plane space."""
    b_pl, l_pl = _float(blank_plane), _float(label_plane)
    if b_pl.ndim != 3 or l_pl.shape != b_pl.shape:
        raise ValueError("need two (N, T, U+1) planes of one shape, got "
                         f"{tuple(b_pl.shape)} and {tuple(l_pl.shape)}")
    l_pl = l_pl.to(b_pl.dtype)
    backend = _backend(b_pl, implementation)
    dev = b_pl.device
    return _NllFromPlanes.apply(b_pl, l_pl, _ints(input_lengths, dev),
                                _ints(target_lengths, dev), backend)


def rnnt_nll(log_probs_or_logits, targets, input_lengths, target_lengths,
             blank: int = 0, from_logits: bool = True,
             implementation: str = "auto"):
    """Per-sample transducer negative log-likelihood (N,), differentiable
    wrt the joint outputs.

    Args:
      log_probs_or_logits: (N, T, U+1, V) joint outputs: raw logits (the
        log-softmax is applied inside, and its gradient flows through), or
        log-probs with ``from_logits=False``.
      targets: (N, U) padded labels (no blanks).
      input_lengths, target_lengths: (N,) frames and labels per sample.
        A target may be longer than its input.
      blank: the blank id.
      implementation: 'auto' | 'xla' | 'pallas' (module docstring).
    """
    x = _float(log_probs_or_logits)
    if x.ndim != 4:
        raise ValueError(f"expected (N, T, U+1, V) joint tensor, got "
                         f"{tuple(x.shape)}")
    dev = x.device
    targets = torch.as_tensor(targets, device=dev)
    if targets.ndim != 2:
        raise ValueError("targets must be (N, U) padded")
    up = x.shape[2]
    if targets.shape[1] + 1 > up:
        raise ValueError(
            f"targets U={targets.shape[1]} needs U+1 <= {up} joint rows")
    backend = _backend(x, implementation)
    fn = _NllFromLogits if from_logits else _NllFromLogProbs
    return fn.apply(x, _y_ext(targets, up), _ints(input_lengths, dev),
                    _ints(target_lengths, dev), int(blank), backend)


def _reduce(nll, reduction):
    if reduction == "none":
        return nll
    return nll.sum() if reduction == "sum" else nll.mean()


def _check_reduction(reduction):
    if reduction not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}")


def rnnt_loss(log_probs_or_logits, targets, input_lengths, target_lengths,
              blank: int = 0, reduction: str = "mean",
              from_logits: bool = True, implementation: str = "auto"):
    """Transducer loss: `rnnt_nll` reduced by 'none', 'sum' or 'mean' (the
    plain batch mean, as torchaudio's, not CTC's per-target-length one)."""
    with span("rnnt.loss"):
        _check_reduction(reduction)
        return _reduce(rnnt_nll(log_probs_or_logits, targets, input_lengths,
                                target_lengths, blank=blank,
                                from_logits=from_logits,
                                implementation=implementation), reduction)


def fused_additive_joint(w_out, b_out, activation=torch.tanh,
                         matmul_dtype=None):
    """The standard additive joint for `rnnt_nll_fused`: ``logits =
    act(f + g) @ W_out + b_out`` over PRE-PROJECTED encoder/predictor
    vectors (project once outside: ``enc @ W_enc``, ``pred @ W_pred``).

    The returned ``joint_fn(f, g)`` broadcasts over leading axes: f (...,
    J) and g (..., J) -> (..., V).  ``matmul_dtype='bfloat16'`` rounds the
    activation and W_out to bfloat16 and multiplies them with float32
    sums (products of bfloat16 values are exact in float32); logits then
    move by O(1e-2), a training-grade path, not a parity one."""
    w_out = torch.as_tensor(w_out, dtype=torch.float32)
    b_out = torch.as_tensor(b_out, dtype=torch.float32)
    if matmul_dtype is None:
        def joint_fn(f_vec, g_vec):
            return activation(f_vec + g_vec) @ w_out + b_out
        return joint_fn

    md = (getattr(torch, matmul_dtype) if isinstance(matmul_dtype, str)
          else matmul_dtype)

    def joint_fn(f_vec, g_vec):
        h = activation(f_vec + g_vec).to(md).float()
        return h @ w_out.to(md).float() + b_out
    return joint_fn


def rnnt_nll_fused(enc_proj, pred_proj, joint_fn, targets, input_lengths,
                   target_lengths, *, blank: int = 0, chunk_t: int = 64,
                   implementation: str = "auto"):
    """Per-sample transducer NLL without the whole (N, T, U+1, V) joint:
    frames go through `joint_fn` `chunk_t` at a time, each chunk's logits
    are log-softmaxed and reduced at once to the two DP planes, under
    `torch.utils.checkpoint`, so the backward pass rebuilds one chunk of
    logits at a time.  The planes then go to `rnnt_nll_from_planes`.

    Args:
      enc_proj: (N, T, J) projected encoder frames.
      pred_proj: (N, U+1, J) projected predictor states (row u encodes
        targets[:u]).
      joint_fn: ``(f (..., J), g (..., J)) -> (..., V)`` logits,
        broadcasting over leading axes; `fused_additive_joint` builds the
        standard one.
      targets, input_lengths, target_lengths, blank: as in `rnnt_nll`.
      chunk_t: frames per logits chunk (memory/recompute knob).
    """
    enc_proj, pred_proj = _float(enc_proj), _float(pred_proj)
    if enc_proj.ndim != 3 or pred_proj.ndim != 3:
        raise ValueError("enc_proj must be (N, T, J) and pred_proj "
                         f"(N, U+1, J), got {tuple(enc_proj.shape)} / "
                         f"{tuple(pred_proj.shape)}")
    n, t_max, _ = enc_proj.shape
    up = pred_proj.shape[1]
    dev = enc_proj.device
    targets = torch.as_tensor(targets, device=dev)
    if targets.ndim != 2 or targets.shape[1] + 1 > up:
        raise ValueError(f"targets must be (N, U) with U+1 <= {up}, got "
                         f"{tuple(targets.shape)}")
    y_ext = _y_ext(targets, up)
    g_rows = pred_proj[:, None, :, :]

    def chunk_planes(enc_c):
        lp = torch.log_softmax(joint_fn(enc_c[:, :, None, :], g_rows), -1)
        idx = y_ext[:, None, :, None].expand(n, enc_c.shape[1], up, 1)
        return lp[..., blank], lp.gather(3, idx)[..., 0]

    tc = max(1, min(int(chunk_t), t_max))
    chunks = [checkpoint(chunk_planes, enc_proj[:, i:i + tc],
                         use_reentrant=False)
              for i in range(0, t_max, tc)]
    b_pl = torch.cat([c[0] for c in chunks], 1)
    l_pl = torch.cat([c[1] for c in chunks], 1)
    return rnnt_nll_from_planes(b_pl, l_pl, input_lengths, target_lengths,
                                implementation=implementation)


def rnnt_loss_fused(enc_proj, pred_proj, joint_fn, targets, input_lengths,
                    target_lengths, *, blank: int = 0, chunk_t: int = 64,
                    reduction: str = "mean", implementation: str = "auto"):
    """`rnnt_nll_fused` reduced as in `rnnt_loss`."""
    _check_reduction(reduction)
    return _reduce(rnnt_nll_fused(enc_proj, pred_proj, joint_fn, targets,
                                  input_lengths, target_lengths, blank=blank,
                                  chunk_t=chunk_t,
                                  implementation=implementation), reduction)


class RNNTLoss(nn.Module):
    """Module form of `rnnt_loss` with the options fixed at construction."""

    def __init__(self, blank: int = 0, reduction: str = "mean",
                 from_logits: bool = True, implementation: str = "auto"):
        super().__init__()
        self.blank = int(blank)
        self.reduction = reduction
        self.from_logits = bool(from_logits)
        self.implementation = implementation

    def forward(self, joint, targets, input_lengths, target_lengths):
        return rnnt_loss(joint, targets, input_lengths, target_lengths,
                         blank=self.blank, reduction=self.reduction,
                         from_logits=self.from_logits,
                         implementation=self.implementation)

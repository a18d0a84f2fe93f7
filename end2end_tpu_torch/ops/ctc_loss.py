"""Public CTC loss API (torch port of `end2end_tpu/ops/ctc_loss.py`).

    ctc_loss(log_probs, targets, input_lengths, target_lengths,
             blank=0, reduction='mean', zero_infinity=False)

torch.nn.CTCLoss semantics: (T, N, C) log-softmaxed log-probs, (N, S)
padded or 1-D concatenated targets; 'mean' divides each sample's loss by
max(target_length, 1) and averages over the batch.  One deliberate
divergence, kept from the JAX package: with zero_infinity=False an
infeasible sample scores +inf but its gradient stays finite, where torch's
is NaN.

`implementation` takes the JAX package's names:
  * 'auto': the CUDA kernels (K1/K2, ops/ctc_loss_cuda.py) for CUDA
    float32 log-probs; the plain scan (ops/ctc_loss_plain.py) for CPU
    tensors and, by dtype as the JAX package routes, for float64 on any
    device;
  * 'xla': always the plain scan;
  * 'pallas': always the kernels; raises for a CPU or float64 tensor.
Nothing falls back from the kernels to the plain scan.  bfloat16/float16
inputs compute in float32 (their gradient comes back in their dtype).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch import nn

from .ctc_loss_cuda import ctc_nll_cuda
from .ctc_loss_plain import ctc_nll_plain

_IMPLEMENTATIONS = ("auto", "xla", "pallas")


def _unpack_flat_targets(targets, target_lengths, batch):
    """1-D concatenated targets -> padded (N, max(S, 1)) int32 on the host."""
    targets = np.asarray(targets)
    lengths = np.asarray(target_lengths)
    s_max = int(lengths.max()) if lengths.size else 0
    out = np.zeros((batch, max(s_max, 1)), dtype=np.int32)
    off = 0
    for n in range(batch):
        ln = int(lengths[n])
        out[n, :ln] = targets[off: off + ln]
        off += ln
    return out


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _use_kernels(log_probs, implementation) -> bool:
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {_IMPLEMENTATIONS},"
                         f" got {implementation!r}")
    if implementation == "xla":
        return False
    if implementation == "pallas":
        if not log_probs.is_cuda or log_probs.dtype != torch.float32:
            raise ValueError(
                "implementation='pallas' runs the CUDA kernels: it needs "
                f"CUDA float32 log_probs, got {log_probs.dtype} on "
                f"{log_probs.device}")
        return True
    return log_probs.is_cuda and log_probs.dtype == torch.float32


def ctc_nll(log_probs, targets, input_lengths, target_lengths, blank=0,
            implementation="auto", checkpoint_every=0):
    """Per-sample negative log-likelihood (N,) (reduction='none', no
    zero_infinity) of (T, N, C) log-probs and padded (N, S) targets.

    checkpoint_every = K > 0 stores one alpha carry per K frames instead of
    the (T, N, L) alpha tape and recomputes each chunk in the backward pass
    (alpha memory O(T/K + K)).  Losses, state occupations and the
    gradient are bit-identical to K = 0 (on the card the gradient's combine
    kernel sums in one fixed order, so it is also bit-identical run to
    run)."""
    dev = log_probs.device
    targets = torch.as_tensor(targets, device=dev)
    input_lengths = torch.as_tensor(input_lengths, device=dev)
    target_lengths = torch.as_tensor(target_lengths, device=dev)
    if _use_kernels(log_probs, implementation):
        return ctc_nll_cuda(log_probs, targets, input_lengths,
                            target_lengths, blank, checkpoint_every)
    return ctc_nll_plain(log_probs, targets, input_lengths.long(),
                         target_lengths.long(), blank, checkpoint_every)


def ctc_loss(log_probs, targets, input_lengths, target_lengths,
             blank: int = 0, reduction: str = "mean",
             zero_infinity: bool = False, implementation: str = "auto",
             checkpoint_every: int = 0, from_logits: bool = False,
             batch_first: bool = False):
    """CTC loss with torch.nn.CTCLoss semantics (module docstring).

    `from_logits=True` applies `torch.log_softmax` over the vocabulary
    first; `batch_first=True` takes (N, T, C).  Lengths and targets may be
    tensors, numpy arrays or lists; 1-D targets are unpacked on the host."""
    if reduction not in ("none", "mean", "sum"):
        raise ValueError(f"invalid reduction {reduction!r}")
    log_probs = torch.as_tensor(log_probs)
    if log_probs.ndim != 3:
        raise ValueError(
            f"log_probs must be (T, N, C); got {tuple(log_probs.shape)}")
    if batch_first:
        log_probs = log_probs.transpose(0, 1)
    if log_probs.dtype in (torch.bfloat16, torch.float16):
        log_probs = log_probs.float()
    if from_logits:
        log_probs = torch.log_softmax(log_probs, dim=-1)
    n = log_probs.shape[1]
    t_ndim = (targets.ndim if isinstance(targets, torch.Tensor)
              else np.ndim(targets))
    if t_ndim == 1:
        targets = _unpack_flat_targets(_host(targets), _host(target_lengths),
                                       n)
    dev = log_probs.device
    target_lengths = torch.as_tensor(target_lengths, device=dev)
    nll = ctc_nll(log_probs, targets, input_lengths, target_lengths, blank,
                  implementation, checkpoint_every)
    if zero_infinity:
        nll = torch.where(torch.isinf(nll), torch.zeros_like(nll), nll)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    return (nll / torch.clamp(target_lengths, min=1).to(nll.dtype)).mean()


class CTCLoss(nn.Module):
    """Module form of `ctc_loss` with the options fixed at construction."""

    def __init__(self, blank=0, reduction="mean", zero_infinity=False,
                 implementation="auto", from_logits=False, batch_first=False):
        super().__init__()
        self.blank = blank
        self.reduction = reduction
        self.zero_infinity = zero_infinity
        self.implementation = implementation
        self.from_logits = from_logits
        self.batch_first = batch_first

    def forward(self, log_probs, targets, input_lengths, target_lengths):
        return ctc_loss(log_probs, targets, input_lengths, target_lengths,
                        blank=self.blank, reduction=self.reduction,
                        zero_infinity=self.zero_infinity,
                        implementation=self.implementation,
                        from_logits=self.from_logits,
                        batch_first=self.batch_first)


def ctc_loss_jit(blank=0, reduction="mean", zero_infinity=False,
                 implementation="auto", checkpoint_every=0,
                 from_logits=False, batch_first=False):
    """`ctc_loss` with the options baked in (the JAX package jits this
    closure; PyTorch runs eagerly, so it is a plain partial)."""
    return partial(ctc_loss, blank=blank, reduction=reduction,
                   zero_infinity=zero_infinity,
                   implementation=implementation,
                   checkpoint_every=checkpoint_every,
                   from_logits=from_logits, batch_first=batch_first)

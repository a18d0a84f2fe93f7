"""CTC loss on the card: the alpha kernel (K1) and the beta/occupation
kernel (K2) of csrc/ctc_loss.cu, bound as one autograd function.

Port of `end2end_tpu/ops/ctc_loss_pallas.py`.  `ctc_nll_cuda` takes CUDA
float32 log-probs (T, N, C) and padded (N, S) targets; its forward pass
launches K1 (alpha tape, or one checkpoint row per `checkpoint_every`
frames, and z_hat, norm_end2), its backward pass K2 (gamma, recomputing
alpha per chunk in checkpoint mode), followed by the posterior->vocab
combine in torch (`ctc_loss_plain.nll_grad`).  It never falls back to the
plain version: anything the kernels do not take raises.

`launches` counts kernel launches by name (it is the only module state).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .ctc_common import build_ctc_tables
from .ctc_loss_plain import nll_from, nll_grad

launches = {"ctc_alpha": 0, "ctc_beta": 0}

# A block may use 227 KB of shared memory on the H100.
_SMEM_LIMIT = 232448


def _smem_bytes(s_max: int, beta: bool) -> int:
    """Dynamic shared memory of K1/K2 (the sums in csrc/ctc_loss.cu)."""
    L = 2 * s_max + 1
    floats = (3 * L + 4 if beta else 2 * L + 2) + 32
    return 4 * (floats + 2 * L + 2)


def _check(log_probs, targets, every):
    if not log_probs.is_cuda:
        raise ValueError(
            f"the CUDA CTC kernels need a CUDA tensor, got {log_probs.device}")
    if log_probs.dtype != torch.float32:
        raise ValueError(
            f"the CUDA CTC kernels are float32-only, got {log_probs.dtype}")
    if log_probs.ndim != 3 or targets.ndim != 2:
        raise ValueError("need (T, N, C) log_probs and (N, S) targets, got "
                         f"{tuple(log_probs.shape)} and {tuple(targets.shape)}")
    if targets.shape[0] != log_probs.shape[1]:
        raise ValueError("targets and log_probs disagree on the batch size")
    if every < 0:
        raise ValueError(f"checkpoint_every must be >= 0, got {every}")
    if _smem_bytes(targets.shape[1], True) > _SMEM_LIMIT:
        raise ValueError(f"S={targets.shape[1]} labels: the lattice does not "
                         "fit the kernels' shared memory")


def _i32(x, dev):
    return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def alpha_cuda(log_probs, targets, input_lengths, target_lengths, blank=0,
               every=0):
    """Launch K1.  Returns (z_hat (N,), norm_end2 (N,) int32, alpha, anorm2)
    with alpha/anorm2 the tape (T, N, L)/(T, N) or, with every = K > 0,
    the chunk-start carries (ceil(T/K), N, L)/(ceil(T/K), N)."""
    _check(log_probs, targets, every)
    dev = log_probs.device
    t_max, n, v = log_probs.shape
    s_max = targets.shape[1]
    L = 2 * s_max + 1
    lp = log_probs.contiguous()
    tgt, il, tl = (_i32(x, dev) for x in (targets, input_lengths,
                                          target_lengths))
    rows = -(-t_max // every) if every else t_max
    alpha = torch.empty((rows, n, L), dtype=torch.float32, device=dev)
    anorm2 = torch.empty((rows, n), dtype=torch.int32, device=dev)
    z_hat = torch.empty(n, dtype=torch.float32, device=dev)
    norm_end2 = torch.empty(n, dtype=torch.int32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_ctc_alpha_f32(
            lp.data_ptr(), tgt.data_ptr(), il.data_ptr(), tl.data_ptr(),
            alpha.data_ptr(), anorm2.data_ptr(), z_hat.data_ptr(),
            norm_end2.data_ptr(), t_max, n, v, s_max, blank, every,
            _stream(dev))
    cuda_build.check(status, "e2e_ctc_alpha_f32")
    launches["ctc_alpha"] += 1
    return z_hat, norm_end2, alpha, anorm2


def beta_cuda(log_probs, targets, input_lengths, target_lengths, alpha,
              anorm2, z_hat, norm_end2, blank=0, every=0):
    """Launch K2 on alpha_cuda's outputs (same `every`).  Returns gamma
    (T, N, L): the state occupations, 0 on invalid states, at t >= il and
    where z is not finite."""
    _check(log_probs, targets, every)
    dev = log_probs.device
    t_max, n, v = log_probs.shape
    s_max = targets.shape[1]
    L = 2 * s_max + 1
    lp = log_probs.contiguous()
    tgt, il, tl = (_i32(x, dev) for x in (targets, input_lengths,
                                          target_lengths))
    gamma = torch.empty((t_max, n, L), dtype=torch.float32, device=dev)
    abuf = torch.empty((n, every, L), dtype=torch.float32, device=dev)
    nbuf = torch.empty((n, every), dtype=torch.int32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_ctc_beta_f32(
            lp.data_ptr(), tgt.data_ptr(), il.data_ptr(), tl.data_ptr(),
            alpha.data_ptr(), anorm2.data_ptr(), z_hat.data_ptr(),
            norm_end2.data_ptr(), gamma.data_ptr(), abuf.data_ptr(),
            nbuf.data_ptr(), t_max, n, v, s_max, blank, every, _stream(dev))
    cuda_build.check(status, "e2e_ctc_beta_f32")
    launches["ctc_beta"] += 1
    return gamma


class _CTCNllCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank, every):
        z_hat, norm_end2, alpha, anorm2 = alpha_cuda(
            log_probs, targets, input_lengths, target_lengths, blank, every)
        ctx.blank, ctx.every = blank, every
        ctx.save_for_backward(log_probs, targets, input_lengths,
                              target_lengths, alpha, anorm2, z_hat,
                              norm_end2)
        return nll_from(z_hat, norm_end2)

    @staticmethod
    def backward(ctx, g):
        (log_probs, targets, il, tl, alpha, anorm2, z_hat,
         norm_end2) = ctx.saved_tensors
        gamma = beta_cuda(log_probs, targets, il, tl, alpha, anorm2, z_hat,
                          norm_end2, ctx.blank, ctx.every)
        ext = build_ctc_tables(targets, tl, ctx.blank,
                               log_probs.shape[-1]).ext_labels
        grad = nll_grad(log_probs, gamma, ext, il, g)
        return grad, None, None, None, None, None


def ctc_nll_cuda(log_probs, targets, input_lengths, target_lengths,
                 blank: int = 0, checkpoint_every: int = 0):
    """Per-sample CTC NLL (N,) through K1/K2; differentiable wrt log_probs.
    CUDA float32 log-probs only (raises otherwise)."""
    ints = (_i32(x, log_probs.device)
            for x in (targets, input_lengths, target_lengths))
    return _CTCNllCuda.apply(log_probs, *ints, blank, int(checkpoint_every))

"""CTC forced alignment: the Viterbi (max-semiring) twin of the loss (torch
port of `end2end_tpu/ops/alignment.py`).

Given log-probs and a target sequence, find the most probable alignment
path: which frames emit which target label and which are blank.  Same
extended lattice and transition rules as the loss, with `max` in place of
`logaddexp`, plus a backtrace.

  * `align_plain`: the JAX package's two scans as two loops over T, each
    step vectorised over the batch (any device, float32 or float64); the
    choice tape is a (T, N, L) int8 tensor.
  * `align_cuda`: one launch of the kernel in `csrc/ctc_align.cu` (CUDA
    float32): the forward, the tape and the backtrace; bit-equal to
    `align_plain` on the card.  `launches` counts its launches.
  * `ctc_forced_alignment` routes: the kernel for a CUDA float32 tensor,
    `align_plain` for a CPU or float64 one.  Nothing falls back from the
    kernel: outside its plan (L = 2S + 1 > MAX_STATES) it raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from .ctc_common import build_ctc_tables, gather_lp_ext
from .semiring import LOG0, LOG0_THRESHOLD

launches = 0

MAX_THREADS = 1024
STATE_PLANS = (1, 2, 4, 8)  # extended states a thread, one kernel each
MAX_STATES = MAX_THREADS * STATE_PLANS[-1]  # L = 2S + 1 the plan holds


class ForcedAlignment(NamedTuple):
    """labels[t, n]: emitted label id per frame (blank id on blank frames,
    -1 past input_length).  positions[t, n]: index into the target sequence
    (-1 on blank/padding frames).  scores[n]: best-path log-probability
    (-inf if no alignment exists)."""

    labels: torch.Tensor
    positions: torch.Tensor
    scores: torch.Tensor


def align_plan(L: int) -> tuple[int, int]:
    """(states a thread R, threads) for L extended states: the fewest
    states a thread that L fits in 1024 threads with, and whole warps."""
    if L > MAX_STATES:
        raise ValueError(f"ctc_forced_alignment kernel: L = 2S+1 = {L} > "
                         f"{MAX_STATES} states (S <= {(MAX_STATES - 1) // 2})")
    r = next(r for r in STATE_PLANS if L <= MAX_THREADS * r)
    threads = -(-L // r)
    return r, min(MAX_THREADS, -(-threads // 32) * 32)


def _check(log_probs, targets, il, tl):
    """Shapes and lengths the alignment takes (0 <= il <= T, 0 <= tl <=
    S); reading them waits for the device once."""
    if log_probs.dim() != 3 or log_probs.shape[0] < 1:
        raise ValueError(f"log_probs must be (T >= 1, N, C), got "
                         f"{tuple(log_probs.shape)}")
    t_max, n, _ = log_probs.shape
    if targets.dim() != 2 or targets.shape[0] != n:
        raise ValueError(f"targets must be (N={n}, S) padded, got "
                         f"{tuple(targets.shape)}")
    if tuple(il.shape) != (n,) or tuple(tl.shape) != (n,):
        raise ValueError("input_lengths and target_lengths must be (N,)")
    if n == 0:
        return
    lo_hi = torch.stack([il.min(), il.max(), tl.min(), tl.max()]).tolist()
    if not (0 <= lo_hi[0] and lo_hi[1] <= t_max and 0 <= lo_hi[2]
            and lo_hi[3] <= targets.shape[1]):
        raise ValueError(f"need 0 <= input_lengths <= T = {t_max} and 0 <= "
                         f"target_lengths <= S = {targets.shape[1]}")


def align_plain(log_probs, targets, il, tl, blank: int = 0):
    """The JAX package's Viterbi forward and backtrace as loops over T.
    log_probs (T, N, C), targets (N, S), il and tl (N,) int64 on its
    device.  Returns a ForcedAlignment (labels, positions int32)."""
    t_max, n, c = log_probs.shape
    dev = log_probs.device
    tables = build_ctc_tables(targets, tl, blank, c)
    lp_ext = gather_lp_ext(log_probs, tables)  # (T, N, L)
    L = lp_ext.shape[-1]
    pos = torch.arange(L, device=dev)
    log0 = torch.tensor(LOG0, dtype=lp_ext.dtype, device=dev)
    skip2 = tables.skip2
    # the Viterbi forward: delta and each state's predecessor choice
    d = torch.where(pos == 0, lp_ext[0], log0)
    d = torch.where((pos == 1) & (tl[:, None] > 0), lp_ext[0], d)
    choices = torch.zeros((t_max, n, L), dtype=torch.int8, device=dev)
    for t in range(1, t_max):
        d1 = F.pad(d, (1, 0), value=LOG0)[:, :-1]
        d2 = torch.where(skip2, F.pad(d, (2, 0), value=LOG0)[:, :-2], log0)
        best = torch.maximum(torch.maximum(d, d1), d2)
        choice = torch.where(d2 >= best, 2, torch.where(d1 >= best, 1, 0))
        d_new = torch.clamp(best + lp_ext[t], min=LOG0)
        live = (t < il)[:, None]
        d = torch.where(live, d_new, d)
        choices[t] = torch.where(live, choice, 0)
    end1 = d.gather(1, (2 * tl)[:, None])[:, 0]
    end2 = d.gather(1, (2 * tl - 1).clamp(min=0)[:, None])[:, 0]
    end2 = torch.where(tl > 0, end2, log0)
    scores = torch.maximum(end1, end2)
    e_star = torch.where(end1 >= end2, 2 * tl, (2 * tl - 1).clamp(min=0))
    # the backtrace: the state at t is the state at t+1 minus the choice
    # that led into t+1
    states = torch.empty((t_max, n), dtype=torch.long, device=dev)
    s_next = torch.full((n,), -1, dtype=torch.long, device=dev)
    for t in range(t_max - 1, -1, -1):
        if t + 1 < t_max:
            step = choices[t + 1].gather(
                1, s_next.clamp(0, L - 1)[:, None])[:, 0].long()
        else:
            step = torch.zeros_like(s_next)
        s_next = torch.where(t == il - 1, e_star,
                             torch.where(t >= il, -1, s_next - step))
        states[t] = s_next
    valid = states >= 0
    idx = states.clamp(0, L - 1)
    labels = tables.ext_labels.gather(1, idx.T).T
    labels = torch.where(valid, labels, -1).to(torch.int32)
    positions = torch.where(valid & (idx % 2 == 1), (idx - 1) // 2,
                            -1).to(torch.int32)
    scores = torch.where(scores > LOG0_THRESHOLD, scores, float("-inf"))
    return ForcedAlignment(labels=labels, positions=positions, scores=scores)


def align_cuda(log_probs, targets, il, tl, blank: int = 0):
    """One launch of the alignment kernel (`csrc/ctc_align.cu`): CUDA
    float32 log_probs (T, N, C), targets (N, S), il and tl (N,) on its
    device; same returns as `align_plain`, bit-equal to it on the card."""
    global launches
    t_max, n, v = log_probs.shape
    dev = log_probs.device
    if not log_probs.is_cuda or log_probs.dtype != torch.float32:
        raise ValueError(f"align_cuda: log_probs must be CUDA float32, got "
                         f"{log_probs.dtype} on {dev}")
    if not 0 <= blank < v:
        raise ValueError(f"align_cuda: blank {blank} outside [0, {v})")
    s_max = targets.shape[1]
    L = 2 * s_max + 1
    r, threads = align_plan(L)
    lp = log_probs.contiguous()
    tgt = targets.to(dev, torch.int32).contiguous()
    il32 = il.to(dev, torch.int32).contiguous()
    tl32 = tl.to(dev, torch.int32).contiguous()
    tape = torch.empty((t_max, n, L), dtype=torch.int8, device=dev)
    labels = torch.empty((t_max, n), dtype=torch.int32, device=dev)
    positions = torch.empty_like(labels)
    scores = torch.empty((n,), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.e2e_ctc_align_f32(
            lp.data_ptr(), tgt.data_ptr(), il32.data_ptr(), tl32.data_ptr(),
            tape.data_ptr(), labels.data_ptr(), positions.data_ptr(),
            scores.data_ptr(), t_max, n, v, s_max, int(blank), r, threads,
            stream)
    cuda_build.check(status, "e2e_ctc_align_f32")
    launches += 1
    return ForcedAlignment(labels=labels, positions=positions, scores=scores)


def ctc_forced_alignment(log_probs, targets, input_lengths, target_lengths,
                         blank: int = 0):
    """Most-probable CTC alignment of `targets` (N, S) padded to
    `log_probs` (T, N, C): the kernel for CUDA float32 log-probs, the
    plain loops for CPU or float64 ones.  Returns a ForcedAlignment."""
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    targets = torch.as_tensor(targets, device=dev).long()
    il = torch.as_tensor(input_lengths, device=dev).long()
    tl = torch.as_tensor(target_lengths, device=dev).long()
    _check(log_probs, targets, il, tl)
    if log_probs.is_cuda and log_probs.dtype == torch.float32:
        return align_cuda(log_probs, targets, il, tl, blank)
    if log_probs.is_cuda or log_probs.device.type == "cpu":
        return align_plain(log_probs, targets, il, tl, blank)
    raise ValueError(f"ctc_forced_alignment: unsupported device {dev}")

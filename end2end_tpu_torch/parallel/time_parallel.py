"""Sequence-parallel (time-sharded) CTC loss over a `torch.distributed`
process group (torch port of `end2end_tpu/parallel/time_parallel.py`).

The alpha recurrence is linear in the log semiring (+ is logaddexp, x is
+), so the per-chunk transition operators compose associatively:

  alpha_t = M_t x alpha_{t-1},   M_t[s', s] = lp_ext[t, s'] for
                                 s in {s', s'-1, s'-2 (if allowed)}

Convention: every rank of the group passes the same global (T, N, C)
log-probs (D must divide T), reads only its frames [r T/D, (r+1) T/D),
gets the same replicated NLL, and gets the gradient in its own frames
(zero elsewhere); each rank calls `backward()` on its copy.

Forward: each rank evolves the L x L operator of its chunk (banded
updates, a loop over its frames on (N, L, L) tensors); one all-gather
collects the D operators in time order and every rank composes the whole
chain (D is small), which applied to the start state gives alpha at each
sample's last frame.  Backward: the operators are kept from the forward
pass; each rank's alpha entry state is the exclusive prefix composition
applied to the start state, its beta exit state the exclusive suffix
composition applied (transposed) to the end states; then local O(T/D L)
alpha and beta passes and the fused gradient exp(lp) - posterior of its
own frames -- no L^2 work and no further communication.

Cost grows by a factor of L over the sequential scan and composing
broadcasts to (N, L, L, L), so this pays only for extreme T with small S.
It replaces an XLA scan, not a Pallas kernel: these are plain torch
loops on the card.  Numerics: JAX's plain logsumexp, without the
sequential scans' renormalisation, so the log values grow with the
frames (|log Z| ~ 2e4 at T = 8000), and in float32 their rounding moved
the gradient by 5% of its largest entry there (an H100 run of
chip_smoke's phase 34).  The operators, the entry and exit states, the
local passes and the occupations are therefore float64 (the tensors are
(N, L, L) at most, so the loops stay launch-bound); the NLL and the
gradient come back in the input's dtype.
"""

from __future__ import annotations

import torch

from ..ops.ctc_common import build_ctc_tables, gather_lp_ext
from ..ops.semiring import LOG0, LOG0_THRESHOLD
from ..utils.collectives import all_gather_stack, group_rank


def _lse(x, dim):
    """logsumexp over `dim` with log-zero kept finite (JAX's form)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    m_safe = torch.clamp(m, min=LOG0)
    out = m_safe.squeeze(dim) + torch.log(torch.exp(x - m_safe).sum(dim))
    return torch.where(m.squeeze(dim) > LOG0_THRESHOLD, out, LOG0)


def _compose(b, a):
    """(B x A)[i, j] = logsumexp_k B[i, k] + A[k, j], batched."""
    return _lse(b[..., :, :, None] + a[..., None, :, :], -2)


def _apply_vec(m_op, v):
    """(M x v)[s'] = logsumexp_s M[s', s] + v[s], batched."""
    return _lse(m_op + v[..., None, :], -1)


def _shift(x, k, axis, fill=LOG0):
    """x shifted by k > 0 along `axis` (towards higher indices), or by
    -k towards lower ones, filled with log-zero."""
    pad = [0, 0] * (x.ndim - 1 - axis % x.ndim)
    pad += [k, 0] if k > 0 else [0, -k]
    y = torch.nn.functional.pad(x, pad, value=fill)
    n = x.shape[axis]
    return y.narrow(axis, 0, n) if k > 0 else y.narrow(axis, -k, n)


def _lae3(r0, r1, r2):
    return _lse(torch.stack([r0, r1, r2]), 0)


def _eye(n, L, like):
    eye = torch.eye(L, dtype=torch.bool, device=like.device)
    return torch.where(eye, 0.0, LOG0).to(like.dtype).expand(n, L, L)


def _chunk_operator(lp_chunk, ts, skip2, il):
    """The composite operator of a chunk: (Tc, N, L) -> (N, L, L), frozen
    past each sample's length."""
    t_c, n, L = lp_chunk.shape
    op = _eye(n, L, lp_chunk)
    no_skip = ~skip2[:, :, None]
    for i in range(t_c):
        r2 = _shift(op, 2, 1).masked_fill(no_skip, LOG0)
        new = _lae3(op, _shift(op, 1, 1), r2) + lp_chunk[i][:, :, None]
        new = torch.clamp(new, min=LOG0)
        op = torch.where((ts[i] < il)[:, None, None], new, op)
    return op


class _CTCNllTimeParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, il, tl, group, blank):
        t_max, n, c = log_probs.shape
        rank, d = group_rank(group)
        if t_max % d:
            raise ValueError(f"T={t_max} must divide over {d} ranks")
        tc = t_max // d
        t0 = rank * tc
        tables = build_ctc_tables(targets, tl, blank, c)
        lp = gather_lp_ext(log_probs[t0:t0 + tc].double(), tables)
        L = lp.shape[-1]
        ts = torch.arange(t0, t0 + tc, device=lp.device)
        op = _chunk_operator(lp, ts, tables.skip2, il)
        ops = all_gather_stack(op, group)  # the D operators, in time order
        full = _eye(n, L, lp)
        for o in ops:
            full = _compose(o, full)
        pos = torch.arange(L, device=lp.device)
        a_init = torch.where(pos == 0, 0.0, LOG0).to(lp.dtype).expand(n, L)
        alpha = _apply_vec(full, a_init)
        end1 = alpha.gather(1, (2 * tl)[:, None].long())[:, 0]
        end2 = alpha.gather(1, torch.clamp(2 * tl - 1, min=0)[:, None]
                            .long())[:, 0]
        end2 = torch.where(tl > 0, end2, LOG0)
        mx = torch.maximum(end1, end2)
        z = torch.where(mx > LOG0_THRESHOLD,
                        mx + torch.log1p(torch.exp(-(end1 - end2).abs())),
                        LOG0)
        nll = torch.where(z > LOG0_THRESHOLD, -z, float("inf"))
        ctx.rank, ctx.d, ctx.t0, ctx.blank = rank, d, t0, blank
        ctx.tables = tables
        ctx.save_for_backward(log_probs, il, tl, lp, ops, nll)
        return nll.to(log_probs.dtype)

    @staticmethod
    def backward(ctx, g):
        log_probs, il, tl, lp, ops, nll = ctx.saved_tensors
        rank, d, t0 = ctx.rank, ctx.d, ctx.t0
        tables = ctx.tables
        tc, n, L = lp.shape
        dev = lp.device
        finite = torch.isfinite(nll)
        log_z = torch.where(finite, -nll, 0.0)
        pos = torch.arange(L, device=dev)
        ends = ((pos[None] == 2 * tl[:, None])
                | ((pos[None] == 2 * tl[:, None] - 1) & (tl[:, None] > 0)))
        end_vec = torch.where(ends, 0.0, LOG0).to(lp.dtype)
        skip2 = tables.skip2
        skip2s = torch.cat([skip2[:, 2:], torch.zeros_like(skip2[:, :2])],
                           1)[:, :L]  # s -> s + 2 allowed
        eye = _eye(n, L, lp)
        prefix = eye  # M_{rank-1} x .. x M_0
        for o in ops[:rank]:
            prefix = _compose(o, prefix)
        suffix = eye  # M_{D-1} x .. x M_{rank+1}
        for o in ops[rank + 1:]:
            suffix = _compose(o, suffix)
        a_init = torch.where(pos == 0, 0.0, LOG0).to(lp.dtype).expand(n, L)
        a = _apply_vec(prefix, a_init)  # the alpha entry state
        b_exit = _apply_vec(suffix.transpose(-1, -2), end_vec)
        ts = torch.arange(t0, t0 + tc, device=dev)
        alphas = []
        for i in range(tc):
            a2 = _shift(a, 2, 1).masked_fill(~skip2, LOG0)
            anew = torch.clamp(_lae3(a, _shift(a, 1, 1), a2) + lp[i],
                               min=LOG0)
            a = torch.where((ts[i] < il)[:, None], anew, a)
            alphas.append(a)
        # beta at the chunk's last frame, then walking back; the boundary
        # overrides (t == il - 1: the end states; t >= il: log-zero) land
        # where the sequential scan puts them
        t_last = ts[-1]
        b = torch.where((t_last == il - 1)[:, None], end_vec,
                        torch.where((t_last >= il)[:, None], LOG0, b_exit))
        betas = [b]
        for i in range(tc - 2, -1, -1):
            bsum = b + lp[i + 1]
            b2 = _shift(bsum, -2, 1).masked_fill(~skip2s, LOG0)
            bnew = torch.clamp(_lae3(bsum, _shift(bsum, -1, 1), b2),
                               min=LOG0)
            b = torch.where((ts[i] == il - 1)[:, None], end_vec,
                            torch.where((ts[i] >= il)[:, None], LOG0, bnew))
            betas.append(b)
        alpha = torch.stack(alphas)
        beta = torch.stack(betas[::-1])
        gamma = torch.exp(torch.clamp(alpha + beta - log_z[None, :, None],
                                      max=0.0))  # float64
        t_mask = (ts[:, None] < il[None]) & finite[None]
        gamma = torch.where(t_mask[:, :, None], gamma, 0.0)
        rows = log_probs[t0:t0 + tc]
        post = torch.zeros_like(rows).scatter_add_(
            2, tables.ext_labels[None].expand(tc, -1, -1),
            torch.where(tables.valid[None], gamma, 0.0).to(rows.dtype))
        grad = torch.zeros_like(log_probs)
        grad[t0:t0 + tc] = ((torch.exp(rows) - post) * t_mask[:, :, None]
                            * g.to(rows.dtype)[None, :, None])
        return grad, None, None, None, None, None


def ctc_nll_time_parallel(log_probs, targets, input_lengths, target_lengths,
                          group=None, blank: int = 0):
    """Per-sample CTC NLL (N,) with the time axis sharded over `group`
    (module docstring): log_probs (T, N, C), the same on every rank, D
    dividing T; padded (N, S) targets.  Differentiable wrt log_probs: each
    rank's gradient holds its own frames."""
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    targets, input_lengths, target_lengths = (
        torch.as_tensor(x, device=dev).long()
        for x in (targets, input_lengths, target_lengths))
    return _CTCNllTimeParallel.apply(log_probs, targets, input_lengths,
                                     target_lengths, group, int(blank))

"""CTC negative log-likelihood and its gradient as plain torch scans (port of
`end2end_tpu/ops/ctc_loss_xla.py`).

The plain version of the CUDA kernels in csrc/ctc_loss.cu: a Python loop
over T of batched (N, L) row operations, in float32 or float64 (float64 is
the port's own oracle on the card).  A CPU tensor runs it; the tests and
chip_smoke.py's checks call it beside the kernels.

Numerical design (the JAX package's, kept as algorithm):
  * finite log-zero (semiring.py): no ``-inf`` or NaN inside the scans;
  * EXACT renormalisation: each step subtracts the row max, clamped to
    +-512 and rounded half-to-even to the 0.5 grid, and adds ``2m`` to an
    int32 carry, so the running norm has no rounding error and the stored
    rows stay small;
  * one alpha step function, with the t == 0 initialisation folded in,
    serves the alpha tape (`checkpoint_every=0`) and the checkpoint mode
    (one carry per K frames, alpha recomputed chunk by chunk in the
    backward pass): the two modes are bit-identical.  A sample with
    input length 0 keeps a log-zero carry and scores +inf, as the Pallas
    kernel does.
  * gradient wrt log_probs: ``(exp(lp) - posterior) * [t < il] * g``, the
    posterior scattered from the state occupations gamma with
    `scatter_add_` (duplicate labels add up).

With `zero_infinity=False` an infeasible sample scores +inf and keeps a
finite gradient (`exp(lp) * g`), the JAX package's convention.
"""

from __future__ import annotations

import torch

from .ctc_common import build_ctc_tables, gather_lp_ext
from .semiring import LOG0, LOG0_THRESHOLD, logaddexp2, logaddexp3

NORM_CLAMP = 512.0


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., s-k] with log-zero fill."""
    return torch.nn.functional.pad(x, (k, 0), value=LOG0)[..., :-k]


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., s+k] with log-zero fill."""
    return torch.nn.functional.pad(x, (0, k), value=LOG0)[..., k:]


def _renorm(row: torch.Tensor):
    """Row max -> (m on the 0.5 grid, 2m as int32).  `torch.round` rounds
    half to even, as `jnp.round` and CUDA's `rintf` do."""
    m = torch.round(torch.clamp(row.amax(-1), -NORM_CLAMP, NORM_CLAMP)
                    * 2.0) * 0.5
    return m, (m * 2.0).to(torch.int32)


def _where0(cond, x):
    return torch.where(cond, x, torch.full_like(x, LOG0))


def alpha_step(a_hat, norm2, lp_t, t, il, skip2, init_mask):
    """One renormalised alpha update; the carry is frozen at t >= il."""
    a2 = _where0(skip2, _shift_right(a_hat, 2))
    upd = logaddexp3(a_hat, _shift_right(a_hat, 1), a2) + lp_t
    anew = torch.clamp(upd if t else _where0(init_mask, lp_t), min=LOG0)
    m, m2 = _renorm(anew)
    a_new = torch.clamp(anew - m[:, None], min=LOG0)
    live = t < il
    return (torch.where(live[:, None], a_new, a_hat),
            torch.where(live, norm2 + m2, norm2))


def _init_mask(tl, L):
    pos = torch.arange(L, device=tl.device)
    return (pos == 0) | ((pos == 1) & (tl[:, None] > 0))


def _end_mask(tl, L):
    pos = torch.arange(L, device=tl.device)
    return (pos == 2 * tl[:, None]) | ((pos == 2 * tl[:, None] - 1)
                                       & (tl[:, None] > 0))


def forward_scan(lp_ext, skip2, il, tl, every=0):
    """The alpha scan over (T, N, L) emissions.

    Returns (nll (N,), z_hat (N,), alpha, anorm2, norm_end2): with
    `every == 0` alpha is the (T, N, L) tape of renormalised rows and
    anorm2 the (T, N) int32 norms (2x); with `every = K > 0` they hold the
    carries at the start of each K-frame chunk, (ceil(T/K), N, L) and
    (ceil(T/K), N).  nll = -(z_hat + norm_end2/2), +inf where infeasible.
    """
    t_max, n, L = lp_ext.shape
    init_mask = _init_mask(tl, L)
    a = torch.full((n, L), LOG0, dtype=lp_ext.dtype, device=lp_ext.device)
    norm2 = torch.zeros(n, dtype=torch.int32, device=lp_ext.device)
    rows, norms = [], []
    for t in range(t_max):
        if every and t % every == 0:
            rows.append(a)
            norms.append(norm2)
        a, norm2 = alpha_step(a, norm2, lp_ext[t], t, il, skip2, init_mask)
        if not every:
            rows.append(a)
            norms.append(norm2)
    end1 = a.gather(1, (2 * tl)[:, None].long())[:, 0]
    end2 = a.gather(1, torch.clamp(2 * tl - 1, min=0)[:, None].long())[:, 0]
    end2 = torch.where(tl > 0, end2, torch.full_like(end2, LOG0))
    z_hat = logaddexp2(end1, end2)
    return (nll_from(z_hat, norm2), z_hat, torch.stack(rows),
            torch.stack(norms), norm2)


def nll_from(z_hat, norm_end2):
    """-(z_hat + norm_end2/2), +inf where z_hat is log-zero."""
    log_z = z_hat + norm_end2.to(z_hat.dtype) * 0.5
    return torch.where(z_hat > LOG0_THRESHOLD, -log_z,
                       torch.full_like(log_z, float("inf")))


def backward_scan(lp_ext, alpha, anorm2, norm_end2, z_hat, tables, il, tl,
                  every=0):
    """The beta~ scan (emission at t excluded), walking t downwards, and the
    state occupations gamma = exp(alpha + beta~ - log Z), (T, N, L).

    gamma is 0 on invalid states, at t >= il and where z is not finite.
    `alpha`/`anorm2` are forward_scan's tape or checkpoints (same `every`);
    in checkpoint mode each chunk's alpha rows are recomputed first with
    the forward pass's own step function.
    """
    t_max, n, L = lp_ext.shape
    skip2, valid = tables.skip2, tables.valid
    finite = z_hat > LOG0_THRESHOLD
    z = torch.where(finite, z_hat, torch.zeros_like(z_hat))
    skip2_succ = torch.nn.functional.pad(skip2, (0, 2))[:, 2:]
    init_row = _where0(_end_mask(tl, L), torch.zeros_like(lp_ext[0]))
    init_mask = _init_mask(tl, L)
    keep = valid & finite[:, None]
    b = torch.full((n, L), LOG0, dtype=lp_ext.dtype, device=lp_ext.device)
    bnorm2 = torch.zeros(n, dtype=torch.int32, device=lp_ext.device)
    lp_next = torch.full_like(b, LOG0)
    gamma = torch.empty_like(lp_ext)
    tape = not every
    every = every or t_max
    for c in reversed(range(-(-t_max // every))):
        t0, t1 = c * every, min((c + 1) * every, t_max)
        if tape:  # one chunk, rows from the tape
            a_rows, n_rows = alpha, anorm2
        else:
            a, nm = alpha[c], anorm2[c]
            a_rows, n_rows = [], []
            for t in range(t0, t1):
                a, nm = alpha_step(a, nm, lp_ext[t], t, il, skip2, init_mask)
                a_rows.append(a)
                n_rows.append(nm)
        for t in reversed(range(t0, t1)):
            bsum = b + lp_next
            b2 = _where0(skip2_succ, _shift_left(bsum, 2))
            bnew = torch.clamp(logaddexp3(bsum, _shift_left(bsum, 1), b2),
                               min=LOG0)
            m, m2 = _renorm(bnew)
            cand = torch.clamp(bnew - m[:, None], min=LOG0)
            is_init, is_pad = t == il - 1, t >= il
            b = torch.where(is_init[:, None], init_row,
                            _where0(~is_pad[:, None], cand))
            bnorm2 = torch.where(is_init | is_pad, torch.zeros_like(bnorm2),
                                 bnorm2 + m2)
            lp_next = lp_ext[t]
            i = t if tape else t - t0
            shift = (n_rows[i] + bnorm2 - norm_end2).to(lp_ext.dtype) * 0.5
            log_g = a_rows[i] + b + (shift - z)[:, None]
            g = torch.exp(torch.clamp(log_g, max=0.0))
            gamma[t] = torch.where(keep & ~is_pad[:, None], g,
                                   torch.zeros_like(g))
    return gamma


def nll_grad(log_probs, gamma, ext_labels, input_lengths, g):
    """d(sum_n g_n nll_n)/d log_probs = (exp(lp) - posterior) * [t < il] * g
    with posterior[t, n, v] = sum of gamma over the states emitting v."""
    t_max = log_probs.shape[0]
    post = torch.zeros_like(log_probs).scatter_add_(
        2, ext_labels[None].expand(t_max, -1, -1), gamma.to(log_probs.dtype))
    t_mask = (torch.arange(t_max, device=log_probs.device)[:, None]
              < input_lengths[None, :])
    return ((torch.exp(log_probs) - post) * t_mask[:, :, None]
            * g[None, :, None])


class _CTCNllPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank, every):
        tables = build_ctc_tables(targets, target_lengths, blank,
                                  log_probs.shape[-1])
        lp_ext = gather_lp_ext(log_probs, tables)
        nll, z_hat, alpha, anorm2, norm_end2 = forward_scan(
            lp_ext, tables.skip2, input_lengths, target_lengths, every)
        ctx.every = every
        ctx.tables = tables
        ctx.save_for_backward(log_probs, input_lengths, target_lengths,
                              lp_ext, alpha, anorm2, norm_end2, z_hat)
        return nll

    @staticmethod
    def backward(ctx, g):
        (log_probs, il, tl, lp_ext, alpha, anorm2, norm_end2,
         z_hat) = ctx.saved_tensors
        gamma = backward_scan(lp_ext, alpha, anorm2, norm_end2, z_hat,
                              ctx.tables, il, tl, ctx.every)
        grad = nll_grad(log_probs, gamma, ctx.tables.ext_labels, il, g)
        return grad, None, None, None, None, None


def ctc_nll_plain(log_probs, targets, input_lengths, target_lengths,
                  blank: int = 0, checkpoint_every: int = 0):
    """Per-sample CTC NLL (N,) of (T, N, C) float32/float64 log-probs with
    padded (N, S) targets; differentiable wrt log_probs.  Any device."""
    return _CTCNllPlain.apply(log_probs, targets, input_lengths,
                              target_lengths, blank, int(checkpoint_every))

"""Transducer (RNN-T) wavefront DP as plain torch scans (port of the XLA
scans in `end2end_tpu/ops/rnnt_loss.py`).

The plain version of the CUDA kernels in csrc/rnnt_loss.cu: a Python loop
over the T+U anti-diagonals d = t+u of batched (N, U+1) row operations, in
float32 or float64 on any device.  A CPU tensor runs it; the tests and
chip_smoke.py's checks call it beside the kernels.

Both backends (this module and ops/rnnt_loss_cuda.py) expose the same two
functions on the UNSKEWED (N, T, U+1) blank/label log-prob planes:
  * `alpha(b_pl, l_pl) -> (tape (D, N, U+1), rcum (D, N))`: the alpha
    wavefront, each diagonal renormalised by its max on the exact 0.5 grid
    (`round_to_half`), alpha = tape + rcum;
  * `posteriors(b_pl, l_pl, tape, rcum, il, ul, z_small, z_off)
    -> (i_blank, i_label)` (N, T, U+1): the reverse beta wavefront with
    the terminal blank injected at (il-1, ul), and the node posteriors
    exp(alpha + plane + beta(successor) - logZ), 0 at frames t >= il.
logZ stays split as (z_small, z_off): z_off is a sum of 0.5-grid offsets,
so the offsets cancel EXACTLY in the posteriors and only O(1) terms carry
rounding (~1e-6 posterior error instead of ~1e-4 at T in the hundreds).

Skewed space (the XLA scans' layout): sk[d, n, u] = plane[n, d-u, u],
log-zero where d-u is outside [0, T).  Both successors of node (t, u),
(t+1, u) and (t, u+1), lie on diagonal d+1, so each diagonal is one
elementwise step.
"""

from __future__ import annotations

import torch

from .semiring import LOG0, LOG0_THRESHOLD, logaddexp2, round_to_half


def _full(like, value):
    return torch.full_like(like, value)


def skew(x: torch.Tensor, d_total: int) -> torch.Tensor:
    """(N, T, Up) -> (D, N, Up) with out[d, n, u] = x[n, d-u, u], log-zero
    outside the lattice (one flat gather)."""
    n, t_max, up = x.shape
    dev = x.device
    t_idx = (torch.arange(d_total, device=dev)[:, None]
             - torch.arange(up, device=dev)[None, :])           # (D, Up)
    valid = (t_idx >= 0) & (t_idx < t_max)
    flat = t_idx.clamp(0, t_max - 1) * up + torch.arange(up, device=dev)
    out = x.reshape(n, t_max * up)[:, flat.reshape(-1)].reshape(n, d_total,
                                                                up)
    out = torch.where(valid[None], out, _full(out, LOG0))
    return out.transpose(0, 1).contiguous()


def unskew(sk: torch.Tensor, t_max: int) -> torch.Tensor:
    """(D, N, Up) -> (N, T, Up) with out[n, t, u] = sk[t+u, n, u]."""
    d_total, n, up = sk.shape
    dev = sk.device
    u_idx = torch.arange(up, device=dev)
    flat = (torch.arange(t_max, device=dev)[:, None] + u_idx) * up + u_idx
    x = sk.transpose(0, 1).reshape(n, d_total * up)
    return x[:, flat.reshape(-1)].reshape(n, t_max, up)


def diag_renorm(row: torch.Tensor) -> torch.Tensor:
    """A diagonal's renormalisation shift: its max on the 0.5 grid, 0 for
    an all-log-zero row."""
    m = row.amax(-1)
    return round_to_half(torch.where(m > LOG0_THRESHOLD, m, _full(m, 0.0)))


def _shift_r1(x):
    """lane u <- x[u-1], log-zero into lane 0."""
    return torch.nn.functional.pad(x, (1, 0), value=LOG0)[..., :-1]


def _shift_l1(x):
    """lane u <- x[u+1], log-zero into the last lane."""
    return torch.nn.functional.pad(x, (0, 1), value=LOG0)[..., 1:]


def planes(lp, y_ext, target_lengths, blank):
    """(N, T, Up, V) log-probs -> the blank plane and the label plane
    lp[n, t, u, y_ext[n, u]] (log-zero at u >= target_length), both
    (N, T, Up).  `y_ext` is the (N, Up) zero-padded target."""
    n, t_max, up, _ = lp.shape
    b_pl = lp[..., blank]
    idx = y_ext.long()[:, None, :, None].expand(n, t_max, up, 1)
    l_pl = lp.gather(3, idx)[..., 0]
    return b_pl, mask_labels(l_pl, target_lengths)


def mask_labels(l_pl, target_lengths):
    """Label plane rows u >= target_length -> log-zero."""
    up = l_pl.shape[2]
    u_ok = (torch.arange(up, device=l_pl.device)[None]
            < target_lengths[:, None])
    return torch.where(u_ok[:, None, :], l_pl, _full(l_pl, LOG0))


def alpha(b_pl, l_pl):
    """The alpha wavefront (module docstring).  Returns (tape, rcum)."""
    n, t_max, up = b_pl.shape
    d_total = t_max + up - 1
    sk_b, sk_l = skew(b_pl, d_total), skew(l_pl, d_total)
    a = _full(sk_b[0], LOG0)
    a[:, 0] = 0.0
    r = torch.zeros_like(sk_b[0, :, 0])
    rows, offs = [a], [r]
    for d in range(1, d_total):  # diagonal d from d-1's row and planes
        blank_in = a + sk_b[d - 1]
        lab_in = _shift_r1(a) + _shift_r1(sk_l[d - 1])
        a = logaddexp2(blank_in, lab_in)
        m = diag_renorm(a)
        a = torch.clamp(a - m[:, None], min=LOG0)
        r = r + m
        rows.append(a)
        offs.append(r)
    return torch.stack(rows), torch.stack(offs)


def log_z(b_pl, tape, rcum, il, ul):
    """logZ_n = alpha[il-1, ul] + b_pl[il-1, ul], split as (z_small, z_off)
    with z_off the terminal diagonal's 0.5-grid offset.  Each term is a
    gather of one element, 0 where its index falls outside the lattice (as
    the JAX package's one-hot masked sums give)."""
    d_total, n, up = tape.shape
    t_max = b_pl.shape[1]
    ar = torch.arange(n, device=tape.device)
    d_term = (il - 1 + ul).long()
    t_term = (il - 1).long()
    u_term = ul.long()
    d_ok = (d_term >= 0) & (d_term < d_total)
    t_ok = (t_term >= 0) & (t_term < t_max)
    u_ok = (u_term >= 0) & (u_term < up)
    dc = d_term.clamp(0, d_total - 1)
    tc = t_term.clamp(0, t_max - 1)
    uc = u_term.clamp(0, up - 1)
    zero = torch.zeros_like(rcum[0])
    z_off = torch.where(d_ok, rcum[dc, ar], zero)
    b_term = torch.where(t_ok & u_ok, b_pl[ar, tc, uc], zero)
    z_small = torch.where(d_ok & u_ok, tape[dc, ar, uc], zero) + b_term
    return z_small, z_off


def beta_tape(sk_b, sk_l, il, ul):
    """The reverse beta wavefront with the terminal blank injected at
    (il-1, ul).  Returns (tape, rcum) with row d = beta on diagonal d."""
    d_total, n, up = sk_b.shape
    d_term = (il - 1 + ul).long()
    is_u = torch.arange(up, device=sk_b.device)[None] == ul.long()[:, None]
    b = _full(sk_b[0], LOG0)
    r = torch.zeros_like(sk_b[0, :, 0])
    rows, offs = [], []
    for d in range(d_total - 1, -1, -1):  # carry: diagonal d+1
        skb, skl = sk_b[d], sk_l[d]
        bta = logaddexp2(skb + b, skl + _shift_l1(b))
        is_term = (d_term == d)[:, None] & is_u
        term = torch.where(is_term, skb - r[:, None], _full(skb, LOG0))
        bta = logaddexp2(bta, term)
        m = diag_renorm(bta)
        b = torch.clamp(bta - m[:, None], min=LOG0)
        r = r + m
        rows.append(b)
        offs.append(r)
    return torch.stack(rows[::-1]), torch.stack(offs[::-1])


def posteriors(b_pl, l_pl, tape, rcum, il, ul, z_small, z_off):
    """(i_blank, i_label) node posteriors (N, T, Up) (module docstring),
    assembled per diagonal in the JAX package's operation order: the
    0.5-grid offsets first, so they cancel exactly."""
    n, t_max, up = b_pl.shape
    d_total = tape.shape[0]
    sk_b, sk_l = skew(b_pl, d_total), skew(l_pl, d_total)
    b_tape, b_rcum = beta_tape(sk_b, sk_l, il, ul)
    b_next = torch.cat([b_tape[1:], _full(b_tape[:1], LOG0)])
    r_next = torch.cat([b_rcum[1:], torch.zeros_like(b_rcum[:1])])
    dev = tape.device
    is_term = ((torch.arange(d_total, device=dev)[:, None, None]
                == (il - 1 + ul).long()[None, :, None])
               & (torch.arange(up, device=dev)[None, None, :]
                  == ul.long()[None, :, None]))
    off = (rcum + r_next - z_off[None])[:, :, None]
    off_term = (rcum - z_off[None])[:, :, None]
    small = tape - z_small[None, :, None]
    lg_blank = (small + sk_b + torch.where(is_term, _full(b_next, 0.0),
                                           b_next)
                + torch.where(is_term, off_term, off))
    lg_label = small + sk_l + _shift_l1(b_next) + off
    zero = torch.zeros_like(tape)
    i_blank = torch.where(lg_blank > LOG0_THRESHOLD,
                          torch.exp(torch.clamp(lg_blank, max=0.0)), zero)
    i_label = torch.where(lg_label > LOG0_THRESHOLD,
                          torch.exp(torch.clamp(lg_label, max=0.0)), zero)
    t_ok = (torch.arange(t_max, device=dev)[None] < il[:, None])[:, :, None]
    gb = unskew(i_blank, t_max)
    gl = unskew(i_label, t_max)
    return (torch.where(t_ok, gb, torch.zeros_like(gb)),
            torch.where(t_ok, gl, torch.zeros_like(gl)))

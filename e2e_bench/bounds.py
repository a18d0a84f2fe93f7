"""The least time the card could take for a kernel's work, and its peaks.

Frozen copies of `chip_smoke.py`'s `bound`, `ctc_bound`, `ctc_grad_bound`,
`rnnt_bound`, `topk_bound`, `beam_bound` and `backtrace_bound`, counted
from shapes and lengths rather than tensors.  A bound is the largest of
the bytes over the HBM rate, the float32 operations over the float32 rate
and the exponentials over the SFU rate, in milliseconds.
"""

from __future__ import annotations

# NVIDIA H100 SXM 80GB, published dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_DENSE_OPS_PER_S = 989e12   # the card's largest dense rate: mfu's base
N_SMS, EXP_PER_SM_CLOCK, MAX_SM_HZ = 132, 16, 1.98e9
EXP_PER_S = N_SMS * EXP_PER_SM_CLOCK * MAX_SM_HZ


def bound(nbytes: float, nops: float = 0.0, exps: float = 0.0) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S,
                     exps / EXP_PER_S)


def ctc_bound(t_max, n, s_pad, il, tl, beta: bool) -> float:
    """K1 (beta False) or K2: the log-probs its lattice needs (il (tl + 1)
    per sample), the targets, the alpha tape and loss terms (K2: and
    gamma); ~10 operations a lattice cell (K2: 12).  il, tl: lists."""
    cells = sum(i * (2 * s + 1) for i, s in zip(il, tl))
    lp_bytes = sum(i * (s + 1) for i, s in zip(il, tl)) * 4
    tape = t_max * n * (2 * s_pad + 1) * 4 + t_max * n * 4
    nbytes = lp_bytes + n * s_pad * 4 + tape + n * 8
    if beta:
        nbytes += t_max * n * (2 * s_pad + 1) * 4
    return bound(nbytes, (12 if beta else 10) * cells)


def ctc_grad_bound(t_max, n, v, s_pad, il, tl) -> float:
    """The combine: writes the (T, N, V) gradient, reads the log-probs and
    gamma of each running frame and the targets; an exp a frame and
    column."""
    il = [min(i, t_max) for i in il]
    fr = sum(il)
    states = sum(i * (2 * min(s, s_pad) + 1) for i, s in zip(il, tl))
    nbytes = t_max * n * v * 4 + fr * v * 4 + states * 4 + n * s_pad * 4
    return bound(nbytes, fr * v, exps=fr * v)


def rnnt_bound(n, t_max, up, posteriors: bool) -> float:
    """K8 (posteriors False) reads the two (N, T, U+1) planes and writes
    the tape and offsets; K9 reads the planes, tape and offsets and writes
    both posterior planes.  ~12 operations a node (K9: 30)."""
    d = t_max + up - 1
    plane, tape = n * t_max * up * 4, d * n * up * 4 + d * n * 4
    nbytes = 2 * plane + tape + (2 * plane + n * 16 if posteriors else 0)
    return bound(nbytes, (30 if posteriors else 12) * n * t_max * up)


def topk_bound(rows, v, k) -> float:
    """Every value read once, k (value, index) pairs written a row; a
    compare a value."""
    return bound(rows * v * 4 + rows * k * 8, rows * v)


def beam_bound(t_max, n, ks, il, W, K) -> float:
    """The beam step (no LM): each running frame reads its ks candidates
    and blank, every frame writes W codes, the state written once;
    operations a running frame: the repeat search, W K extensions, the
    W W merge search, W argmax rounds over W K + W candidates."""
    fr = sum(min(i, t_max) for i in il)
    nbytes = fr * (ks * 8 + 4) + n * 4 + t_max * W * n * 4 + 11 * W * n * 4
    return bound(nbytes, fr * (W * ks + W * K + W * W + W * (W * K + W)))


def backtrace_bound(t_max, W, n, s_cap, emitted) -> float:
    """The codes and scores read once, each emission's id read once, the
    token and time rows, lengths and scores written once.  `emitted`: the
    tokens on the paths counted (the best beams', a floor of all W)."""
    nbytes = (t_max * W * n * 4 + W * n * 4 + emitted * 4
              + 2 * n * W * s_cap * 4 + 2 * W * n * 4)
    return bound(nbytes)

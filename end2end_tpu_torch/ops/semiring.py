"""Log-semiring primitives shared by the CTC loss and decoders (torch port
of `end2end_tpu/ops/semiring.py`).

Masked states carry a large *finite* log-zero instead of ``-inf``, so that
``LOG0 - LOG0`` stays finite inside masked lanes (``-inf - -inf`` is NaN).
Any value at or below ``LOG0_THRESHOLD`` is treated as impossible.  The CUDA
kernels (csrc/beam_step.cu, csrc/ctc_loss.cu, csrc/rnnt_loss.cu) use the
same two constants.
"""

from __future__ import annotations

import torch

LOG0 = -1.0e30
LOG0_THRESHOLD = -1.0e29


def logaddexp2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``log(exp(a) + exp(b))`` in the finite log-zero convention.

    Both log-zero in -> exactly ``LOG0`` out; never ``-inf`` or NaN for
    finite or log-zero inputs.  ``-|a - b|`` is floored at ``LOG0`` (as the
    beam kernel does) so ``exp`` never sees ``-inf - -inf``.
    """
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=LOG0)
    d = torch.clamp(-(a - b).abs(), min=LOG0)
    out = m_safe + torch.log1p(torch.exp(d))
    return torch.where(m > LOG0_THRESHOLD, out, torch.full_like(out, LOG0))


def round_to_half(x: torch.Tensor) -> torch.Tensor:
    """The nearest multiple of 0.5, ties to even (`torch.round`, like
    `jnp.round` and CUDA's `rintf`; C's `roundf` rounds ties away from
    zero and would not do)."""
    return torch.round(x * 2.0) * 0.5


def logaddexp3(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """``log(exp(a) + exp(b) + exp(c))``, the inner operation of the CTC
    alpha and beta recurrences, in the finite log-zero convention.

    The form of the JAX package's `fastmath.logaddexp3_acc`: the max term's
    ``exp(0)`` is exactly 1, so ``u = sum - 1`` is the exact residual of the
    two other terms and ``log1p(u)`` loses nothing near the max (ties
    included).  libm ``exp``/``log1p`` stand in for the float32 polynomials;
    the same expression runs in float64.  csrc/ctc_loss.cu evaluates it in
    the same order.
    """
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=LOG0)
    u = (torch.exp(a - m_safe) + torch.exp(b - m_safe)
         + torch.exp(c - m_safe)) - 1.0
    out = m_safe + torch.log1p(torch.clamp(u, min=0.0))
    return torch.where(m > LOG0_THRESHOLD, out, torch.full_like(out, LOG0))

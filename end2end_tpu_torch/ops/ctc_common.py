"""Lattice tables for the CTC forward-backward recurrences (torch port of
`end2end_tpu/ops/ctc_common.py`).

The extended label sequence l' = [b, l1, b, l2, ..., lS, b] (L = 2S+1
states) and its transition masks are the same for every implementation:
the plain scans (ops/ctc_loss_plain.py) build them here, and the CUDA
kernels (csrc/ctc_loss.cu) derive the same values from the padded targets
in shared memory.  Everything is built at the padded S_max and masked with
the per-sample lengths.

Not ported: `state_onehot` and `_lp_ext_compact`, the JAX package's one-hot
matrix-unit forms of the emission gather.  Their docstrings say they are
bit-identical to the gather; tests/test_torch_ctc_loss.py shows the port's
gather equals the JAX one-hot form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .semiring import LOG0


class CTCTables(NamedTuple):
    """Per-batch lattice tables, each (N, L) with L = 2*S_max + 1.

    ext_labels: int64 vocabulary id emitted at each state (blank at even s;
      labels clipped to [0, C-1], as the JAX package clips them).
    skip2: True where the s-2 "skip" transition INTO state s is allowed
      (s odd, s >= 3, and the two labels differ: the repeated-label rule).
    valid: True for states s < 2*target_length + 1.
    """

    ext_labels: torch.Tensor
    skip2: torch.Tensor
    valid: torch.Tensor


def build_ctc_tables(targets: torch.Tensor, target_lengths: torch.Tensor,
                     blank: int, num_classes: int) -> CTCTables:
    """Tables from padded (N, S) targets, on the targets' device."""
    if targets.ndim != 2:
        raise ValueError(
            f"targets must be (N, S) padded; got shape {tuple(targets.shape)}")
    n, s_max = targets.shape
    dev = targets.device
    L = 2 * s_max + 1
    pos = torch.arange(L, device=dev)
    if s_max == 0:
        ext = torch.full((n, 1), blank, dtype=torch.int64, device=dev)
        skip2 = torch.zeros((n, 1), dtype=torch.bool, device=dev)
    else:
        is_odd = (pos % 2) == 1
        lab_idx = torch.clamp((pos - 1) // 2, 0, s_max - 1)
        tgt = torch.clamp(targets.to(torch.int64), 0, num_classes - 1)
        tgt_at = tgt[:, lab_idx]
        prev_at = tgt[:, torch.clamp(lab_idx - 1, min=0)]
        ext = torch.where(is_odd, tgt_at, blank)
        skip2 = is_odd & (pos >= 3) & (tgt_at != prev_at)
    valid = pos < (2 * target_lengths.to(device=dev)[:, None] + 1)
    return CTCTables(ext_labels=ext, skip2=skip2, valid=valid)


def gather_lp_ext(log_probs: torch.Tensor, tables: CTCTables) -> torch.Tensor:
    """Per-state emission log-probs: (T, N, C) -> (T, N, L).

    Invalid states read log-zero, so they never feed valid states in either
    direction and cannot move the renormalisation max.  ``-inf`` entries are
    floored at log-zero (the same values come out of the scans either way:
    any log-prob plus ``-inf`` or plus log-zero is floored to log-zero).
    """
    t_max = log_probs.shape[0]
    idx = tables.ext_labels[None].expand(t_max, -1, -1)
    lp_ext = torch.clamp(torch.gather(log_probs, 2, idx), min=LOG0)
    return torch.where(tables.valid[None], lp_ext,
                       torch.full_like(lp_ext, LOG0))

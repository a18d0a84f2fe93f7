"""Length bucketing (copy of `end2end_tpu/utils/bucketing.py`; the port
keeps its own, since importing the JAX package would import JAX).

Per-sample lengths are data (masks), not shapes.  This module pads a
host-side batch up to bucket-ladder edges, so a batch's frame count takes
one of a few values; `ops.decode_utils.collapse_and_bucket` cuts a
blank-collapsed batch down to the edge above its longest sample, so the
decoders' frame loops run fewer steps.

Host-side (NumPy): data preparation before anything reaches the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


def geometric_edges(lo: int, hi: int, ratio: float = 1.3) -> tuple[int, ...]:
    """A geometric bucket ladder from lo to hi (inclusive), 8-aligned."""
    edges = []
    x = float(lo)
    while x < hi:
        e = int(np.ceil(x / 8.0) * 8)
        if not edges or e > edges[-1]:
            edges.append(e)
        x *= ratio
    if not edges or edges[-1] < hi:
        edges.append(int(np.ceil(hi / 8.0) * 8))
    return tuple(edges)


DEFAULT_T_EDGES = geometric_edges(32, 4096)
DEFAULT_S_EDGES = geometric_edges(8, 1024)


def bucket_size(n: int, edges: Sequence[int]) -> int:
    """Smallest edge >= n; past the ladder, n rounded up to a multiple of 8.

    The 8-aligned passthrough (rather than clamping to the last edge) keeps
    oversized inputs correct at the cost of one fresh compile per distinct
    oversize; extend the ladder if that happens often.
    """
    for e in edges:
        if n <= e:
            return e
    return int(np.ceil(n / 8.0) * 8)


@dataclass(frozen=True)
class BucketSpec:
    """Static bucket ladders (frozen, hashable)."""

    t_edges: tuple[int, ...] = field(default=DEFAULT_T_EDGES)
    s_edges: tuple[int, ...] = field(default=DEFAULT_S_EDGES)


def bucket_pad(
    log_probs: np.ndarray,
    targets: np.ndarray,
    input_lengths: np.ndarray,
    target_lengths: np.ndarray,
    spec: BucketSpec = BucketSpec(),
    lp_pad: float = 0.0,
    label_pad: int = 0,
):
    """Pad a (T, N, C) batch and (N, S) targets up to bucket edges.

    Accepts arrays already padded to the batch max; re-pads to the bucket
    edge above max(input_lengths) / max(target_lengths).  Returns
    (log_probs, targets, input_lengths, target_lengths) with bucketed T/S.
    Padded frames/labels are inert: every kernel masks by the length vectors.
    """
    log_probs = np.asarray(log_probs)
    targets = np.asarray(targets)
    input_lengths = np.asarray(input_lengths, np.int32)
    target_lengths = np.asarray(target_lengths, np.int32)
    t_now, n, c = log_probs.shape
    t_need = bucket_size(int(input_lengths.max()), spec.t_edges)
    s_need = bucket_size(max(int(target_lengths.max()), 1), spec.s_edges)

    if t_need != t_now:
        if t_need > t_now:
            pad = np.full((t_need - t_now, n, c), lp_pad, log_probs.dtype)
            log_probs = np.concatenate([log_probs, pad], axis=0)
        else:
            log_probs = log_probs[:t_need]
    s_now = targets.shape[1] if targets.ndim == 2 else 0
    if targets.ndim != 2:
        raise ValueError("bucket_pad expects padded (N, S) targets")
    if s_need != s_now:
        if s_need > s_now:
            pad = np.full((n, s_need - s_now), label_pad, targets.dtype)
            targets = np.concatenate([targets, pad], axis=1)
        else:
            targets = targets[:, :s_need]
    return log_probs, targets, input_lengths, target_lengths

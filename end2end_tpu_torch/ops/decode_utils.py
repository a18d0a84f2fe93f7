"""Decode-side lattice preprocessing (torch port of
`end2end_tpu/ops/decode_utils.py`).

Blank collapse (Blank Collapse: Compressing CTC emission for the faster
decoding, arXiv:2210.17017): frames whose blank probability exceeds a
threshold contribute (almost) only a common blank factor to every
hypothesis, so runs of them can be cut down to their first frame before
beam search.  On trained, peaked CTC models this removes 50-90% of frames,
and beam-search cost is linear in T.  Scores shift by the dropped common
blank mass; exact greedy/loss paths do not use this.

`blank_collapse` keeps the shape (kept frames front-packed into the
same-T buffer, new lengths as data); `collapse_and_bucket` also cuts the
batch down to the bucket edge above its longest collapsed sample, so the
decoders' frame loops run fewer steps.
"""

from __future__ import annotations

import math

import torch

from ..utils.bucketing import DEFAULT_T_EDGES, bucket_size


def blank_collapse(log_probs, input_lengths=None, blank: int = 0,
                   threshold: float = 0.98):
    """Front-pack the frames that are not inside a run of confident blanks.

    Args: log_probs (T, N, C); input_lengths (N,).
    Returns (packed_log_probs (T, N, C), new_lengths (N,) int32), on
    log_probs' device: the kept frames of each sample moved to the front
    in their order; the tail frames are zeros (never read by length-masked
    decoders).
    """
    log_probs = torch.as_tensor(log_probs)
    t_max, n, _ = log_probs.shape
    dev = log_probs.device
    if input_lengths is None:
        il = torch.full((n,), t_max, dtype=torch.long, device=dev)
    else:
        il = torch.as_tensor(input_lengths, device=dev).long()
    # the threshold rounded to float32, as the JAX package's
    log_thresh = float(torch.tensor(math.log(threshold), dtype=torch.float32))
    t_mask = torch.arange(t_max, device=dev)[:, None] < il[None, :]
    # collapse RUNS of confident blanks to their first frame (removing them
    # all would delete the separator between repeated tokens and merge
    # "6 _ 6" into "6"; the paper keeps one blank per run)
    is_cb = (log_probs[:, :, blank] >= log_thresh) & t_mask
    prev_cb = torch.cat([torch.zeros((1, n), dtype=torch.bool, device=dev),
                         is_cb[:-1]], dim=0)
    keep = ~(is_cb & prev_cb) & t_mask  # (T, N)
    pos = torch.cumsum(keep.long(), dim=0) - 1
    # dropped frames land on a spare frame t_max, sliced off (JAX's
    # out-of-bounds scatter with mode="drop")
    slot = torch.where(keep, pos, t_max)
    packed = log_probs.new_zeros((t_max + 1,) + tuple(log_probs.shape[1:]))
    cols = torch.arange(n, device=dev)[None, :].expand(t_max, n)
    packed.index_put_((slot, cols), log_probs)
    return packed[:t_max], keep.sum(dim=0).to(torch.int32)


def collapse_and_bucket(log_probs, input_lengths=None, blank: int = 0,
                        threshold: float = 0.98, t_edges=DEFAULT_T_EDGES):
    """Blank-collapse, then cut T down to a bucket edge.

    Returns (packed (T', N, C), new_lengths (N,) int32) on log_probs'
    device, with T' = bucket_size(max(new_lengths)) <= T (the JAX package
    returns numpy arrays, which its compiled decoders take; the port's
    decoders take the tensors where they are).  Reading the longest new
    length waits for the device once.
    """
    packed, new_lengths = blank_collapse(log_probs, input_lengths, blank,
                                         threshold)
    t_new = bucket_size(max(int(new_lengths.max()), 1), t_edges)
    t_new = min(t_new, packed.shape[0])
    return packed[:t_new], new_lengths

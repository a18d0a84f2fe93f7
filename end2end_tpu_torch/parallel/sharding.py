"""Data parallelism for the CTC and transducer stacks over a
`torch.distributed` process group (torch port of
`end2end_tpu/parallel/sharding.py`).

Losses and decoders are per sample, so splitting the batch is exact: each
of the group's D ranks runs the single-device entry point on its rows
(the CTC loss as K1, K2 and the combine on the card, the transducer loss
as K8 and K9, the ALSD beam with K3) and the only communication is the
'mean' and 'sum' reductions of the losses, one SUM all-reduce each.

Convention: **data parallel passes each rank its own rows** -- what JAX's
batch-sharded arrays hold on each device, and what a data-parallel loader
gives a rank.  `shard_batch` cuts a whole batch into this rank's rows
(D must divide N, or it raises, as `_check_batch` does in JAX).  A
reduced loss is the whole batch's, replicated on every rank: each rank
calls `backward()` on its copy, its cotangent is already the full one,
so the all-reduce's backward is the identity (`utils/collectives.
reduce_from_group`) and each rank's gradient is the whole batch's
gradient on its rows.  The decoders take the rank's rows and return its
rows' results with no collective; their LM tables and weights are
replicated (each rank holds them whole).

    rank, d = group_rank(group)
    lp, tgt, il, tl = shard_batch(group, log_probs, targets, il, tl)
    loss = ctc_loss_data_parallel(lp, tgt, il, tl, group)  # whole batch's
    loss.backward()                                        # this rank's rows
    sum_gradients(model, group)                    # the whole batch's, alike

Training a replicated model: with a 'mean' or 'sum' loss each rank's
gradient is the whole loss's gradient through its rows, so
`sum_gradients` (one SUM all-reduce a flat bucket of gradients, after
`backward()`) gives every rank the whole batch's gradient, and the same
optimizer step on every rank keeps the replicas equal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.ctc_loss import ctc_nll
from ..ops.greedy import greedy_decode
from ..ops.rnnt_decode import rnnt_beam_decode, rnnt_greedy_decode
from ..ops.rnnt_loss import rnnt_nll
from ..utils.collectives import group_rank, reduce_from_group

_REDUCTIONS = ("none", "mean", "sum")


def _check_batch(n: int, d: int):
    if n % d:
        raise ValueError(f"batch {n} must divide evenly over {d} ranks")


def _rows(x, rank, d, axis):
    n = x.shape[axis]
    return x.narrow(axis, rank * (n // d), n // d)


def shard_batch(group, log_probs, targets, input_lengths, target_lengths):
    """This rank's rows of a whole CTC batch: log_probs (T, N, C) along
    axis 1, the others along axis 0.  Raises unless D divides N."""
    rank, d = group_rank(group)
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    targets, input_lengths, target_lengths = (
        torch.as_tensor(x, device=dev)
        for x in (targets, input_lengths, target_lengths))
    _check_batch(log_probs.shape[1], d)
    return (_rows(log_probs, rank, d, 1), _rows(targets, rank, d, 0),
            _rows(input_lengths, rank, d, 0),
            _rows(target_lengths, rank, d, 0))


def _reduce(nll, reduction, group, per_sample=None):
    """'none': the rank's rows; 'sum' and 'mean': the whole batch's scalar
    through one SUM all-reduce (of the sum and the row count)."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"invalid reduction {reduction!r}")
    if reduction == "none":
        return nll
    terms = nll if per_sample is None or reduction == "sum" else (
        nll / per_sample)
    count = torch.full((), nll.shape[0], dtype=nll.dtype, device=nll.device)
    total = reduce_from_group(torch.stack([terms.sum(), count]), group)
    return total[0] if reduction == "sum" else total[0] / total[1]


def ctc_loss_data_parallel(log_probs, targets, input_lengths, target_lengths,
                           group=None, blank: int = 0,
                           reduction: str = "mean",
                           zero_infinity: bool = False):
    """The CTC loss of a batch split over the group: `ctc_nll` on this
    rank's rows (log_probs (T, N/D, C), targets (N/D, S); the kernels for
    CUDA float32 log-probs).  'none' returns the rank's (N/D,) NLL;
    'mean' (each NLL over max(target length, 1), averaged over the whole
    batch) and 'sum' return the replicated scalar."""
    group_rank(group)
    log_probs = torch.as_tensor(log_probs)
    nll = ctc_nll(log_probs, targets, input_lengths, target_lengths, blank)
    if zero_infinity:
        nll = torch.where(torch.isinf(nll), torch.zeros_like(nll), nll)
    tl = torch.as_tensor(target_lengths, device=nll.device)
    return _reduce(nll, reduction, group,
                   torch.clamp(tl, min=1).to(nll.dtype))


def rnnt_loss_data_parallel(joint, targets, input_lengths, target_lengths,
                            group=None, blank: int = 0,
                            reduction: str = "mean",
                            from_logits: bool = True):
    """The transducer loss of a batch split over the group: `rnnt_nll` on
    this rank's rows of the (N/D, T, U+1, V) joint (K8 and K9 on the
    card).  'mean' is the plain batch mean of the whole batch, the
    transducer convention; 'none' returns the rank's rows."""
    group_rank(group)
    nll = rnnt_nll(joint, targets, input_lengths, target_lengths,
                   blank=blank, from_logits=from_logits)
    return _reduce(nll, reduction, group)


def sum_gradients(module, group=None, bucket_numel: int = 1 << 25):
    """Replace each gradient of `module`'s parameters by its SUM over the
    group, in place: flat buckets of up to `bucket_numel` elements of one
    dtype and device, one all-reduce each, in parameter order.  Call it
    after `backward()` on every rank alike; a parameter with no gradient
    takes zeros, so every rank reduces the same buckets."""
    group_rank(group)
    grads = []
    for p in module.parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    buckets, key = [], None
    for g in grads:
        k = (g.dtype, g.device)
        if (not buckets or k != key
                or sum(x.numel() for x in buckets[-1]) + g.numel()
                > bucket_numel):
            buckets.append([])
        buckets[-1].append(g)
        key = k
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def greedy_decode_data_parallel(log_probs, input_lengths, group=None,
                                blank: int = 0):
    """`greedy_decode` on this rank's rows (T, N/D, C): no collective."""
    group_rank(group)
    return greedy_decode(log_probs, input_lengths, blank=blank)


def rnnt_greedy_decode_data_parallel(encoder_out, input_lengths,
                                     predictor_step, init_hidden, joint_fn,
                                     group=None, **kwargs):
    """`rnnt_greedy_decode` on this rank's rows (N/D, T, E): no collective.
    The predictor and joint weights live in the callables, replicated.
    kwargs are `rnnt_greedy_decode`'s."""
    group_rank(group)
    return rnnt_greedy_decode(encoder_out, input_lengths, predictor_step,
                              init_hidden, joint_fn, **kwargs)


def rnnt_beam_decode_data_parallel(encoder_out, input_lengths,
                                   predictor_step, init_hidden, joint_fn,
                                   group=None, **kwargs):
    """`rnnt_beam_decode` (ALSD; its top-k is K3 on the card) on this
    rank's rows: no collective.  kwargs are `rnnt_beam_decode`'s; the LM
    in `lm` is replicated."""
    group_rank(group)
    return rnnt_beam_decode(encoder_out, input_lengths, predictor_step,
                            init_hidden, joint_fn, **kwargs)


class DataParallelStreamingRNNT:
    """A streaming transducer decoder (`StreamingRNNTGreedyDecoder` or
    `StreamingRNNTBeamDecoder`) over a batch split across the group.

    Every leaf of the carried state belongs to the rows of one sample, so
    each rank carries its rows' state for the stream's whole lifetime and
    `step` and `finish` run the wrapped decoder on them with no
    collective; results are exactly the wrapped decoder's on those rows.

      dp = DataParallelStreamingRNNT(dec, group)
      st = dp.init(batch, h_enc)           # the rank's N/D rows' state
      st = dp.step(st, chunk, chunk_len)   # chunk: the rank's (N/D, Tc, E)
      tokens, lens, scores = dp.finish(st)
    """

    def __init__(self, decoder, group=None):
        self.dec = decoder
        self.group = group

    def init(self, batch_size: int, *args):
        """The state of this rank's rows of a `batch_size` batch (D must
        divide it); args are the wrapped decoder's (h_enc for the beam)."""
        _, d = group_rank(self.group)
        _check_batch(batch_size, d)
        return self.dec.init(batch_size // d, *args)

    def step(self, state, encoder_chunk, chunk_lengths=None):
        return self.dec.step(state, encoder_chunk, chunk_lengths)

    def finish(self, state, return_timestamps: bool = False):
        return self.dec.finish(state, return_timestamps=return_timestamps)

"""The collectives of the vocabulary-parallel losses, with their gradients
(Megatron's pairing), over a `torch.distributed` process group.

Every rank of the group holds the replicated inputs whole, computes its own
vocabulary shard's part, and then the same replicated loss; each rank calls
`backward()` on its copy of that loss, so the cotangent a rank receives for
a replicated value is already the full one.  Hence:
  * `reduce_from_group(x)`: all-reduce SUM forward, identity backward (a
    sum of shard parts that every rank then uses whole and alike; summing
    the cotangents too would scale every gradient by D).  "Alike" is the
    condition: a sum that one rank uses differently from the others (say,
    only the owner of a column subtracts it from that column) gets
    different cotangents on different ranks, and the identity backward
    then drops the others' parts;
  * `copy_to_group(x)`: identity forward, all-reduce SUM backward (a
    replicated input each rank reads whole but whose gradient each rank
    holds only its shard's part of);
  * `all_reduce_max(x)`: all-reduce MAX with no gradient (a stabiliser).

A gloo group takes CUDA tensors (it stages them through host memory
itself), so the same calls serve ranks that share one card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def vocab_shard(v: int, group=None):
    """(rank, V/D): this process's place in `group` (the default group when
    None) and the width of its vocabulary shard, columns
    [rank V/D, (rank+1) V/D).  Raises unless torch.distributed is
    initialised and D divides V."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the vocabulary-parallel losses need an "
                           "initialised torch.distributed process group "
                           "(torch.distributed.init_process_group)")
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    if v % d:
        raise ValueError(f"V={v} does not divide evenly over the group's {d}"
                         " ranks (pad w_out and b_out with columns whose "
                         "b_out is a large negative number)")
    return rank, v // d


def all_reduce_max(x, group=None):
    """The elementwise max of x over the group (a new tensor, no
    gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def reduce_from_group(x, group=None):
    """SUM of x over the group; the gradient passes through unchanged."""
    return _ReduceFromGroup.apply(x, group)


def copy_to_group(x, group=None):
    """x itself; its gradient is summed over the group."""
    return _CopyToGroup.apply(x, group)

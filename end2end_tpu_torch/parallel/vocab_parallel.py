"""Vocabulary-parallel (tensor-parallel) fused transducer loss over a
`torch.distributed` process group (torch port of the fused-joint part of
`end2end_tpu/parallel/vocab_parallel.py`).

    rnnt_nll_fused_vocab_parallel(enc_proj, pred_proj, w_out, b_out,
                                  targets, input_lengths, target_lengths,
                                  group=None, *, blank=0, chunk_t=64,
                                  activation=torch.tanh)

The additive joint's output projection W_out (J, V) is its only V-sized
parameter.  Each of the group's D ranks reads only its columns
[r V/D, (r+1) V/D) of `w_out` and `b_out` (the rest may hold anything), so
every per-chunk logits buffer (N, tc, U+1, V/D) is shard-local.  The
log-softmax denominator is assembled with one MAX all-reduce (no gradient:
the max only stabilises) and one SUM all-reduce per chunk, the raw blank
and label logits (each id has one owner) with one SUM each, and the
planes are those minus the denominator, on every rank alike; the replicated
planes then run the transducer DP on every rank.  Gradients reach
enc_proj and pred_proj whole on every rank (their shard parts summed over
the group) and each rank's own columns of w_out and b_out (zero
elsewhere); the collectives' gradients are in `utils/collectives.py`.
Chunks run under `torch.utils.checkpoint`, as `rnnt_nll_fused` does, with
the recompute never stopped early, so every rank replays the same
collectives in its backward pass.  Float32 throughout: the parity-grade
path.  The kernel fast path, `rnnt_nll_fused_pallas_vocab_parallel`
(ops/rnnt_joint.py), is re-exported here, as the JAX module does.

Not ported yet (ROADMAP.md queue 1, item 9): the vocabulary-parallel CTC
loss and the greedy and beam vocabulary-parallel decoders.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops.rnnt_joint import rnnt_nll_fused_pallas_vocab_parallel  # noqa: F401
from ..ops.rnnt_loss import _y_ext, rnnt_nll_from_planes
from ..utils.collectives import (all_reduce_max, copy_to_group,
                                 reduce_from_group, vocab_shard)


def rnnt_nll_fused_vocab_parallel(enc_proj, pred_proj, w_out, b_out, targets,
                                  input_lengths, target_lengths, group=None,
                                  *, blank: int = 0, chunk_t: int = 64,
                                  activation=torch.tanh):
    """Per-sample transducer NLL (N,) with the joint's output projection
    vocabulary-sharded over `group` (the default group when None).

    Args mirror `rnnt_nll_fused` with the additive joint spelled out:
    enc_proj (N, T, J), pred_proj (N, U+1, J), w_out (J, V), b_out (V,),
    targets (N, U); the group's size D must divide V.  Every rank passes
    the same values (only its own columns of w_out and b_out are read)
    and gets the same NLL.
    """
    enc_proj = torch.as_tensor(enc_proj, dtype=torch.float32)
    dev = enc_proj.device
    pred_proj, w_out, b_out = (torch.as_tensor(x, dtype=torch.float32,
                                               device=dev)
                               for x in (pred_proj, w_out, b_out))
    n, t_max, _ = enc_proj.shape
    up = pred_proj.shape[1]
    v = w_out.shape[1]
    rank, v_loc = vocab_shard(v, group)
    v0 = rank * v_loc
    targets = torch.as_tensor(targets, device=dev)
    if targets.ndim != 2 or targets.shape[1] + 1 > up:
        raise ValueError(f"targets must be (N, U) with U+1 <= {up}, got "
                         f"{tuple(targets.shape)}")
    rel_y = _y_ext(targets, up) - v0
    own_y = (rel_y >= 0) & (rel_y < v_loc)
    idx = torch.where(own_y, rel_y, 0)
    rel_b = blank - v0
    w_l, b_l = w_out[:, v0:v0 + v_loc], b_out[v0:v0 + v_loc]
    g_rows = copy_to_group(pred_proj, group)[:, None]

    def chunk_planes(enc_c):
        z = activation(enc_c[:, :, None, :] + g_rows)
        logits = z @ w_l + b_l                     # (N, tc, U+1, V/D)
        m = all_reduce_max(logits.amax(-1), group)
        lse = m + torch.log(reduce_from_group(
            torch.exp(logits - m[..., None]).sum(-1), group))
        # the raw owned columns are summed and lse subtracted after, so
        # every rank uses lse alike (see reduce_from_group)
        x_b = (logits[..., rel_b] if 0 <= rel_b < v_loc
               else torch.zeros_like(m))
        cols = idx[:, None, :, None].expand(n, enc_c.shape[1], up, 1)
        x_y = torch.where(own_y[:, None], logits.gather(3, cols)[..., 0], 0.0)
        return (reduce_from_group(x_b, group) - lse,
                reduce_from_group(x_y, group) - lse)

    enc_r = copy_to_group(enc_proj, group)
    tc = max(1, min(int(chunk_t), t_max))
    with set_checkpoint_early_stop(False):
        chunks = [checkpoint(chunk_planes, enc_r[:, i:i + tc],
                             use_reentrant=False)
                  for i in range(0, t_max, tc)]
    b_pl = torch.cat([c[0] for c in chunks], 1)
    l_pl = torch.cat([c[1] for c in chunks], 1)
    return rnnt_nll_from_planes(b_pl, l_pl, input_lengths, target_lengths)

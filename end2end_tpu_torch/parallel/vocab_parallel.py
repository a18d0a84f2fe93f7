"""Vocabulary-parallel (tensor-parallel) CTC and transducer losses and CTC
decoders over a `torch.distributed` process group (torch port of
`end2end_tpu/parallel/vocab_parallel.py`).

Convention (every entry point): each of the group's D ranks passes the
same global values, reads only its vocabulary columns [r V/D, (r+1) V/D)
(the rest may hold anything), gets the same replicated result, and gets
gradients only in its own columns (zero elsewhere); each rank calls
`backward()` on its copy of the replicated loss.  D must divide V.

The CTC loss, `ctc_nll_vocab_parallel(log_probs, targets, input_lengths,
target_lengths, group=None, blank=0)`: the kernels K1 and K2 read
lp[t, n, label] from a (T, N, C) tensor, so instead of JAX's (T, N, L)
lattice the ranks assemble a compact per-sample vocabulary, (T, N, S+1):
column 0 the blank, columns 1.. each sample's distinct labels (in
ascending order), the targets remapped to them (equal labels stay equal,
so the repeated-label rule is unchanged).  Each rank fills the columns it
owns and zeros the rest, and one SUM all-reduce of their bits (exact:
every column has one owner, and -0 stays -0) gives every rank the same
tensor; K1 and K2 run on it unchanged (their plain twins on the CPU).
The backward pass scatters K2's occupations into the rank's own columns
through the gradient's combine, run on the rank's shard with one extra
column that takes the labels (and the blank) the rank does not own, then
dropped.  The same floats reach the same kernels in the same order, so
the NLL and each rank's gradient slice are bit-equal to the unsharded
`ctc_nll`'s on the card.

The decoders: `greedy_decode_vocab_parallel` (each shard's max and
argmax, one MAX all-reduce of the values, one MIN all-reduce of the ids
among the ranks holding the max: argmax's smaller index first),
`beam_topk_prep_vocab_parallel` (a local top-min(K, V/D) through `topk`,
K3 on the card; an all-gather in rank order of the (value, id) pairs; a
merged top-K through `topk` again, equal to the global `topk`, tie order
included; the blank column from its owner) and
`beam_search_decode_vocab_parallel` (the beam on the merged candidates:
`beam_search_from_topk`, K4 or K5 and the backtrace on the card, the
candidate scan for other LMs, or with implementation='chunked'
`beam_search_chunked_lm_from_topk`).

The fused transducer loss, `rnnt_nll_fused_vocab_parallel(enc_proj,
pred_proj, w_out, b_out, targets, input_lengths, target_lengths,
group=None, *, blank=0, chunk_t=64, activation=torch.tanh)`: the additive
joint's output projection W_out (J, V) is its only V-sized parameter, so
every per-chunk logits buffer (N, tc, U+1, V/D) is shard-local.  The
log-softmax denominator is assembled with one MAX all-reduce (no
gradient: the max only stabilises) and one SUM all-reduce per chunk, the
raw blank and label logits (each id has one owner) with one SUM each, and
the planes are those minus the denominator, on every rank alike; the
replicated planes then run the transducer DP on every rank.  Gradients
reach enc_proj and pred_proj whole on every rank (their shard parts
summed over the group) and each rank's own columns of w_out and b_out
(zero elsewhere); the collectives' gradients are in
`utils/collectives.py`.  Chunks run under `torch.utils.checkpoint`, as
`rnnt_nll_fused` does, with the recompute never stopped early, so every
rank replays the same collectives in its backward pass.  Float32
throughout: the parity-grade path.  The kernel fast path,
`rnnt_nll_fused_pallas_vocab_parallel` (ops/rnnt_joint.py), is
re-exported here, as the JAX module does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops import ctc_loss_cuda
from ..ops.beam_chunked import beam_search_chunked_lm_from_topk
from ..ops.beam_search import _beam_search_scan, beam_search_from_topk
from ..ops.beam_search_cuda import (apply_token_min_logp, beam_supported,
                                    lm_fusion_supported)
from ..ops.ctc_common import build_ctc_tables, gather_lp_ext
from ..ops.ctc_loss_plain import (backward_scan, forward_scan, nll_from,
                                  nll_grad)
from ..ops.greedy import greedy_decode_from_path
from ..ops.rnnt_joint import rnnt_nll_fused_pallas_vocab_parallel  # noqa: F401
from ..ops.rnnt_loss import _y_ext, rnnt_nll_from_planes
from ..ops.topk_cuda import topk
from ..utils.collectives import (all_gather_stack, all_reduce_max,
                                 copy_to_group, reduce_from_group, sum_owned,
                                 vocab_shard)


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


# --------------------------------------------------------------------------
# The CTC loss
# --------------------------------------------------------------------------

def _compact_targets(targets, target_lengths, blank, v):
    """Each sample's distinct labels as compact columns.  Returns (cols
    (N, S) int32: each label's column in 1..S, 0 past the target length;
    gid (N, S+1) int64: each column's vocabulary id, the blank at column 0,
    -1 for columns no label uses)."""
    n, s = targets.shape
    dev = targets.device
    tgt = torch.clamp(targets.long(), 0, v - 1)  # as build_ctc_tables
    valid = (torch.arange(s, device=dev)[None]
             < target_lengths.to(dev)[:, None])
    key = torch.where(valid, tgt, v)  # past the length: sorts last
    sk, order = torch.sort(key, dim=1, stable=True)
    new = torch.ones_like(sk, dtype=torch.bool)
    new[:, 1:] = sk[:, 1:] != sk[:, :-1]
    col_sorted = torch.cumsum((new & (sk < v)).long(), dim=1)
    cols = torch.zeros_like(tgt).scatter_(1, order, col_sorted)
    cols = torch.where(valid, cols, 0)
    gid = torch.full((n, s + 2), -1, dtype=torch.long, device=dev)
    gid[:, 0] = blank
    gid.scatter_(1, torch.where(valid, cols, s + 1), tgt)
    return cols.to(torch.int32), gid[:, :s + 1]


class _CTCNllVocabParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                group, blank):
        t_max, n, v = log_probs.shape
        rank, vl = vocab_shard(v, group)
        v0 = rank * vl
        cols, gid = _compact_targets(targets, target_lengths, blank, v)
        own = (gid >= v0) & (gid < v0 + vl)
        idx = torch.where(own, gid - v0, 0)
        local = log_probs[:, :, v0:v0 + vl]
        part = local.gather(2, idx[None].expand(t_max, n, -1))
        lp_c = sum_owned(torch.where(own[None], part, 0.0), group)
        il, tl = input_lengths, target_lengths
        if log_probs.is_cuda:
            z_hat, norm_end2, alpha, anorm2 = ctc_loss_cuda.alpha_cuda(
                lp_c, cols, il, tl, 0)
            nll = nll_from(z_hat, norm_end2)
            ctx.tables = None
        else:
            tables = build_ctc_tables(cols, tl, 0, lp_c.shape[2])
            lp_c = gather_lp_ext(lp_c, tables)
            nll, z_hat, alpha, anorm2, norm_end2 = forward_scan(
                lp_c, tables.skip2, il.long(), tl.long())
            ctx.tables = tables
        ctx.v0, ctx.vl, ctx.blank = v0, vl, blank
        ctx.save_for_backward(log_probs, targets, cols, il, tl, lp_c, alpha,
                              anorm2, z_hat, norm_end2)
        return nll

    @staticmethod
    def backward(ctx, g):
        (log_probs, targets, cols, il, tl, lp_c, alpha, anorm2, z_hat,
         norm_end2) = ctx.saved_tensors
        v0, vl = ctx.v0, ctx.vl
        t_max, n, v = log_probs.shape
        # the rank's columns and a dump column (vl) for what it does not own
        lab = torch.clamp(targets.long(), 0, v - 1) - v0
        ltgt = torch.where((lab >= 0) & (lab < vl), lab, vl).to(torch.int32)
        lblank = ctx.blank - v0 if 0 <= ctx.blank - v0 < vl else vl
        shard = torch.cat([log_probs[:, :, v0:v0 + vl],
                           log_probs.new_zeros((t_max, n, 1))], dim=2)
        if log_probs.is_cuda:
            gamma = ctc_loss_cuda.beta_cuda(lp_c, cols, il, tl, alpha,
                                            anorm2, z_hat, norm_end2, 0)
            part = ctc_loss_cuda.grad_cuda(shard, ltgt, il, tl, gamma, g,
                                           lblank)
        else:
            gamma = backward_scan(lp_c, alpha, anorm2, norm_end2, z_hat,
                                  ctx.tables, il.long(), tl.long())
            ext = build_ctc_tables(ltgt, tl, lblank, vl + 1).ext_labels
            part = nll_grad(shard, gamma, ext, il.long(), g.to(shard.dtype))
        grad = torch.zeros_like(log_probs)
        grad[:, :, v0:v0 + vl] = part[:, :, :vl]
        return grad, None, None, None, None, None


def ctc_nll_vocab_parallel(log_probs, targets, input_lengths,
                           target_lengths, group=None, blank: int = 0):
    """Per-sample CTC NLL (N,) with the vocabulary sharded over `group`
    (module docstring): log_probs (T, N, V), the same on every rank, D
    dividing V; padded (N, S) targets.  Differentiable wrt log_probs: each
    rank's gradient holds its own columns.  CUDA float32 log-probs run K1,
    K2 and the combine; CPU ones their plain twins."""
    log_probs = torch.as_tensor(log_probs)
    dev = log_probs.device
    if log_probs.is_cuda and log_probs.dtype != torch.float32:
        raise ValueError("the CUDA CTC kernels are float32-only, got "
                         f"{log_probs.dtype}")
    targets, input_lengths, target_lengths = (
        torch.as_tensor(x, device=dev).to(torch.int32)
        for x in (targets, input_lengths, target_lengths))
    if targets.ndim != 2:
        raise ValueError("targets must be (N, S) padded; got "
                         f"{tuple(targets.shape)}")
    return _CTCNllVocabParallel.apply(log_probs, targets, input_lengths,
                                      target_lengths, group, int(blank))


# --------------------------------------------------------------------------
# The decoders
# --------------------------------------------------------------------------

_BIG_ID = 1 << 30


def greedy_decode_vocab_parallel(log_probs, input_lengths=None, group=None,
                                 blank: int = 0, pad_id: int = -1):
    """`greedy_decode` with the vocabulary sharded over `group`, exactly
    (tokens, lengths and scores, argmax's tie order included)."""
    log_probs = torch.as_tensor(log_probs)
    rank, vl = vocab_shard(log_probs.shape[2], group)
    best_l, id_l = log_probs[:, :, rank * vl:(rank + 1) * vl].max(dim=-1)
    best = all_reduce_max(best_l, group)
    ids = torch.where(best_l >= best, id_l + rank * vl, _BIG_ID)
    dist.all_reduce(ids, op=dist.ReduceOp.MIN, group=group)
    return greedy_decode_from_path(ids, best, input_lengths, blank=blank,
                                   pad_id=pad_id)


def _all_gather_last(x, group):
    """x (..., k) of every rank concatenated in rank order along the last
    axis."""
    parts = all_gather_stack(x, group)
    return torch.movedim(parts, 0, -2).reshape(*x.shape[:-1], -1)


def beam_topk_prep_vocab_parallel(log_probs, group, prune_k: int,
                                  blank: int = 0):
    """The merged per-frame top-K of a vocabulary-sharded lattice: each
    rank's top-min(K, V/D) of its columns, all-gathered in rank order,
    and a top-K of those (`topk`, K3 on the card, both times): the global
    `topk`, values, ids and tie order.  Returns replicated (lpk (T, N, K),
    ck (T, N, K) int32, lpb (T, N) the blank's log-probs)."""
    log_probs = torch.as_tensor(log_probs)
    t_max, n, v = log_probs.shape
    rank, vl = vocab_shard(v, group)
    v0 = rank * vl
    k = min(int(prune_k), v)
    lv, li = topk(log_probs[:, :, v0:v0 + vl].contiguous(), min(k, vl))
    lv_all = _all_gather_last(lv, group)
    gi_all = _all_gather_last(li + v0, group)
    lpk, sel = topk(lv_all, k)
    ck = gi_all.gather(2, sel.long())
    own = 0 <= blank - v0 < vl
    lpb = (log_probs[:, :, blank] if own
           else log_probs.new_zeros((t_max, n)))
    return lpk, ck, sum_owned(lpb.contiguous(), group)


def beam_search_decode_vocab_parallel(
        log_probs, input_lengths=None, group=None, beam_width: int = 8,
        blank: int = 0, prune_k: int | None = None,
        max_symbols: int | None = None, lm=None, lm_alpha: float = 0.0,
        lm_beta: float = 0.0, implementation: str = "auto",
        return_timestamps: bool = False,
        token_min_logp: float | None = None, lm_chunk_t: int = 128,
        guide_lm=None):
    """`beam_search_decode` with the vocabulary sharded over `group`: the
    merged top-K prep (`beam_topk_prep_vocab_parallel`), then the beam on
    the replicated candidates, JAX's candidate-only semantics (exact at
    prune_k >= V, else the beam kernel's documented prune):
      * 'auto': `beam_search_from_topk` (K4, or K5 with a dense bigram
        `NGramLM`, and the backtrace on the card; the candidate scan for
        any other LM) inside the beam kernel's envelope, the candidate
        scan outside it;
      * 'pallas': the same, raising outside the envelope (an LM the
        kernel does not fuse included);
      * 'xla': the candidate scan;
      * 'chunked': `beam_search_chunked_lm_from_topk` (an LM with
        `score_chunk`, optionally steered by `guide_lm`).
    `token_min_logp` masks the merged candidates, as the unsharded decode
    masks its own.  Returns `beam_search_decode`'s outputs."""
    if implementation not in ("auto", "pallas", "chunked", "xla"):
        raise ValueError(f"invalid implementation {implementation!r}")
    if guide_lm is not None and implementation != "chunked":
        raise ValueError("guide_lm is only meaningful with "
                         "implementation='chunked'")
    log_probs = torch.as_tensor(log_probs)
    t_max, n, v = log_probs.shape
    if input_lengths is None:
        input_lengths = torch.full((n,), t_max, dtype=torch.int32)
    il = torch.as_tensor(input_lengths).to(device=log_probs.device,
                                           dtype=torch.int32)
    k = min(int(prune_k or v), v)
    s_cap = int(max_symbols or min(t_max, 512))
    lpk, ck, lpb = beam_topk_prep_vocab_parallel(log_probs, group, k,
                                                 blank=blank)
    lpk, ck = apply_token_min_logp(lpk, ck, token_min_logp)
    W = int(beam_width)
    if implementation == "chunked":
        return beam_search_chunked_lm_from_topk(
            lpk, ck, lpb, il, v=v, beam_width=W, blank=blank,
            max_symbols=s_cap, lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta,
            chunk_t=lm_chunk_t, return_timestamps=return_timestamps,
            guide_lm=guide_lm)
    ok, reason = beam_supported(W, k, lpk.dtype)
    if ok and implementation == "pallas" and lm is not None:
        ok, reason = lm_fusion_supported(lm, v, W)
    if implementation == "pallas" and not ok:
        raise ValueError(f"implementation='pallas' unsupported: {reason}")
    if implementation == "xla" or not ok:
        out = _beam_search_scan(
            None, il, W, k, s_cap, int(blank), lm=lm,
            lm_alpha=float(lm_alpha), lm_beta=float(lm_beta),
            candidates=(lpk, ck, lpb))
        return out if return_timestamps else out[:3]
    return beam_search_from_topk(
        lpk, ck, lpb, il, W, int(blank), s_cap, lm=lm,
        lm_alpha=float(lm_alpha), lm_beta=float(lm_beta),
        return_timestamps=return_timestamps)

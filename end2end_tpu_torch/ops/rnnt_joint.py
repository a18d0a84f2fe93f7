"""The online-softmax fused transducer joint (torch port of
`end2end_tpu/ops/rnnt_joint_pallas.py`).

    rnnt_nll_fused_pallas(enc_proj, pred_proj, w_out, b_out, targets,
                          input_lengths, target_lengths, blank=0,
                          activation=torch.tanh, implementation='auto')
    rnnt_nll_fused_pallas_vocab_parallel(..., target_lengths, group=None,
                                         blank=0, activation=torch.tanh,
                                         implementation='auto')

The TRAINING fast path of the transducer loss at production vocabularies:
the joint logits W_out act(enc_proj[t] + pred_proj[u]) + b_out are reduced
to the two DP planes tile by tile, with an online max / sum-exp, so the
(N, T, U+1, V) logits never reach device memory, in either pass
(ops/rnnt_joint_plain.py says what is computed).  On CUDA float32 tensors
the kernels K10 (forward), K11 (dh) and K12 (dW, db) of csrc/rnnt_joint.cu
run (ops/rnnt_joint_cuda.py), and raise for inputs they do not take; on CPU
tensors their plain twins.  Nothing falls back from one to the other.

The vocabulary-parallel form shards W_out's columns over a
`torch.distributed` process group: each rank runs K10tp over its (J, V/D)
slice; one MAX and two SUM all-reduces build the global softmax stats and
the raw blank and label columns, 4 floats a row instead of V logits; the
backward runs K11tp (a partial dh) and K12tp (the shard's own dW, db) with
the global stats.  The partial dh is summed over the group where it is
smallest, at the replicated inputs enc_proj and pred_proj
(`collectives.copy_to_group`; N (T + U+1) J floats instead of the
N T (U+1) J of dh, the same sum since the activation's backward is
linear in dh).  The plane cotangents are not summed: every rank holds the
full ones (utils/collectives.py).

Numerics: h and W_out enter the products as bfloat16 and the sums are
float32, so the logits move by O(1e-2) -- the budget of
`fused_additive_joint(matmul_dtype='bfloat16')`.  Sharded tracks unsharded
to float32 roundoff (only the cross-shard combine order of the sum-exp
differs).  The parity-grade paths are the float32 `rnnt_nll_fused`
(ops/rnnt_loss.py) and `rnnt_nll_fused_vocab_parallel`
(parallel/vocab_parallel.py).
"""

from __future__ import annotations

import torch

from ..utils.collectives import (all_reduce_max, copy_to_group,
                                 reduce_from_group, vocab_shard)
from . import rnnt_joint_cuda, rnnt_joint_plain
from .rnnt_loss import _IMPLEMENTATIONS, _y_ext, rnnt_nll_from_planes


def _planes_grads(ctx, g_b, g_l, dh_fn, dw_fn):
    """dh, dW and db from the planes' cotangents and the saved (h, w, b, y,
    m, logs); None for an input that needs no gradient."""
    h, w, b, y, m, logs = ctx.saved_tensors
    args = (h, w, b, y, ctx.blank, m, logs, g_b.contiguous(),
            g_l.contiguous())
    need = ctx.needs_input_grad
    dh = dh_fn(*args) if need[0] else None
    dw = db = None
    if need[1] or need[2]:
        dw, db = dw_fn(*args)
    return dh, dw, db


class _JointPlanes(torch.autograd.Function):
    """(h (R, J), w (J, V), b (V,), y (R,)) -> the blank and label planes
    (R,); the forward keeps the row statistics m and log s, and the
    backward recomputes the logits: dh through K11, dW and db through
    K12."""

    @staticmethod
    def forward(ctx, h, w, b, y, blank, backend):
        b_pl, l_pl, m, logs = backend.joint_fwd(h, w, b, y, blank)
        ctx.blank, ctx.backend = blank, backend
        ctx.save_for_backward(h, w, b, y, m, logs)
        return b_pl, l_pl

    @staticmethod
    def backward(ctx, g_b, g_l):
        return (*_planes_grads(ctx, g_b, g_l, ctx.backend.joint_dh,
                               ctx.backend.joint_dw), None, None, None)


class _JointPlanesTP(torch.autograd.Function):
    """One rank's shard: (h (R, J), w (J, V/D), b (V/D,), shard-relative
    y (R,) and blank, -1 where another rank owns the column) -> the global
    blank and label planes (R,), assembled over `group`.  The backward
    returns this shard's partial dh and its own dW, db."""

    @staticmethod
    def forward(ctx, h, w, b, y, blank, backend, group):
        xb, xy, m_l, logs_l = backend.joint_fwd_tp(h, w, b, y, blank)
        m = all_reduce_max(m_l, group)
        logs = torch.log(reduce_from_group(torch.exp(logs_l + (m_l - m)),
                                           group))
        xb, xy = reduce_from_group(torch.stack([xb, xy]), group)
        ctx.blank, ctx.backend = blank, backend
        ctx.save_for_backward(h, w, b, y, m, logs)
        return (xb - m) - logs, (xy - m) - logs

    @staticmethod
    def backward(ctx, g_b, g_l):
        return (*_planes_grads(ctx, g_b, g_l, ctx.backend.joint_dh_tp,
                               ctx.backend.joint_dw_tp),
                None, None, None, None)


def _joint_inputs(enc_proj, pred_proj, w_out, b_out, targets, blank,
                  implementation):
    """Checked float32 tensors on enc_proj's device, and the sizes."""
    if implementation not in _IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {_IMPLEMENTATIONS},"
                         f" got {implementation!r}")
    enc_proj = torch.as_tensor(enc_proj, dtype=torch.float32)
    dev = enc_proj.device
    pred_proj, w_out, b_out = (torch.as_tensor(x, dtype=torch.float32,
                                               device=dev)
                               for x in (pred_proj, w_out, b_out))
    if enc_proj.ndim != 3 or pred_proj.ndim != 3 or w_out.ndim != 2:
        raise ValueError("need enc_proj (N, T, J), pred_proj (N, U+1, J) and "
                         f"w_out (J, V), got {tuple(enc_proj.shape)}, "
                         f"{tuple(pred_proj.shape)}, {tuple(w_out.shape)}")
    n, _, j = enc_proj.shape
    up = pred_proj.shape[1]
    v = w_out.shape[1]
    if (pred_proj.shape[::2] != (n, j) or w_out.shape[0] != j
            or b_out.shape != (v,)):
        raise ValueError(f"shapes do not fit: enc_proj {tuple(enc_proj.shape)}"
                         f", pred_proj {tuple(pred_proj.shape)}, w_out "
                         f"{tuple(w_out.shape)}, b_out {tuple(b_out.shape)}")
    if not 0 <= blank < v:
        raise ValueError(f"blank={blank} is not a column of V={v}")
    targets = torch.as_tensor(targets, device=dev)
    if targets.ndim != 2 or targets.shape[1] + 1 > up:
        raise ValueError(f"targets must be (N, U) with U+1 <= {up}, got "
                         f"{tuple(targets.shape)}")
    return enc_proj, pred_proj, w_out, b_out, targets


def _labels(targets, shape):
    """The (N, U) targets as each row's label (R,), R = N T (U+1)."""
    n, t_max, up = shape
    return _y_ext(targets, up)[:, None, :].expand(n, t_max, up).reshape(-1)


def rnnt_nll_fused_pallas(enc_proj, pred_proj, w_out, b_out, targets,
                          input_lengths, target_lengths, *, blank: int = 0,
                          activation=torch.tanh,
                          implementation: str = "auto"):
    """Per-sample transducer NLL (N,) through the online-softmax fused
    joint; differentiable in enc_proj, pred_proj, w_out and b_out.

    Args:
      enc_proj: (N, T, J) projected encoder frames.
      pred_proj: (N, U+1, J) projected predictor states.
      w_out, b_out: (J, V) and (V,), the joint's output projection.
      targets: (N, U) padded labels; input_lengths, target_lengths (N,).
      blank: the blank id, 0 <= blank < V.
      activation: applied to enc_proj[t] + pred_proj[u] (torch, so its
        gradient flows back to both).
      implementation: routes the wavefront DP after the planes, as in
        `rnnt_nll_from_planes` ('auto' | 'xla' | 'pallas').
    All inputs compute in float32 on enc_proj's device.
    """
    enc_proj, pred_proj, w_out, b_out, targets = _joint_inputs(
        enc_proj, pred_proj, w_out, b_out, targets, blank, implementation)
    shape = (*enc_proj.shape[:2], pred_proj.shape[1])
    h = activation(enc_proj[:, :, None, :] + pred_proj[:, None, :, :])
    backend = rnnt_joint_cuda if h.is_cuda else rnnt_joint_plain
    b_pl, l_pl = _JointPlanes.apply(
        h.reshape(-1, h.shape[-1]), w_out, b_out,
        _labels(targets, shape).to(torch.int32), int(blank), backend)
    return rnnt_nll_from_planes(b_pl.reshape(shape), l_pl.reshape(shape),
                                input_lengths, target_lengths,
                                implementation=implementation)


def rnnt_nll_fused_pallas_vocab_parallel(
        enc_proj, pred_proj, w_out, b_out, targets, input_lengths,
        target_lengths, group=None, *, blank: int = 0,
        activation=torch.tanh, implementation: str = "auto"):
    """`rnnt_nll_fused_pallas` with the joint's output projection
    vocabulary-sharded over `group` (a torch.distributed process group;
    the default group when None, which must be initialised).

    Every rank passes the same arguments; `w_out` is the full (J, V), of
    which rank r reads only columns [r V/D, (r+1) V/D) (the rest may hold
    anything), so its `w_out.grad` and `b_out.grad` are nonzero only
    there.  Every rank gets the same NLL (N,) and the whole gradients of
    enc_proj and pred_proj.  D must divide V (pad w_out with columns whose
    b_out is a large negative number).  CUDA tensors run K10tp-K12tp, CPU
    tensors their plain twins; `implementation` routes the DP as in
    `rnnt_nll_fused_pallas`.
    """
    enc_proj, pred_proj, w_out, b_out, targets = _joint_inputs(
        enc_proj, pred_proj, w_out, b_out, targets, blank, implementation)
    rank, v_loc = vocab_shard(w_out.shape[1], group)
    v0 = rank * v_loc
    shape = (*enc_proj.shape[:2], pred_proj.shape[1])
    enc_proj, pred_proj = (copy_to_group(x, group)
                           for x in (enc_proj, pred_proj))
    h = activation(enc_proj[:, :, None, :] + pred_proj[:, None, :, :])
    y = _labels(targets, shape) - v0
    y = torch.where((y >= 0) & (y < v_loc), y, -1).to(torch.int32)
    blank_rel = blank - v0 if 0 <= blank - v0 < v_loc else -1
    backend = rnnt_joint_cuda if h.is_cuda else rnnt_joint_plain
    b_pl, l_pl = _JointPlanesTP.apply(
        h.reshape(-1, h.shape[-1]), w_out[:, v0:v0 + v_loc].contiguous(),
        b_out[v0:v0 + v_loc].contiguous(), y, int(blank_rel), backend, group)
    return rnnt_nll_from_planes(b_pl.reshape(shape), l_pl.reshape(shape),
                                input_lengths, target_lengths,
                                implementation=implementation)

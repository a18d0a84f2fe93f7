"""The online-softmax fused transducer joint (torch port of
`end2end_tpu/ops/rnnt_joint_pallas.py`, single device).

    rnnt_nll_fused_pallas(enc_proj, pred_proj, w_out, b_out, targets,
                          input_lengths, target_lengths, blank=0,
                          activation=torch.tanh, implementation='auto')

The TRAINING fast path of the transducer loss at production vocabularies:
the joint logits W_out act(enc_proj[t] + pred_proj[u]) + b_out are reduced
to the two DP planes tile by tile, with an online max / sum-exp, so the
(N, T, U+1, V) logits never reach device memory, in either pass
(ops/rnnt_joint_plain.py says what is computed).  On CUDA float32 tensors
the kernels K10 (forward), K11 (dh) and K12 (dW, db) of csrc/rnnt_joint.cu
run (ops/rnnt_joint_cuda.py), and raise for inputs they do not take; on CPU
tensors their plain twins.  Nothing falls back from one to the other.

Numerics: h and W_out enter the products as bfloat16 and the sums are
float32, so the logits move by O(1e-2) -- the budget of
`fused_additive_joint(matmul_dtype='bfloat16')`.  The parity-grade path is
the float32 `rnnt_nll_fused` (ops/rnnt_loss.py).
"""

from __future__ import annotations

import torch

from . import rnnt_joint_cuda, rnnt_joint_plain
from .rnnt_loss import _IMPLEMENTATIONS, _y_ext, rnnt_nll_from_planes


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
        h, w, b, y, m, logs = ctx.saved_tensors
        args = (h, w, b, y, ctx.blank, m, logs, g_b.contiguous(),
                g_l.contiguous())
        need = ctx.needs_input_grad
        dh = ctx.backend.joint_dh(*args) if need[0] else None
        dw = db = None
        if need[1] or need[2]:
            dw, db = ctx.backend.joint_dw(*args)
        return dh, dw, db, None, None, None


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
    n, t_max, j = enc_proj.shape
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
    h = activation(enc_proj[:, :, None, :] + pred_proj[:, None, :, :])
    y = _y_ext(targets, up)[:, None, :].expand(n, t_max, up)
    backend = rnnt_joint_cuda if h.is_cuda else rnnt_joint_plain
    b_pl, l_pl = _JointPlanes.apply(
        h.reshape(n * t_max * up, j), w_out, b_out,
        y.reshape(-1).to(torch.int32), int(blank), backend)
    return rnnt_nll_from_planes(b_pl.reshape(n, t_max, up),
                                l_pl.reshape(n, t_max, up), input_lengths,
                                target_lengths,
                                implementation=implementation)

"""The online-softmax fused transducer joint on the card: K10 (forward),
K11 (dh) and K12 (dW, db) of csrc/rnnt_joint.cu, and their
vocabulary-sharded modes K10tp, K11tp, K12tp.

Port of the kernels of `end2end_tpu/ops/rnnt_joint_pallas.py`.
`joint_fwd`, `joint_dh`, `joint_dw` and the `_tp` three have the
signatures of their plain versions in ops/rnnt_joint_plain.py and take
CUDA float32 h (R, J), w (J, V), b (V,), int32 labels y (R,) and, for the
backward, float32 (R,) m, logs, gb, gl, all contiguous; any J >= 1 (above
128 the kernels walk J in 128-row slabs).  The `_tp` functions run one
shard's (J, V/D) slice, with shard-relative blank and label ids, -1 where
another shard owns the column.  Each call rounds h and W to bf16 once (W
zero-padded to a whole number of 128-column tiles) for the kernels' tensor
cores.  Nothing here falls back to the plain version: anything the kernels
do not take raises.

`launches` counts kernel launches by name (it is the only module state).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

launches = {"joint_fwd": 0, "joint_dh": 0, "joint_dw": 0,
            "joint_fwd_tp": 0, "joint_dh_tp": 0, "joint_dw_tp": 0}

TILE_V = 128  # vocabulary columns per tile
ROWS = 64     # rows of h per block
SLAB_J = 128  # J rows per slab above J = 128


def _check(h, w, b, y, blank, stats=(), tp=False):
    """Raise unless the kernels take these inputs; returns (R, J, V).  In
    TP mode a blank of -1 (another shard's column) is allowed."""
    floats = (("h", h), ("w", w), ("b", b), *stats)
    for name, x in (*floats, ("y", y)):
        if not x.is_cuda:
            raise ValueError("the CUDA joint kernels need CUDA tensors, got "
                             f"{name} on {x.device}")
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
        if not x.is_contiguous():
            raise ValueError(f"the CUDA joint kernels need contiguous "
                             f"tensors; {name} is not")
    for name, x in floats:
        if x.dtype != torch.float32:
            raise ValueError("the CUDA joint kernels are float32-only, got "
                             f"{name} of {x.dtype}")
    if y.dtype != torch.int32:
        raise ValueError(f"y must be int32, got {y.dtype}")
    if h.ndim != 2 or w.ndim != 2:
        raise ValueError(f"need h (R, J) and w (J, V), got {tuple(h.shape)} "
                         f"and {tuple(w.shape)}")
    r, j = h.shape
    v = w.shape[1]
    if w.shape[0] != j or b.shape != (v,) or y.shape != (r,):
        raise ValueError(f"shapes do not fit: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, y "
                         f"{tuple(y.shape)}")
    for name, x in stats:
        if x.shape != (r,):
            raise ValueError(f"{name} must be ({r},), got {tuple(x.shape)}")
    if j < 1:
        raise ValueError(f"J={j}: the CUDA joint kernels need J >= 1")
    if not (-1 if tp else 0) <= blank < v:
        raise ValueError(f"blank={blank} is not a column of V={v}"
                         + (" (or -1)" if tp else ""))
    return r, j, v


def _bf16_w(w, v):
    """W as bf16 (J, Vp), zero past V; Vp a multiple of TILE_V."""
    vp = -(-v // TILE_V) * TILE_V
    wb = torch.empty((w.shape[0], vp), dtype=torch.bfloat16, device=w.device)
    wb[:, v:].zero_()
    wb[:, :v].copy_(w)
    return wb, vp


def _slab_width(j):
    """J padded as the kernels pad it: 16, 32, 64, 128, or above 128 a
    whole number of 128-row slabs."""
    if j > SLAB_J:
        return -(-j // SLAB_J) * SLAB_J
    jp = 16
    while jp < j:
        jp *= 2
    return jp


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd(h, w, b, y, blank, tp):
    """Launch K10 (K10tp with `tp`): four (R,) float32 outputs."""
    r, j, v = _check(h, w, b, y, blank, tp=tp)
    dev = h.device
    hb = h.to(torch.bfloat16)
    wb, vp = _bf16_w(w, v)
    out = torch.empty((4, r), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_fwd(
            hb.data_ptr(), wb.data_ptr(), b.data_ptr(), y.data_ptr(),
            *(o.data_ptr() for o in out), r, j, v, vp, blank, int(tp),
            _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_fwd")
    launches["joint_fwd_tp" if tp else "joint_fwd"] += 1
    return out[0], out[1], out[2], out[3]


def joint_fwd(h, w, b, y, blank):
    """Launch K10.  Returns (b_pl, l_pl, m, logs), each (R,) float32."""
    return _fwd(h, w, b, y, blank, tp=False)


def joint_fwd_tp(h, w, b, y, blank):
    """Launch K10tp on a shard.  Returns (xb, xy, m, logs), each (R,)
    float32: the raw blank and label logits (0 where unowned) and the
    shard's local max and log sum-exp."""
    return _fwd(h, w, b, y, blank, tp=True)


def _bwd_args(h, w, b, y, blank, m, logs, gb, gl, tp):
    """The backward kernels' pointer arguments, and the bf16 copies they
    point into (to be kept alive until the launch)."""
    stats = (("m", m), ("logs", logs), ("gb", gb), ("gl", gl))
    r, j, v = _check(h, w, b, y, blank, stats, tp)
    hb = h.to(torch.bfloat16)
    wb, vp = _bf16_w(w, v)
    ptrs = (hb.data_ptr(), wb.data_ptr(), b.data_ptr(), y.data_ptr(),
            m.data_ptr(), logs.data_ptr(), gb.data_ptr(), gl.data_ptr())
    return ptrs, (hb, wb), r, j, v, vp


def _dh(h, w, b, y, blank, m, logs, gb, gl, tp):
    ptrs, _alive, r, j, v, vp = _bwd_args(h, w, b, y, blank, m, logs, gb,
                                          gl, tp)
    dev = h.device
    rp = -(-r // ROWS) * ROWS
    dh = torch.empty((rp, _slab_width(j)), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_dh(*ptrs, dh.data_ptr(), r, j, v, vp,
                                       blank, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_dh")
    launches["joint_dh_tp" if tp else "joint_dh"] += 1
    return dh[:r, :j]


def joint_dh(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K11.  Returns dh (R, J) float32."""
    return _dh(h, w, b, y, blank, m, logs, gb, gl, tp=False)


def joint_dh_tp(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K11tp on a shard with the GLOBAL m, logs.  Returns the
    shard's partial dh (R, J) float32 (the sum over shards is dh)."""
    return _dh(h, w, b, y, blank, m, logs, gb, gl, tp=True)


def _dw(h, w, b, y, blank, m, logs, gb, gl, tp):
    ptrs, _alive, r, j, v, vp = _bwd_args(h, w, b, y, blank, m, logs, gb,
                                          gl, tp)
    dev = h.device
    dw = torch.empty((_slab_width(j), vp), dtype=torch.float32, device=dev)
    db = torch.empty(vp, dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_dw(*ptrs, dw.data_ptr(), db.data_ptr(), r,
                                       j, v, vp, blank, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_dw")
    launches["joint_dw_tp" if tp else "joint_dw"] += 1
    return dw[:j, :v], db[:v]


def joint_dw(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K12.  Returns (dw (J, V), db (V,)) float32."""
    return _dw(h, w, b, y, blank, m, logs, gb, gl, tp=False)


def joint_dw_tp(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K12tp on a shard with the GLOBAL m, logs.  Returns the
    shard's own (dw (J, V/D), db (V/D,)) float32."""
    return _dw(h, w, b, y, blank, m, logs, gb, gl, tp=True)

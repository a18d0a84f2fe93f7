"""The online-softmax fused transducer joint on the card: K10 (forward),
K11 (dh) and K12 (dW, db) of csrc/rnnt_joint.cu.

Port of the kernels of `end2end_tpu/ops/rnnt_joint_pallas.py`.
`joint_fwd`, `joint_dh` and `joint_dw` have the signatures of their plain
versions in ops/rnnt_joint_plain.py and take CUDA float32 h (R, J), w
(J, V), b (V,), int32 labels y (R,) and, for the backward, float32 (R,) m,
logs, gb, gl, all contiguous.  Each call rounds h and W to bf16 once (W
zero-padded to a whole number of 128-column tiles) for the kernels' tensor
cores.  Nothing here falls back to the plain version: anything the kernels
do not take raises, J > 128 included (K12 keeps its (J, 128) float32
accumulator in registers).

`launches` counts kernel launches by name (it is the only module state).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

launches = {"joint_fwd": 0, "joint_dh": 0, "joint_dw": 0}

TILE_V = 128  # vocabulary columns per tile
ROWS = 64     # rows of h per block
MAX_J = 128


def _check(h, w, b, y, blank, stats=()):
    """Raise unless the kernels take these inputs; returns (R, J, V)."""
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
    if not 1 <= j <= MAX_J:
        raise ValueError(f"J={j}: the CUDA joint kernels take 1 <= J <= "
                         f"{MAX_J} (K12's accumulator lives in registers)")
    if not 0 <= blank < v:
        raise ValueError(f"blank={blank} is not a column of V={v}")
    return r, j, v


def _bf16_w(w, v):
    """W as bf16 (J, Vp), zero past V; Vp a multiple of TILE_V."""
    vp = -(-v // TILE_V) * TILE_V
    wb = torch.empty((w.shape[0], vp), dtype=torch.bfloat16, device=w.device)
    wb[:, v:].zero_()
    wb[:, :v].copy_(w)
    return wb, vp


def _slab_width(j):
    """J padded as the kernels pad it in shared memory: 16, 32, 64, 128."""
    jp = 16
    while jp < j:
        jp *= 2
    return jp


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def joint_fwd(h, w, b, y, blank):
    """Launch K10.  Returns (b_pl, l_pl, m, logs), each (R,) float32."""
    r, j, v = _check(h, w, b, y, blank)
    dev = h.device
    hb = h.to(torch.bfloat16)
    wb, vp = _bf16_w(w, v)
    out = torch.empty((4, r), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_fwd(
            hb.data_ptr(), wb.data_ptr(), b.data_ptr(), y.data_ptr(),
            *(o.data_ptr() for o in out), r, j, v, vp, blank, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_fwd")
    launches["joint_fwd"] += 1
    return out[0], out[1], out[2], out[3]


def _bwd_args(h, w, b, y, blank, m, logs, gb, gl):
    """The backward kernels' pointer arguments, and the bf16 copies they
    point into (to be kept alive until the launch)."""
    stats = (("m", m), ("logs", logs), ("gb", gb), ("gl", gl))
    r, j, v = _check(h, w, b, y, blank, stats)
    hb = h.to(torch.bfloat16)
    wb, vp = _bf16_w(w, v)
    ptrs = (hb.data_ptr(), wb.data_ptr(), b.data_ptr(), y.data_ptr(),
            m.data_ptr(), logs.data_ptr(), gb.data_ptr(), gl.data_ptr())
    return ptrs, (hb, wb), r, j, v, vp


def joint_dh(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K11.  Returns dh (R, J) float32."""
    ptrs, _alive, r, j, v, vp = _bwd_args(h, w, b, y, blank, m, logs, gb, gl)
    dev = h.device
    rp = -(-r // ROWS) * ROWS
    dh = torch.empty((rp, _slab_width(j)), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_dh(*ptrs, dh.data_ptr(), r, j, v, vp,
                                       blank, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_dh")
    launches["joint_dh"] += 1
    return dh[:r, :j]


def joint_dw(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K12.  Returns (dw (J, V), db (V,)) float32."""
    ptrs, _alive, r, j, v, vp = _bwd_args(h, w, b, y, blank, m, logs, gb, gl)
    dev = h.device
    dw = torch.empty((_slab_width(j), vp), dtype=torch.float32, device=dev)
    db = torch.empty(vp, dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_dw(*ptrs, dw.data_ptr(), db.data_ptr(), r,
                                       j, v, vp, blank, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_dw")
    launches["joint_dw"] += 1
    return dw[:j, :v], db[:v]

"""Transducer loss on the card: the alpha wavefront kernel (K8) and the beta
wavefront fused with the posteriors (K9) of csrc/rnnt_loss.cu.

Port of `end2end_tpu/ops/rnnt_loss_pallas.py`.  `alpha` and `posteriors`
have the signatures of their plain versions in ops/rnnt_loss_plain.py and
take CUDA float32 (N, T, U+1) planes; ops/rnnt_loss.py wires them into the
three autograd functions.  Nothing here falls back to the plain version:
anything the kernels do not take raises.  The launch plan of both kernels
(`wavefront_plan`: lanes a thread, warps, ring depth, shared bytes) is
computed here and checked by the C entry points.

`launches` counts kernel launches by name (it is the only module state).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

launches = {"rnnt_alpha": 0, "rnnt_posteriors": 0}

# A block may use 227 KB of shared memory on the H100.
_SMEM_LIMIT = 232448
_MAX_THREADS = 1024
# Lanes in registers, R a thread: the fewest of LANES that fit 1024 threads
# (U+1 <= 8192), over whole warps; past that the rows in shared memory.
# K8 and K9 share the plan, chosen for their sum (the breakdown tool times
# the other plans by text patches; PERF.md §6): at the bench lattice one
# warp of 3 lanes a thread costs K8 0.19 ms against 0.11, while K9 alone
# is within 3% either way (0.1586 against 0.1636 ms in one run, 0.1650
# against 0.1644 in another).
LANES = (1, 2, 4, 8)
# Diagonals of plane entries copied ahead: RING, and 2 at 8 lanes a thread,
# where a ring of RING does not fit 1024 threads' shared memory.
RING = 4
_REGS_UP = _MAX_THREADS * LANES[-1]  # the register plans' lanes


def wavefront_plan(up: int) -> dict:
    """K8's and K9's launch at U+1 = up lanes: `lanes` a thread (R, the
    fewest of LANES that fit 1024 threads), `warps` (whole warps over
    ceil(up/R) threads), `ring` (diagonals of plane entries copied ahead)
    and `smem`, the bytes of the slot row (8 floats a warp) and the ring
    (2R floats a thread a stage).  Past 8192 lanes the rows live in shared
    memory: lanes 0, 32 warps, ring 0 and 4 (2 up + 33) bytes.  Raises
    where a diagonal does not fit shared memory (up > 29039)."""
    if up < 1:
        raise ValueError(f"U+1={up}: the wavefront kernels need a lane")
    if up > _REGS_UP:
        smem = 4 * (2 * up + 33)
        if smem > _SMEM_LIMIT:
            raise ValueError(f"U+1={up}: a diagonal does not fit the "
                             "kernels' shared memory")
        return {"lanes": 0, "warps": _MAX_THREADS // 32, "ring": 0,
                "smem": smem}
    lanes = next(r for r in LANES if -(-up // r) <= _MAX_THREADS)
    warps = -(-(-(-up // lanes)) // 32)
    ring = RING if lanes < LANES[-1] else 2
    return {"lanes": lanes, "warps": warps, "ring": ring,
            "smem": 4 * (8 * warps + ring * 2 * lanes * 32 * warps)}


def workspace(n: int, t_max: int, up: int, plan: dict, post: bool):
    """Floats of scratch the C entry takes, D = T+U diagonals: the skewed
    planes (2 N D Up; K9: also, before them, the beta tape, N D Up, and its
    offsets, D N), none with the rows in shared memory.  Freed when the
    call returns (PERF.md §6 gives its size at the timed shapes)."""
    if plan["lanes"] == 0:
        return 0
    rows = n * (t_max + up - 1)
    return (3 * up + 1) * rows if post else 2 * up * rows


def _check(*planes):
    for p in planes:
        if not p.is_cuda:
            raise ValueError("the CUDA transducer kernels need CUDA tensors, "
                             f"got {p.device}")
        if p.dtype != torch.float32:
            raise ValueError("the CUDA transducer kernels are float32-only, "
                             f"got {p.dtype}")
        if p.ndim != 3 or p.shape != planes[0].shape:
            raise ValueError("need two (N, T, U+1) planes of one shape, got "
                             f"{[tuple(q.shape) for q in planes]}")
    return wavefront_plan(planes[0].shape[2])


def _work(n, t_max, up, plan, post, dev):
    return torch.empty(max(workspace(n, t_max, up, plan, post), 1),
                       dtype=torch.float32, device=dev)


def _plan_args(plan):
    return [plan[k] for k in ("lanes", "warps", "ring", "smem")]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def alpha(b_pl, l_pl):
    """Launch K8.  Returns (tape (D, N, U+1), rcum (D, N)), D = T+U."""
    plan = _check(b_pl, l_pl)
    n, t_max, up = b_pl.shape
    dev = b_pl.device
    d_total = t_max + up - 1
    b_pl, l_pl = b_pl.contiguous(), l_pl.contiguous()
    tape = torch.empty((d_total, n, up), dtype=torch.float32, device=dev)
    rcum = torch.empty((d_total, n), dtype=torch.float32, device=dev)
    work = _work(n, t_max, up, plan, False, dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_alpha_f32(
            b_pl.data_ptr(), l_pl.data_ptr(), work.data_ptr(),
            tape.data_ptr(), rcum.data_ptr(), n, t_max, up,
            *_plan_args(plan), _stream(dev))
    cuda_build.check(status, "e2e_rnnt_alpha_f32")
    launches["rnnt_alpha"] += 1
    return tape, rcum


def posteriors(b_pl, l_pl, tape, rcum, il, ul, z_small, z_off):
    """Launch K9 on K8's outputs.  Returns (i_blank, i_label) (N, T, U+1),
    0 at frames t >= il."""
    plan = _check(b_pl, l_pl)
    n, t_max, up = b_pl.shape
    dev = b_pl.device
    if tape.shape != (t_max + up - 1, n, up) or rcum.shape != tape.shape[:2]:
        raise ValueError(f"tape {tuple(tape.shape)} / rcum "
                         f"{tuple(rcum.shape)} do not fit planes "
                         f"{tuple(b_pl.shape)}")
    b_pl, l_pl = b_pl.contiguous(), l_pl.contiguous()
    tape, rcum = tape.float().contiguous(), rcum.float().contiguous()
    il, ul = (x.to(dev, torch.int32).contiguous() for x in (il, ul))
    zs, zo = (x.to(dev, torch.float32).contiguous() for x in (z_small, z_off))
    gb = torch.empty_like(b_pl)
    gl = torch.empty_like(b_pl)
    work = _work(n, t_max, up, plan, True, dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_post_f32(
            b_pl.data_ptr(), l_pl.data_ptr(), tape.data_ptr(),
            rcum.data_ptr(), il.data_ptr(), ul.data_ptr(), zs.data_ptr(),
            zo.data_ptr(), gb.data_ptr(), gl.data_ptr(), work.data_ptr(), n,
            t_max, up, *_plan_args(plan), _stream(dev))
    cuda_build.check(status, "e2e_rnnt_post_f32")
    launches["rnnt_posteriors"] += 1
    return gb, gl

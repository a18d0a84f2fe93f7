"""Transducer loss on the card: the alpha wavefront kernel (K8) and the beta
wavefront fused with the posteriors (K9) of csrc/rnnt_loss.cu.

Port of `end2end_tpu/ops/rnnt_loss_pallas.py`.  `alpha` and `posteriors`
have the signatures of their plain versions in ops/rnnt_loss_plain.py and
take CUDA float32 (N, T, U+1) planes; ops/rnnt_loss.py wires them into the
three autograd functions.  Nothing here falls back to the plain version:
anything the kernels do not take raises.

`launches` counts kernel launches by name (it is the only module state).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

launches = {"rnnt_alpha": 0, "rnnt_posteriors": 0}

# A block may use 227 KB of shared memory on the H100.
_SMEM_LIMIT = 232448


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
    up = planes[0].shape[2]
    if 4 * (2 * up + 33) > _SMEM_LIMIT:
        raise ValueError(f"U+1={up}: a diagonal does not fit the kernels' "
                         "shared memory")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def alpha(b_pl, l_pl):
    """Launch K8.  Returns (tape (D, N, U+1), rcum (D, N)), D = T+U."""
    _check(b_pl, l_pl)
    n, t_max, up = b_pl.shape
    dev = b_pl.device
    d_total = t_max + up - 1
    b_pl, l_pl = b_pl.contiguous(), l_pl.contiguous()
    tape = torch.empty((d_total, n, up), dtype=torch.float32, device=dev)
    rcum = torch.empty((d_total, n), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_alpha_f32(
            b_pl.data_ptr(), l_pl.data_ptr(), tape.data_ptr(),
            rcum.data_ptr(), n, t_max, up, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_alpha_f32")
    launches["rnnt_alpha"] += 1
    return tape, rcum


def posteriors(b_pl, l_pl, tape, rcum, il, ul, z_small, z_off):
    """Launch K9 on K8's outputs.  Returns (i_blank, i_label) (N, T, U+1),
    0 at frames t >= il."""
    _check(b_pl, l_pl)
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
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_post_f32(
            b_pl.data_ptr(), l_pl.data_ptr(), tape.data_ptr(),
            rcum.data_ptr(), il.data_ptr(), ul.data_ptr(), zs.data_ptr(),
            zo.data_ptr(), gb.data_ptr(), gl.data_ptr(), n, t_max, up,
            _stream(dev))
    cuda_build.check(status, "e2e_rnnt_post_f32")
    launches["rnnt_posteriors"] += 1
    return gb, gl

"""CTC loss on the card: the alpha kernel (K1), the beta/occupation
kernel (K2) and the gradient combine of csrc/ctc_loss.cu, bound as one
autograd function.

Port of `end2end_tpu/ops/ctc_loss_pallas.py`.  `ctc_nll_cuda` takes CUDA
float32 log-probs (T, N, C) and padded (N, S) targets; its forward pass
launches K1 (alpha tape, or one checkpoint row per `checkpoint_every`
frames, and z_hat, norm_end2), its backward pass K2 (gamma, recomputing
alpha per chunk in checkpoint mode) and then the combine (`grad_cuda`, the
card's counterpart of `ctc_loss_plain.nll_grad`: one warp per frame row,
every sum in a fixed order, so the gradient is bit-identical run to run).
It never falls back to the plain version: anything the kernels do not take
raises.

K1's and K2's launch plans (`alpha_plan`, `beta_plan`: states per
thread, threads, ring depth, staged frames, shared bytes) are computed
here and checked by the C entry points.

`launches` counts kernel launches by name (it is the only module state).
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .ctc_loss_plain import nll_from

launches = {"ctc_alpha": 0, "ctc_beta": 0, "ctc_grad": 0}

# A block may use 227 KB of shared memory on the H100.
_SMEM_LIMIT = 232448
_MAX_THREADS = 1024
# K1's states per thread: the fewest, at least ALPHA_STATES, that fit 1024
# threads (tools/ctc_alpha_breakdown.py times 1, 2, 3, 4 and 6 at both
# timed shapes: 2 is the fastest at each); its (ring, staged tape) frames:
# the first pair whose shared memory fits
ALPHA_STATES = 2
STATES = (1, 2, 3, 4, 6, 8, 16)
RINGS = (2, 4, 8)
_RING_TAPE = ((8, 64), (8, 32), (8, 16), (4, 8), (2, 4), (2, 2), (2, 1))
# K2's states per thread: the fewest that fit 1024 threads (even: the even
# states share the blank's emission slot); the (states, ring) pairs
# beta_plan picks for some S <= 5806, the only ones csrc/ctc_loss.cu builds
BETA_STATES = (2, 4, 8, 16)
BETA_KERNELS = ((2, 8), (2, 4), (4, 4), (4, 2), (8, 2), (16, 2))


def beta_smem_bytes(s_max: int) -> int:
    """The shared memory of the K2 that the current one replaced
    (tools/ctc_beta_reference.cu: a beta row, a scratch row, the
    recompute's slots, the lattice; 4 (5L + 38) bytes at L = 2S+1).  It
    sets the largest S the kernels take (5806), which the redesign kept."""
    L = 2 * s_max + 1
    return 4 * (3 * L + 36 + 2 * L + 2)


def _whole_warps(L: int, r: int) -> int:
    return -(-(-(-L // r)) // 32) * 32


def alpha_plan(s_max: int, states: int | None = None,
               ring: int | None = None, tape: int | None = None) -> dict:
    """K1's launch at L = 2 s_max + 1 states: `states` a thread (R, by
    default the fewest >= ALPHA_STATES that fit), `threads` (whole warps
    over ceil(L/R), at most 1024), `ring` (frames
    of emissions copied ahead: 2, 4 or 8), `tape` (frames of tape rows
    staged between stores) and `smem`, the bytes of the step's slots (6
    floats a warp), the ring, the staged rows and their norms.  By default
    the first (ring, tape) of (8, 64), (8, 32), (8, 16), (4, 8), (2, 4),
    (2, 2), (2, 1) that fits.  Raises where K2's lattice does not fit
    shared memory (the same limit for the pair), and on a plan that does
    not hold."""
    if beta_smem_bytes(s_max) > _SMEM_LIMIT:
        raise ValueError(f"S={s_max} labels: the lattice does not fit the "
                         "kernels' shared memory")
    L = 2 * s_max + 1
    if states is None:
        states = next(r for r in STATES if r >= ALPHA_STATES
                      and _whole_warps(L, r) <= _MAX_THREADS)
    threads = _whole_warps(L, states)
    if states not in STATES or threads > _MAX_THREADS:
        raise ValueError(f"K1 takes {STATES} states a thread within "
                         f"{_MAX_THREADS} threads, got {states} at L={L}")

    def nbytes(r, f):
        return 4 * (6 * (threads // 32) + (r + f) * states * threads + f)

    fits = next((p for p in _RING_TAPE if nbytes(*p) <= _SMEM_LIMIT), (2, 1))
    ring, tape = ring or fits[0], tape or fits[1]
    if ring not in RINGS or tape < 1 or nbytes(ring, tape) > _SMEM_LIMIT:
        raise ValueError(f"K1's ring of {ring} and {tape} staged frames do "
                         "not fit")
    return {"states": states, "threads": threads, "ring": ring,
            "tape": tape, "smem": nbytes(ring, tape)}


def beta_smem(states: int, threads: int, ring: int, tape: int) -> int:
    """K2's shared bytes: the step's slot rows (16 floats a warp), the
    recompute's (8), the input ring (a thread's stage: its emissions,
    states / 2 + 1 with the blank shared when `states` is even, else
    `states`, and `states` alpha entries, padded to a multiple of 4
    floats), the staged gamma rows (`states` a thread a frame) and the
    alpha norms (2 ring ints)."""
    emissions = states if states % 2 else states // 2 + 1
    stage = (emissions + states + 3) // 4 * 4
    return 4 * (24 * (threads // 32) + ring * stage * threads
                + tape * states * threads + 2 * ring)


def beta_plan(s_max: int) -> dict:
    """K2's launch at L = 2 s_max + 1 states, a function of s_max alone:
    `states` a thread (R, the fewest of BETA_STATES that fit 1024
    threads), `threads` (whole warps over ceil(L/R)), `ring` (frames of
    emissions and alpha entries copied ahead) and `tape` (frames of gamma
    staged between stores), the first pair of (8, 64), (8, 32), (8, 16),
    (4, 8), (2, 4), (2, 2), (2, 1) that fits, and `smem` (beta_smem).
    Raises where alpha_plan does (S > 5806)."""
    alpha_plan(s_max)
    L = 2 * s_max + 1
    states = next(r for r in BETA_STATES
                  if _whole_warps(L, r) <= _MAX_THREADS)
    threads = _whole_warps(L, states)
    ring, tape = next(p for p in _RING_TAPE
                      if beta_smem(states, threads, *p) <= _SMEM_LIMIT)
    return {"states": states, "threads": threads, "ring": ring,
            "tape": tape, "smem": beta_smem(states, threads, ring, tape)}


def log1p_mismatches(lo: int = 0, hi: int = 0x40800000) -> int:
    """On the card: how many floats with bits in [lo, hi) (by default
    [0, 4)) K2's branch-free log1p gives other bits for than libm's
    log1pf; 0 is what K2's bit-equality rests on.  Raises unless every
    float of the range was checked."""
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    lib, _ = cuda_build.library()
    cuda_build.check(lib.e2e_ctc_log1p_check(lo, hi, out.data_ptr(),
                                             _stream(out.device)),
                     "e2e_ctc_log1p_check")
    bad, seen = out.tolist()
    if seen != hi - lo:
        raise RuntimeError(f"log1p check saw {seen} of {hi - lo} floats")
    return bad


def _check(log_probs, targets, every):
    if not log_probs.is_cuda:
        raise ValueError(
            f"the CUDA CTC kernels need a CUDA tensor, got {log_probs.device}")
    if log_probs.dtype != torch.float32:
        raise ValueError(
            f"the CUDA CTC kernels are float32-only, got {log_probs.dtype}")
    if log_probs.ndim != 3 or targets.ndim != 2:
        raise ValueError("need (T, N, C) log_probs and (N, S) targets, got "
                         f"{tuple(log_probs.shape)} and {tuple(targets.shape)}")
    if targets.shape[0] != log_probs.shape[1]:
        raise ValueError("targets and log_probs disagree on the batch size")
    if every < 0:
        raise ValueError(f"checkpoint_every must be >= 0, got {every}")
    return alpha_plan(targets.shape[1])


def _i32(x, dev):
    return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def alpha_cuda(log_probs, targets, input_lengths, target_lengths, blank=0,
               every=0, **plan):
    """Launch K1.  Returns (z_hat (N,), norm_end2 (N,) int32, alpha, anorm2)
    with alpha/anorm2 the tape (T, N, L)/(T, N) or, with every = K > 0,
    the chunk-start carries (ceil(T/K), N, L)/(ceil(T/K), N).  `plan`
    (states, ring, tape) overrides alpha_plan's choices; the outputs do
    not change."""
    _check(log_probs, targets, every)
    plan = alpha_plan(targets.shape[1], **plan)
    dev = log_probs.device
    t_max, n, v = log_probs.shape
    s_max = targets.shape[1]
    L = 2 * s_max + 1
    lp = log_probs.contiguous()
    tgt, il, tl = (_i32(x, dev) for x in (targets, input_lengths,
                                          target_lengths))
    rows = -(-t_max // every) if every else t_max
    alpha = torch.empty((rows, n, L), dtype=torch.float32, device=dev)
    anorm2 = torch.empty((rows, n), dtype=torch.int32, device=dev)
    z_hat = torch.empty(n, dtype=torch.float32, device=dev)
    norm_end2 = torch.empty(n, dtype=torch.int32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_ctc_alpha_f32(
            lp.data_ptr(), tgt.data_ptr(), il.data_ptr(), tl.data_ptr(),
            alpha.data_ptr(), anorm2.data_ptr(), z_hat.data_ptr(),
            norm_end2.data_ptr(), t_max, n, v, s_max, blank, every,
            plan["states"], plan["threads"], plan["ring"], plan["tape"],
            plan["smem"], _stream(dev))
    cuda_build.check(status, "e2e_ctc_alpha_f32")
    launches["ctc_alpha"] += 1
    return z_hat, norm_end2, alpha, anorm2


def beta_cuda(log_probs, targets, input_lengths, target_lengths, alpha,
              anorm2, z_hat, norm_end2, blank=0, every=0):
    """Launch K2 on alpha_cuda's outputs (same `every`), at beta_plan.
    Returns gamma (T, N, L): the state occupations, 0 on invalid states,
    at t >= il and where z is not finite."""
    _check(log_probs, targets, every)
    plan = beta_plan(targets.shape[1])
    dev = log_probs.device
    t_max, n, v = log_probs.shape
    s_max = targets.shape[1]
    L = 2 * s_max + 1
    lp = log_probs.contiguous()
    tgt, il, tl = (_i32(x, dev) for x in (targets, input_lengths,
                                          target_lengths))
    gamma = torch.empty((t_max, n, L), dtype=torch.float32, device=dev)
    abuf = torch.empty((n, every, L), dtype=torch.float32, device=dev)
    nbuf = torch.empty((n, every), dtype=torch.int32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_ctc_beta_f32(
            lp.data_ptr(), tgt.data_ptr(), il.data_ptr(), tl.data_ptr(),
            alpha.data_ptr(), anorm2.data_ptr(), z_hat.data_ptr(),
            norm_end2.data_ptr(), gamma.data_ptr(), abuf.data_ptr(),
            nbuf.data_ptr(), t_max, n, v, s_max, blank, every,
            *(plan[k] for k in ("states", "threads", "ring", "tape",
                                "smem")), _stream(dev))
    cuda_build.check(status, "e2e_ctc_beta_f32")
    launches["ctc_beta"] += 1
    return gamma


def grad_cuda(log_probs, targets, input_lengths, target_lengths, gamma, g,
              blank=0):
    """Launch the combine on K2's gamma (T, N, L): d(sum_n g_n nll_n) /
    d log_probs = (exp(lp) - posterior) * [t < il] * g, (T, N, C) float32;
    `ctc_loss_plain.nll_grad`'s value, its sums in another fixed order."""
    _check(log_probs, targets, 0)
    dev = log_probs.device
    t_max, n, v = log_probs.shape
    lp = log_probs.contiguous()
    tgt, il, tl = (_i32(x, dev) for x in (targets, input_lengths,
                                          target_lengths))
    gam = gamma.contiguous()
    gn = g.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty_like(lp)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_ctc_grad_f32(
            lp.data_ptr(), gam.data_ptr(), tgt.data_ptr(), il.data_ptr(),
            tl.data_ptr(), gn.data_ptr(), out.data_ptr(), t_max, n, v,
            targets.shape[1], blank, _stream(dev))
    cuda_build.check(status, "e2e_ctc_grad_f32")
    launches["ctc_grad"] += 1
    return out


class _CTCNllCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, targets, input_lengths, target_lengths,
                blank, every):
        z_hat, norm_end2, alpha, anorm2 = alpha_cuda(
            log_probs, targets, input_lengths, target_lengths, blank, every)
        ctx.blank, ctx.every = blank, every
        ctx.save_for_backward(log_probs, targets, input_lengths,
                              target_lengths, alpha, anorm2, z_hat,
                              norm_end2)
        return nll_from(z_hat, norm_end2)

    @staticmethod
    def backward(ctx, g):
        (log_probs, targets, il, tl, alpha, anorm2, z_hat,
         norm_end2) = ctx.saved_tensors
        gamma = beta_cuda(log_probs, targets, il, tl, alpha, anorm2, z_hat,
                          norm_end2, ctx.blank, ctx.every)
        grad = grad_cuda(log_probs, targets, il, tl, gamma, g, ctx.blank)
        return grad, None, None, None, None, None


def ctc_nll_cuda(log_probs, targets, input_lengths, target_lengths,
                 blank: int = 0, checkpoint_every: int = 0):
    """Per-sample CTC NLL (N,) through K1/K2; differentiable wrt log_probs.
    CUDA float32 log-probs only (raises otherwise)."""
    ints = (_i32(x, log_probs.device)
            for x in (targets, input_lengths, target_lengths))
    return _CTCNllCuda.apply(log_probs, *ints, blank, int(checkpoint_every))

"""CTC prefix beam search: the per-frame beam step (with its LM modes) and
the backtrace.

Port of `end2end_tpu/ops/beam_search_pallas.py`.  Inputs are the natural
top-k output, (T, N, ks), with no transpose to the TPU's (T, ks, B) layout
and no 128-lane padding.

  * `beam_step(lpk, ck, lpb, il, W, K, s_cap, blank, inc=, cls_map=,
    state_in=)` runs every frame of the batch and returns backpointer
    codes, final scores, last tokens and the 10-field beam state: on a
    CUDA tensor the hand-written kernel in `csrc/beam_step.cu`, on a CPU
    tensor `beam_step_plain`.
  * `backtrace(...)` turns the codes into token and time matrices, ranked
    by score: on a CUDA tensor one launch of the kernel in
    `csrc/backtrace.cu` (the lane walk and the compaction), on a CPU
    tensor `backtrace_plain` (a host walk, one gather a frame, then a
    handful of whole-tensor torch ops).  `lane_walk` (the chunked LM
    decode's boundary: each path's ancestor lane and its ids frame by
    frame) routes the same way, to the same file's other kernel or to
    `lane_walk_plain`.

Semantics are the TPU kernel's (see the note at the top of
`csrc/beam_step.cu`): extensions come from the first K slots, the repeat
("stay") term reads the whole ks-slot window, codes are `w` for the stay of
beam w and `W + w*K + k` for extending beam w by slot k.  At K = V this is
exactly the plain CTC prefix beam search.  The LM modes:

  * `inc` (C, V) float32, `alpha * log p_LM(token | context) + beta`: each
    extension's increment, read at the beam's context row (its last symbol,
    or with `cls_map` (V,) int32 its last symbol's class; row C-1 for the
    empty prefix).  Each beam carries its accumulated bonus `lm`, which
    ranks candidates (acoustic + lm) without entering the acoustic mass.
  * `state_in`: resume from a carried state (the chunked LM decode) instead
    of the empty prefix; candidates then rank with their parent's carried
    bonus even without `inc`.

The state is a 10-tuple of (W, N) tensors in the TPU kernel's field order
`pb pnb h1 h2 hp1 hp2 last len lm lcls` (float32 for pb, pnb, lm; int32
otherwise); `beam_state_init` is the empty prefix.

Launch counts (the only module state): `launches` counts every launch of
the beam kernel; `launches_lm`, `launches_cls` and `launches_resume` count
the launches that ran the symbol-keyed increments (K5), the class-keyed
increments (K6) and the resume mode (K7); `launches_backtrace` and
`launches_walk` the launches of the backtrace kernel and of the lane-walk
kernel.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from .semiring import LOG0, LOG0_THRESHOLD, logaddexp2

launches = 0
launches_lm = 0
launches_cls = 0
launches_resume = 0
launches_backtrace = 0
launches_walk = 0

MAX_BEAM_WIDTH = 32
MAX_PRUNE_K = 128
MAX_CTX_ROWS = 64  # context rows of an LM increment table (the TPU's cap)

# Rolling prefix hashes: 32-bit with wraparound (the TPU kernel's int32).
_M1 = 2654435761
_M2 = 0x85EBCA6B
_SEED1, _SEED2 = 1, 7
_DEADBASE = 0x7EAD0000
_NOPARENT = 0x5EED0000  # parent-prefix hash that matches nothing

N_STATE = 10
_FLOAT_FIELDS = (0, 1, 8)  # pb, pnb, lm; the other fields are int32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the signed value of its low 32 bits (int32 wraparound)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x)


def beam_supported(beam_width: int, prune_k: int, dtype) -> tuple[bool, str]:
    """(ok, reason): whether the beam step covers this configuration (the
    no-LM envelope of the TPU kernel's `beam_pallas_supported`)."""
    if beam_width > MAX_BEAM_WIDTH:
        return False, f"beam search supports beam_width <= {MAX_BEAM_WIDTH}"
    if prune_k > MAX_PRUNE_K:
        return False, f"beam search supports prune_k <= {MAX_PRUNE_K}"
    if dtype != torch.float32:
        return False, "beam search is float32-only"
    return True, ""


def lm_fusion_supported(lm, v: int, beam_width: int) -> tuple[bool, str]:
    """(ok, reason): whether the kernel's in-kernel LM mode (K5) takes this
    LM: a dense bigram `NGramLM` over the lattice's vocabulary with
    V + 1 <= 64 context rows, beam_width <= 32 (the TPU kernel's
    envelope, `beam_pallas_supported`)."""
    from .lm import NGramLM

    if not isinstance(lm, NGramLM):
        return False, ("in-kernel LM fusion supports dense bigram NGramLM "
                       "only")
    if lm._v != v:
        return False, f"LM vocab ({lm._v}) != lattice vocab ({v})"
    if lm._v + 1 > MAX_CTX_ROWS:
        return False, (f"in-kernel LM fusion supports vocab + 1 <= "
                       f"{MAX_CTX_ROWS} context rows (got {lm._v + 1})")
    if beam_width > MAX_BEAM_WIDTH:
        return False, (f"in-kernel LM fusion supports beam_width <= "
                       f"{MAX_BEAM_WIDTH}")
    return True, ""


def check_lm_device(lm, device) -> None:
    """An LM's (or guide's) tables must live where the lattice does."""
    if lm is not None and lm.device != device:
        raise ValueError(f"the LM's tables are on {lm.device}, the "
                         f"log-probs on {device}: build the LM with "
                         f"device={device.type!r}")


def apply_token_min_logp(lpk, ck, token_min_logp):
    """Drop top-k slots whose log-prob is below `token_min_logp`, always
    keeping each frame's best slot.  Dropped slots become (LOG0, id -1),
    which the beam step treats as no candidate."""
    if token_min_logp is None:
        return lpk, ck
    keep = lpk >= token_min_logp
    keep[..., 0] = True
    return (torch.where(keep, lpk, LOG0),
            torch.where(keep, ck, -1).to(ck.dtype))


def beam_state_init(W: int, n: int, device=None):
    """The empty-prefix state, bit-identical to the kernel's own: beam 0
    live with pb = 0, the others dead with slot-unique hashes."""
    w = torch.arange(W, device=device)[:, None].expand(W, n)
    live0 = w == 0
    i32 = torch.int32
    return (
        torch.where(live0, 0.0, LOG0).float(),                       # pb
        torch.full((W, n), LOG0, device=device),                     # pnb
        torch.where(live0, _SEED1, _DEADBASE + w).to(i32),           # h1
        torch.where(live0, _SEED2, _DEADBASE + w).to(i32),           # h2
        (_NOPARENT + w).to(i32),                                     # hp1
        (_NOPARENT + w).to(i32),                                     # hp2
        torch.full((W, n), -1, dtype=i32, device=device),            # last
        torch.zeros((W, n), dtype=i32, device=device),               # len
        torch.zeros((W, n), device=device),                          # lm
        torch.full((W, n), -1, dtype=i32, device=device),            # lcls
    )


def beam_step_plain(lpk, ck, lpb, il, W: int, K: int, s_cap: int,
                    blank: int, inc=None, cls_map=None, state_in=None):
    """Plain version of the beam kernel: a loop over T, vectorised over
    (N, W, K).

    lpk (T, N, ks) f32 and ck (T, N, ks) int top-k log-probs and ids; lpb
    (T, N) blank log-probs; il (N,) frame counts; inc, cls_map, state_in
    as in the module docstring.  Returns bp (T, W, N) int32 codes, score
    (W, N) f32 final log p(prefix) plus the carried bonus, last (W, N)
    int32 and the final state.
    """
    t_max, n, ks = lpk.shape
    dev = lpk.device
    _check_lm_args(inc, cls_map, dev)
    ck = ck.long()
    il = il.to(dev).long()
    st = beam_state_init(W, n, dev) if state_in is None else state_in
    pb, pnb, h1, h2, hp1, hp2, last, lens, lm, lcls = (
        x.T.float() if i in _FLOAT_FIELDS else x.T.long()
        for i, x in enumerate(st))  # (N, W)
    w_idx = torch.arange(W, device=dev).expand(n, W)
    log0 = torch.tensor(LOG0, dtype=torch.float32, device=dev)
    bp = torch.empty((t_max, n, W), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    if inc is not None:
        n_ctx, v = inc.shape
        inc_flat = inc.reshape(-1)

    def pick(x, i):  # x (N, W), i (N,) -> x[n, i[n]]
        return x[rows, i]

    for t in range(t_max):
        lpk_t, ck_t, lpb_t = lpk[t], ck[t], lpb[t]
        total = logaddexp2(pb, pnb)
        # stay: repeat-last read over the whole ks window
        same_all = ck_t[:, None, :] == last[:, :, None]  # (N, W, ks)
        rep = torch.where(same_all, lpk_t[:, None, :], log0).amax(-1)
        pb_stay = total + lpb_t[:, None]
        pnb_stay = torch.where(last >= 0, pnb + rep, log0)
        # extensions from the first K slots
        lpk3, ck3 = lpk_t[:, None, :K], ck_t[:, None, :K]  # (N, 1, K)
        same = ck3 == last[:, :, None]  # (N, W, K)
        ext = torch.where(same, pb[..., None], total[..., None]) + lpk3
        ok = (ck3 >= 0) & (ck3 != blank) & (lens[..., None] < s_cap)
        ext = torch.where(ok, ext, log0)
        # each extension's carried bonus: parent's + its LM increment
        if inc is None:
            lm_ext = lm[..., None].expand(n, W, K)
        else:
            ctx = torch.where(last >= 0, lcls if cls_map is not None
                              else last, n_ctx - 1)
            col = ck3.clamp(0, v - 1)
            lm_ext = lm[..., None] + inc_flat[ctx[..., None] * v + col]
        # merge: beam w absorbs its parent p's extension by last[w]
        bm = ((h1[:, None, :] == hp1[:, :, None])
              & (h2[:, None, :] == hp2[:, :, None])
              & (lens[:, None, :] < s_cap))  # (N, w, p)
        base = torch.where(last[:, None, :] == last[:, :, None],
                           pb[:, None, :], total[:, None, :])
        val = torch.where(bm, base, 0.0).sum(-1)
        hit = bm.any(-1)
        add = torch.where(hit & (rep > LOG0_THRESHOLD)
                          & (val > LOG0_THRESHOLD), val + rep, log0)
        rm = (bm[..., None]
              & (ck3[:, None, :, :] == last[:, :, None, None])).any(1) & ok
        ext = torch.where(rm, log0, ext)
        pnb_stay = logaddexp2(pnb_stay, add)
        stay = logaddexp2(pb_stay, pnb_stay)
        # top-W by repeated argmax over codes [stay 0..W-1, ext W + w*K + k]
        # of acoustic + bonus; the acoustic mass is picked separately
        cand = torch.cat([stay + lm, (ext + lm_ext).reshape(n, W * K)], 1)
        acoustic = torch.cat([pnb_stay, ext.reshape(n, W * K)], 1)
        bonus = torch.cat([lm, lm_ext.reshape(n, W * K)], 1)
        if cls_map is not None:
            cls_ext = cls_map.long()[col].expand(n, W, K)
            klass = torch.cat([lcls, cls_ext.reshape(n, W * K)], 1)
        cols = []
        for w_out in range(W):
            code = cand.argmax(dim=1)  # first index among equal maxima
            mx = cand[rows, code]
            cand[rows, code] = log0
            is_stay = code < W
            parent = torch.where(is_stay, code, (code - W) // K)
            tok = ck_t[rows, torch.where(is_stay, 0, (code - W) % K)]
            h1p, h2p = pick(h1, parent), pick(h2, parent)
            lenp = pick(lens, parent)
            dead = mx <= LOG0_THRESHOLD
            new = (
                torch.where(is_stay, pick(pb_stay, parent), log0),
                acoustic[rows, code],
                torch.where(is_stay, h1p, _wrap32(h1p * _M1 + tok + 1)),
                torch.where(is_stay, h2p, _wrap32(h2p * _M2 + tok + 1)),
                torch.where(is_stay, pick(hp1, parent), h1p),
                torch.where(is_stay, pick(hp2, parent), h2p),
                torch.where(is_stay, pick(last, parent), tok),
                torch.where(is_stay, lenp, lenp + 1),
                bonus[rows, code],
                klass[rows, code] if cls_map is not None else lcls[:, w_out],
            )
            # a pick at log-zero carries no state: no mass, unique hashes
            dead_vals = (LOG0, LOG0, _DEADBASE + w_out, _DEADBASE + w_out,
                         _NOPARENT + w_out, _NOPARENT + w_out, -1, 0, 0.0,
                         -1 if cls_map is not None else lcls[:, w_out])
            cols.append([torch.where(dead, d, x)
                         for x, d in zip(new, dead_vals)] + [code])
        *fields, codes = (torch.stack(f, dim=1) for f in zip(*cols))
        upd = (t < il)[:, None]  # freeze past each sample's length
        pb, pnb, h1, h2, hp1, hp2, last, lens, lm, lcls = (
            torch.where(upd, new_f, old) for new_f, old in zip(
                fields, (pb, pnb, h1, h2, hp1, hp2, last, lens, lm, lcls)))
        bp[t] = torch.where(upd, codes, w_idx).to(torch.int32)
    score = logaddexp2(pb, pnb) + lm
    state = tuple(
        x.T.contiguous() if i in _FLOAT_FIELDS
        else x.T.to(torch.int32).contiguous()
        for i, x in enumerate((pb, pnb, h1, h2, hp1, hp2, last, lens, lm,
                               lcls)))
    bp = bp.permute(0, 2, 1).contiguous()
    return bp, score.T.contiguous(), state[6], state


def _check_lm_args(inc, cls_map, dev):
    """Validate the increment table and class map for the kernel."""
    if inc is None:
        if cls_map is not None:
            raise ValueError("beam_step: cls_map needs an inc table")
        return
    if (inc.device != dev or inc.dtype != torch.float32 or inc.dim() != 2
            or not 1 <= inc.shape[0] <= MAX_CTX_ROWS):
        raise ValueError(f"beam_step: inc must be a float32 (C, V) "
                         f"tensor on {dev} with C <= {MAX_CTX_ROWS}, got "
                         f"{inc.dtype} {tuple(inc.shape)} on {inc.device}")
    if cls_map is not None and (
            cls_map.device != dev or cls_map.dtype != torch.int32
            or tuple(cls_map.shape) != (inc.shape[1],)):
        raise ValueError(f"beam_step: cls_map must be int32 "
                         f"({inc.shape[1]},) on {dev}")


def beam_step_cuda(lpk, ck, lpb, il, W: int, K: int, s_cap: int,
                   blank: int, inc=None, cls_map=None, state_in=None):
    """Launch the CUDA beam kernel; same contract as `beam_step_plain`."""
    global launches, launches_lm, launches_cls, launches_resume
    t_max, n, ks = lpk.shape
    for name, x, dtype, shape in (
            ("lpk", lpk, torch.float32, (t_max, n, ks)),
            ("ck", ck, torch.int32, (t_max, n, ks)),
            ("lpb", lpb, torch.float32, (t_max, n)),
            ("il", il, torch.int32, (n,))):
        if not x.is_cuda or x.device != lpk.device:
            raise ValueError(f"beam_step_cuda: {name} must be on "
                             f"{lpk.device} (CUDA), got {x.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"beam_step_cuda: {name} must be {dtype} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if not (1 <= W <= MAX_BEAM_WIDTH and 1 <= K <= MAX_PRUNE_K
            and K <= ks <= K + 8):
        raise ValueError(f"beam_step_cuda: unsupported W={W}, K={K}, "
                         f"ks={ks}")
    dev = lpk.device
    _check_lm_args(inc, cls_map, dev)
    lpk, ck, lpb, il = (x.contiguous() for x in (lpk, ck, lpb, il))
    packed_in = None
    if state_in is not None:
        if len(state_in) != N_STATE or any(
                tuple(x.shape) != (W, n) or x.device != dev
                or x.dtype != (torch.float32 if i in _FLOAT_FIELDS
                               else torch.int32)
                for i, x in enumerate(state_in)):
            raise ValueError(f"beam_step_cuda: state_in must be "
                             f"{N_STATE} (W, N) = ({W}, {n}) tensors on "
                             f"{dev} (see beam_state_init)")
        packed_in = torch.stack([x.view(torch.int32) for x in state_in])
    bp = torch.empty((t_max, W, n), dtype=torch.int32, device=dev)
    score = torch.empty((W, n), dtype=torch.float32, device=dev)
    packed_out = torch.empty((N_STATE, W, n), dtype=torch.int32, device=dev)
    n_ctx, v = (0, 0) if inc is None else inc.shape
    inc_c = None if inc is None else inc.contiguous()
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.e2e_beam_step_f32(
            lpk.data_ptr(), ck.data_ptr(), lpb.data_ptr(), il.data_ptr(),
            None if inc_c is None else inc_c.data_ptr(),
            None if cls_map is None else cls_map.data_ptr(),
            None if packed_in is None else packed_in.data_ptr(),
            bp.data_ptr(), score.data_ptr(), packed_out.data_ptr(),
            t_max, n, ks, W, K, s_cap, blank, n_ctx, v, stream)
    cuda_build.check(status, "e2e_beam_step_f32")
    launches += 1
    if inc is not None:
        if cls_map is None:
            launches_lm += 1
        else:
            launches_cls += 1
    if state_in is not None:
        launches_resume += 1
    state = tuple(x.view(torch.float32) if i in _FLOAT_FIELDS else x
                  for i, x in enumerate(packed_out.unbind(0)))
    return bp, score, state[6], state


def beam_step(lpk, ck, lpb, il, W: int, K: int, s_cap: int, blank: int,
              inc=None, cls_map=None, state_in=None):
    """All frames' beam steps: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (bp (T, W, N), score (W, N),
    last (W, N), state)."""
    if lpk.is_cuda:
        return beam_step_cuda(lpk, ck, lpb, il, W, K, s_cap, blank, inc,
                              cls_map, state_in)
    if lpk.device.type != "cpu":
        raise ValueError(f"beam_step: unsupported device {lpk.device}")
    return beam_step_plain(lpk, ck, lpb, il, W, K, s_cap, blank, inc,
                           cls_map, state_in)


def _host_walk(bp, ck, W: int, K: int):
    """The reverse pointer walk over backpointer codes bp (T, W, N), one
    gather a frame: for every final beam, the lane it occupied after each
    frame and what its path took there.  Returns lane0 (N, W), the lane it
    descends from before frame 0, emit (T, N, W), whether it emitted at t,
    and ch (T, N, W) int64, the id of ck (T, N, ks) it emitted there."""
    t_max, _, n = bp.shape
    code = bp.permute(0, 2, 1).long()
    parent = torch.where(code < W, code, (code - W) // K)
    lane_after = torch.empty_like(code)
    lane = torch.arange(W, device=bp.device).expand(n, W)
    for t in range(t_max - 1, -1, -1):
        lane_after[t] = lane
        lane = parent[t].gather(1, lane)
    code_sel = code.gather(2, lane_after)
    emit = code_sel >= W
    slot = torch.where(emit, (code_sel - W) % K, 0)
    return lane, emit, ck.long().gather(2, slot)


def lane_walk_plain(bp, ck, W: int, K: int):
    """Each final beam's path through bp (T, W, N) codes with ck (T, N, ks)
    top-k ids, by the host walk (the plain version of the lane-walk
    kernel).  Returns lane0 (N, W), the lane it descends from before frame
    0, toks (N, W, T) int64, the id it emitted at each frame (-1 where it
    emitted nothing), and n_emit (N, W), how many it emitted."""
    lane0, emit, ch = _host_walk(bp, ck, W, K)
    toks = torch.where(emit, ch, -1).permute(1, 2, 0)
    return lane0, toks, emit.sum(dim=0)


def lane_walk_cuda(bp, ck, W: int, K: int):
    """The lane walk as one launch of the lane-walk kernel in
    `csrc/backtrace.cu`; bp (T, W, N) int32 and ck (T, N, ks) on a CUDA
    device, same returns as `lane_walk_plain`."""
    global launches_walk
    t_max, _, n = bp.shape
    dev = bp.device
    if not (bp.is_cuda and bp.dtype == torch.int32 and bp.shape[1] == W
            and ck.device == dev and ck.dim() == 3
            and tuple(ck.shape[:2]) == (t_max, n)):
        raise ValueError(f"lane_walk_cuda: bp must be a CUDA int32 (T, W={W}"
                         f", N) tensor and ck (T, N, ks) on its device; got "
                         f"bp {bp.dtype} {tuple(bp.shape)} on {bp.device}, "
                         f"ck {tuple(ck.shape)} on {ck.device}")
    if not (1 <= W <= MAX_BEAM_WIDTH and 1 <= K <= MAX_PRUNE_K
            and ck.shape[2] >= K and t_max < 2**24):
        raise ValueError(f"lane_walk_cuda: unsupported W={W}, K={K}, "
                         f"ks={ck.shape[2]}, T={t_max}")
    bp = bp.contiguous()
    ck = ck.to(torch.int32).contiguous()
    took = torch.empty((t_max, n, W), dtype=torch.int32, device=dev)
    toks = torch.empty((n, W, t_max), dtype=torch.int64, device=dev)
    lane0 = torch.empty((n, W), dtype=torch.int64, device=dev)
    n_emit = torch.empty_like(lane0)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.e2e_lane_walk(
            bp.data_ptr(), ck.data_ptr(), took.data_ptr(), toks.data_ptr(),
            lane0.data_ptr(), n_emit.data_ptr(), t_max, n, W, K, ck.shape[2],
            stream)
    cuda_build.check(status, "e2e_lane_walk")
    launches_walk += 1
    return lane0, toks, n_emit


def lane_walk(bp, ck, W: int, K: int):
    """(lane0, toks, n_emit) of `lane_walk_plain`: the kernel for CUDA
    tensors, the host walk for CPU ones."""
    if bp.is_cuda:
        return lane_walk_cuda(bp, ck, W, K)
    if bp.device.type != "cpu":
        raise ValueError(f"lane_walk: unsupported device {bp.device}")
    return lane_walk_plain(bp, ck, W, K)


def backtrace_plain(bp, ck, scores, W: int, K: int, s_cap: int):
    """Token and time matrices from backpointer codes, best beam first (the
    plain version of the backtrace kernel).

    bp (T, W, N) codes; ck (T, N, ks) top-k ids; scores (W, N).  The host
    walk finds, for every final beam, the lane it occupied after each
    frame; emissions along that path are then compacted with a cumsum
    scatter (emissions past s_cap land on its last slot, the last one
    there).  Returns tokens (N, W, s_cap) int32 (-1 pad), lengths (N, W)
    int32, scores (N, W) f32 (-inf for dead beams), times (N, W, s_cap)
    int32 emission frames (-1 pad).
    """
    t_max, _, n = bp.shape
    dev = bp.device
    _, emit, ch = _host_walk(bp, ck, W, K)
    pos = torch.cumsum(emit.long(), dim=0) - 1
    lens = torch.clamp(pos[-1] + 1, max=s_cap)
    idx = torch.where(emit, torch.clamp(pos, max=s_cap - 1), s_cap)
    idx = idx.permute(1, 2, 0)  # (N, W, T); non-emits go to spare slot s_cap
    frames = torch.arange(t_max, device=dev)[:, None, None].expand_as(emit)
    out = []
    for payload in (ch, frames):
        m = torch.full((n, W, s_cap + 1), -1, dtype=torch.int32, device=dev)
        src = torch.where(emit, payload, -1).permute(1, 2, 0)
        out.append(m.scatter_(2, idx, src.to(torch.int32))[:, :, :s_cap])
    tokens, times = out
    sc = scores.T
    sc = torch.where(sc > LOG0_THRESHOLD, sc, float("-inf"))
    sc, order = torch.sort(sc, dim=1, descending=True, stable=True)
    tokens = tokens.gather(1, order[:, :, None].expand_as(tokens))
    times = times.gather(1, order[:, :, None].expand_as(times))
    lens = lens.gather(1, order).to(torch.int32)
    return tokens, lens, sc, times


def backtrace_cuda(bp, ck, scores, W: int, K: int, s_cap: int):
    """The backtrace as one launch of the kernel in `csrc/backtrace.cu`
    (the lane walk with the compaction); CUDA tensors, same returns as
    `backtrace_plain`."""
    global launches_backtrace
    t_max, _, n = bp.shape
    dev = bp.device
    if not (bp.is_cuda and bp.dtype == torch.int32 and bp.shape[1] == W
            and ck.device == dev and ck.dim() == 3
            and tuple(ck.shape[:2]) == (t_max, n) and scores.device == dev
            and scores.dtype == torch.float32
            and tuple(scores.shape) == (W, n)):
        raise ValueError(f"backtrace_cuda: bp must be a CUDA int32 (T, W={W}"
                         f", N) tensor, ck (T, N, ks) and scores float32 "
                         f"(W, N) on its device; got bp {bp.dtype} "
                         f"{tuple(bp.shape)} on {bp.device}, ck "
                         f"{tuple(ck.shape)} on {ck.device}, scores "
                         f"{scores.dtype} {tuple(scores.shape)} on "
                         f"{scores.device}")
    if not (1 <= W <= MAX_BEAM_WIDTH and 1 <= K <= MAX_PRUNE_K
            and ck.shape[2] >= K and 1 <= t_max < 2**24
            and 1 <= s_cap < 2**24):
        raise ValueError(f"backtrace_cuda: unsupported W={W}, K={K}, "
                         f"ks={ck.shape[2]}, T={t_max}, s_cap={s_cap}")
    bp = bp.contiguous()
    ck = ck.to(torch.int32).contiguous()
    scores = scores.contiguous()
    rev = torch.empty((n, W, t_max), dtype=torch.int32, device=dev)
    tokens = torch.empty((n, W, s_cap), dtype=torch.int32, device=dev)
    times = torch.empty_like(tokens)
    lens = torch.empty((n, W), dtype=torch.int32, device=dev)
    sc = torch.empty((n, W), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.e2e_backtrace(
            bp.data_ptr(), ck.data_ptr(), scores.data_ptr(), rev.data_ptr(),
            tokens.data_ptr(), times.data_ptr(), lens.data_ptr(),
            sc.data_ptr(), t_max, n, W, K, ck.shape[2], s_cap, stream)
    cuda_build.check(status, "e2e_backtrace")
    launches_backtrace += 1
    return tokens, lens, sc, times


def backtrace(bp, ck, scores, W: int, K: int, s_cap: int):
    """Token and time matrices from backpointer codes, best beam first:
    the kernel for CUDA tensors, `backtrace_plain` for CPU ones.  Returns
    tokens (N, W, s_cap) int32 (-1 pad), lengths (N, W) int32, scores
    (N, W) f32 (-inf for dead beams), times (N, W, s_cap) int32 emission
    frames (-1 pad)."""
    if bp.is_cuda:
        return backtrace_cuda(bp, ck, scores, W, K, s_cap)
    if bp.device.type != "cpu":
        raise ValueError(f"backtrace: unsupported device {bp.device}")
    return backtrace_plain(bp, ck, scores, W, K, s_cap)

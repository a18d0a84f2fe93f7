"""The online-softmax fused transducer joint on the card: K10 (forward),
K11 (dh) and K12 (dW, db) of csrc/rnnt_joint.cu, and their
vocabulary-sharded modes K10tp, K11tp, K12tp.

Port of the kernels of `end2end_tpu/ops/rnnt_joint_pallas.py`.
`joint_fwd`, `joint_dh`, `joint_dw` and the `_tp` three have the
signatures of their plain versions in ops/rnnt_joint_plain.py and take
CUDA float32 h (R, J), w (J, V), b (V,), int32 labels y (R,) and, for the
backward, float32 (R,) m, logs, gb, gl, all contiguous; any J >= 1 (above
128 the kernels walk J in 128-row slabs).  The `_tp`
functions run one shard's (J, V/D) slice, with shard-relative blank and
label ids, -1 where another shard owns the column.  Each call rounds h
and W to bf16 once (W zero-padded to a whole number of 128-column tiles)
for the kernels' tensor cores, J padded with zeros to a multiple of 8 for
their 16-byte copies (`_bf16_padded`).  Nothing here falls back to the
plain version: anything the kernels do not take raises.

K10 is bound alike by its bf16 tensor-core work, 2 R J V operations, and
its R V exps (2.03 ms each on an H100 at its max SM clock of 1,980 MHz at
the JAX bench row: R = 259,200, J = 128, V = 32768; 0.51 ms on one of 4
vocabulary shards); K11 and K12 by their tensor-core work, 4 R J V
operations (4.1 ms; 1.0 ms a shard).  All three keep the logits in
wgmma's accumulator registers.  K10 and K11 give each 128-column W tile
to the rows of a block (K11: 128, two warpgroups; K10: 256, four, up to
J = 128, `fwd_rows`) and stream W through a ring of TMA bulk copies;
`w_tiles` lays W out tile by tile in the order of the kernels'
shared-memory stages, so each stage is one contiguous copy, and
`dh_bias` gives them the bias in log2 units (`_tiled` makes all three);
above J = 640 their h tile no longer fits beside the ring, and `h_tiles`
lays h out for it to stream slab by slab with W.  K10's warpgroups run
their exps under each other's products.  K11's sum over V stays in one
block's registers: dh is the same bits run to run.  `fwd_plan` and
`dh_plan` report their resources and, from the kernel's own layout,
whether h streams.  K12's grid
is 256-column V tiles times S row splits; `plan_splits` picks S from the
card's SM count and the kernel's resident blocks per SM (`dw_plan`) so
that the grid fills at least one wave with the last one near full (S = 2
unsharded, 8 per shard at the bench row), and a second kernel adds the S
partial sums in split order, so dW and db are the same bits run to run;
h streams through a cp.async ring.  On an H100 K11 and K12 draw the
card to its 700 W limit at the bench row (PERF.md).  The K12 wrapper
allocates the workspace, S x (J + 1) x V float32, with `torch.empty`.

`launches` counts kernel launches by name (it is the only module state;
K12's second pass counts as part of its launch).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

launches = {"joint_fwd": 0, "joint_dh": 0, "joint_dw": 0,
            "joint_fwd_tp": 0, "joint_dh_tp": 0, "joint_dw_tp": 0}

TILE_V = 128  # vocabulary columns per tile
DW_TILE = 256  # K12's vocabulary columns per block
ROWS = 64     # K12's rows of h per block
DH_ROWS = 128  # K11's rows of h per block
SLAB_J = 128  # J rows per slab above J = 128
LOG2E = 1.4426950408889634


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
    hb, wt, b2, j8, vp = _tiled(h, w, b, fwd_plan(r, j, dev)["h_streams"])
    out = torch.empty((4, r), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_fwd(
            hb.data_ptr(), wt.data_ptr(), b.data_ptr(), b2.data_ptr(),
            y.data_ptr(), *(o.data_ptr() for o in out), r, j8, v, vp, blank,
            int(tp), _stream(dev))
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


def _bf16_padded(h, w, v):
    """h and W as the backward kernels take them: bf16, J padded with zeros
    to a multiple of 8 (their 16-byte copies) and W's columns to Vp, a
    whole number of 128-column tiles.  Returns (hb (R, J8), wb (J8, Vp),
    J8, Vp)."""
    j = h.shape[1]
    j8 = -(-j // 8) * 8
    hb = h.to(torch.bfloat16)
    wb, vp = _bf16_w(w, v)
    if j8 != j:
        hb = torch.nn.functional.pad(hb, (0, j8 - j))
        wb = torch.nn.functional.pad(wb, (0, 0, 0, j8 - j))
    return hb, wb, j8, vp


def w_tiles(wb, jw):
    """K11's W: the bf16 (J8, Vp) W in the order of its shared-memory W
    stages, so that each stage is one contiguous copy.  Rows are padded with
    zeros to jw; then, tile by tile (128 columns), the 8 x 8 core matrices
    of rows 8a.. and columns 8b.. at (16 a + b) * 64 elements, row i of one
    at 8 i.  Returns a contiguous (Vp / 128, jw / 8, 16, 8, 8) tensor."""
    j8, vp = wb.shape
    if jw != j8:
        wb = torch.nn.functional.pad(wb, (0, 0, 0, jw - j8))
    return wb.view(jw // 8, 8, vp // TILE_V, TILE_V // 8, 8).permute(
        2, 0, 3, 1, 4).contiguous()


def h_tiles(hb, jw):
    """K11's h where it streams with W (`dh_plan`'s h_streams): the bf16
    (R, J8) h padded with zeros to whole 128-row blocks and jw columns,
    then, block by block and 128-column slab by slab, the 8 x 8 core
    matrices of rows 8a.. and columns 8b.. at (16 b + a) * 64 elements, row
    i of one at 8 i.  Returns a contiguous (R / 128, jw / 128, 16, 16, 8,
    8) tensor."""
    r, j8 = hb.shape
    rp = -(-r // DH_ROWS) * DH_ROWS
    hb = torch.nn.functional.pad(hb, (0, jw - j8, 0, rp - r))
    return hb.view(rp // DH_ROWS, DH_ROWS // 8, 8, jw // SLAB_J, SLAB_J // 8,
                   8).permute(0, 3, 4, 1, 2, 5).contiguous()


def dh_bias(b, vp):
    """K11's bias: b (V,) times log2 e, -inf past V, (Vp,) float32 (its
    d is exp2 of one FMA per element, and p = 0 past V)."""
    b2 = torch.full((vp,), -torch.inf, dtype=torch.float32, device=b.device)
    b2[:b.shape[0]] = b * LOG2E
    return b2


def _tiled(h, w, b, h_streams):
    """h, W and b as K10 and K11 take them: the bf16 h, J padded to J8 (in
    h_tiles' layout where h streams), W in w_tiles' layout and the log2
    bias.  Returns (hb, wt, b2, J8, Vp)."""
    hb, wb, j8, vp = _bf16_padded(h, w, w.shape[1])
    jw = _slab_width(j8)
    if h_streams:
        hb = h_tiles(hb, jw)
    return hb, w_tiles(wb, jw), dh_bias(b, vp), j8, vp


def _dh(h, w, b, y, blank, m, logs, gb, gl, tp):
    stats = (("m", m), ("logs", logs), ("gb", gb), ("gl", gl))
    r, j, v = _check(h, w, b, y, blank, stats, tp)
    dev = h.device
    hb, wt, b2, j8, vp = _tiled(h, w, b, dh_plan(r, j, dev)["h_streams"])
    dh = torch.empty((r, j8), dtype=torch.float32, device=dev)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_dh(
            hb.data_ptr(), wt.data_ptr(), b2.data_ptr(), y.data_ptr(),
            m.data_ptr(), logs.data_ptr(), gb.data_ptr(), gl.data_ptr(),
            dh.data_ptr(), r, j8, v, vp, blank, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_dh")
    launches["joint_dh_tp" if tp else "joint_dh"] += 1
    return dh[:, :j]


def joint_dh(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K11.  Returns dh (R, J) float32."""
    return _dh(h, w, b, y, blank, m, logs, gb, gl, tp=False)


def joint_dh_tp(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K11tp on a shard with the GLOBAL m, logs.  Returns the
    shard's partial dh (R, J) float32 (the sum over shards is dh)."""
    return _dh(h, w, b, y, blank, m, logs, gb, gl, tp=True)


def row_blocks(rows):
    """K12's 64-row blocks of R rows (at least one: R = 0 still writes its
    zero outputs)."""
    return max(1, -(-rows // ROWS))


def plan_splits(rows, tiles, sms, blocks_per_sm):
    """K12's row splits S for a grid of `tiles` blocks per split (V tiles
    times J slabs) on `sms` SMs holding `blocks_per_sm` blocks each.

    The grid fills at least one wave of sms x blocks_per_sm blocks where
    the row blocks allow it (S <= the row blocks); from there up to 4x
    that S, the S whose estimated time, waves x row blocks per split, is
    least (the smallest such S, for the least workspace)."""
    blocks = row_blocks(rows)
    wave = sms * blocks_per_sm
    first = min(blocks, -(-wave // tiles))

    def cost(s):
        return -(-tiles * s // wave) * -(-blocks // s)

    return min(range(first, min(blocks, 4 * first) + 1),
               key=lambda s: (cost(s), s))


def split_rows(rows, splits):
    """The row range [r0, r1) of each split: contiguous runs of whole 64-row
    blocks, as the kernel cuts them (split i takes blocks i n / S up to
    (i + 1) n / S of the n)."""
    n = row_blocks(rows)
    return [(min(rows, i * n // splits * ROWS),
             min(rows, (i + 1) * n // splits * ROWS)) for i in range(splits)]


DW_PLAN_KEYS = ("blocks_per_sm", "regs", "smem", "spill_bytes", "stages")
DH_PLAN_KEYS = DW_PLAN_KEYS + ("h_streams",)


@functools.cache
def _resources(kernel, j8, device_index):
    """K10's ("fwd"), K11's ("dh") or K12's ("dw") resources at J8 on the
    device, from the library's plan entry, and the card's SM count."""
    lib, _ = cuda_build.library()
    keys = DW_PLAN_KEYS if kernel == "dw" else DH_PLAN_KEYS
    info = (ctypes.c_int * len(keys))()
    entry = f"e2e_rnnt_joint_{kernel}_plan"
    with torch.cuda.device(device_index):
        cuda_build.check(getattr(lib, entry)(j8, info), entry)
        sms = torch.cuda.get_device_properties(device_index)
    return {"sms": sms.multi_processor_count, **dict(zip(keys, info))}


def fwd_rows(j8):
    """K10's rows of h per block at J8: 256 (four warpgroups) up to 128,
    128 above."""
    return 256 if j8 <= SLAB_J else 128


def fwd_plan(r, j, device):
    """K10's launch on `device` for R rows and J: its resources (as
    dh_plan's), whether h streams with W (the kernel decides; `_fwd` lays
    h out to match), the SM count and the grid's blocks of `fwd_rows`."""
    j8 = -(-j // 8) * 8
    res = _resources("fwd", j8, torch.device(device).index or 0)
    return {**res, "blocks": max(1, -(-r // fwd_rows(j8)))}


def dh_plan(r, j, device):
    """K11's launch on `device` for R rows and J: its resources (blocks per
    SM, registers per thread, shared memory, spilled bytes, stages), whether
    h streams with W (the kernel decides; `_dh` lays h out to match), the
    SM count and the grid's blocks (128-row blocks x 128-column J slabs
    above J = 128)."""
    j8 = -(-j // 8) * 8
    res = _resources("dh", j8, torch.device(device).index or 0)
    slabs = -(-j8 // SLAB_J) if j8 > SLAB_J else 1
    return {**res, "blocks": max(1, -(-r // DH_ROWS)) * slabs}


def dw_plan(r, j, v, device):
    """K12's launch on `device` for R rows, J, V: its resources (blocks per
    SM, registers per thread, shared memory, spilled bytes, stages), the
    SM count, the split count S and the grid's blocks."""
    j8 = -(-j // 8) * 8
    res = _resources("dw", j8, torch.device(device).index or 0)
    tiles = -(-v // DW_TILE) * (-(-j8 // SLAB_J) if j8 > SLAB_J else 1)
    splits = plan_splits(r, tiles, res["sms"], res["blocks_per_sm"])
    return {**res, "splits": splits, "blocks": tiles * splits}


def _dw(h, w, b, y, blank, m, logs, gb, gl, tp):
    stats = (("m", m), ("logs", logs), ("gb", gb), ("gl", gl))
    r, j, v = _check(h, w, b, y, blank, stats, tp)
    dev = h.device
    hb, wb, j8, vp = _bf16_padded(h, w, v)
    jp = _slab_width(j8)
    splits = dw_plan(r, j, v, dev)["splits"]
    out = torch.empty((jp + 1) * vp, dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, out.numel()), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        status = lib.e2e_rnnt_joint_dw(
            hb.data_ptr(), wb.data_ptr(), b.data_ptr(), y.data_ptr(),
            m.data_ptr(), logs.data_ptr(), gb.data_ptr(), gl.data_ptr(),
            out.data_ptr(), 0 if ws is None else ws.data_ptr(), r, j8, v, vp,
            blank, splits, _stream(dev))
    cuda_build.check(status, "e2e_rnnt_joint_dw")
    launches["joint_dw_tp" if tp else "joint_dw"] += 1
    return out[:jp * vp].view(jp, vp)[:j, :v], out[jp * vp:][:v]


def joint_dw(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K12.  Returns (dw (J, V), db (V,)) float32."""
    return _dw(h, w, b, y, blank, m, logs, gb, gl, tp=False)


def joint_dw_tp(h, w, b, y, blank, m, logs, gb, gl):
    """Launch K12tp on a shard with the GLOBAL m, logs.  Returns the
    shard's own (dw (J, V/D), db (V/D,)) float32."""
    return _dw(h, w, b, y, blank, m, logs, gb, gl, tp=True)

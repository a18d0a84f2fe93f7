"""The online-softmax fused transducer joint as plain torch: the twins of
the CUDA kernels K10 (forward), K11 (dh) and K12 (dW, db) of
csrc/rnnt_joint.cu.

Port of the arithmetic of `end2end_tpu/ops/rnnt_joint_pallas.py`
(`_fwd_kernel`, `_dh_kernel`, `_dw_kernel`).  Rows of the flattened
activation h (R, J) are independent; each function walks them in blocks of
`rows` and, inside a block, the vocabulary in tiles of `tile` columns:
  * `joint_fwd(h, w, b, y, blank) -> (b_pl, l_pl, m, logs)`: per row, the
    logits x = h W + b tile by tile, the online max / sum-exp update
    s = s exp(m_old - m_new) + sum exp(x - m_new), and the blank and label
    columns; b_pl = (x_blank - m) - log s, l_pl = (x_y - m) - log s;
  * `joint_dh(h, w, b, y, blank, m, logs, gb, gl) -> dh (R, J)` and
    `joint_dw(...) -> (dw (J, V), db (V,))`: the logits recomputed tile by
    tile, d = gb 1[blank] + gl 1[y] - p (gb + gl) with p = exp(x - m -
    log s), then dh = sum d W^T, dW = sum h^T d and db = sum d.
The numerics are the kernels': h, W and d are rounded to bfloat16 before
each product (products of bfloat16 values are exact in float32, so a
float32 matmul does what the tensor cores do, up to the order of the
sums); everything else is float32.  Columns past V are skipped, which is
what the TPU kernel's -3e38 mask does.  A label outside [0, V) matches no
column.  `tile` sets the online-softmax grouping (the kernels use
TILE = 128); `rows` only bounds the temporaries (and orders dW's and db's
sums over rows).

A CPU tensor runs these; chip_smoke.py runs them on the card beside the
kernels.
"""

from __future__ import annotations

import torch

TILE = 128   # vocabulary columns per tile, as csrc/rnnt_joint.cu
ROWS = 4096  # rows per block: a memory knob only
_NEG = -3.0e38  # the running max's identity (finite, float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tiles(v, tile):
    return [(c0, min(c0 + tile, v)) for c0 in range(0, v, tile)]


def _label_index(y, c0, c1):
    """(in this tile, column within the tile) of each row's label."""
    hit = (y >= c0) & (y < c1)
    return hit, (y - c0).clamp(0, c1 - c0 - 1)[:, None]


def joint_fwd(h, w, b, y, blank, *, rows=ROWS, tile=TILE):
    """K10's twin.  h (R, J), w (J, V), b (V,) float32; y (R,) integer
    labels.  Returns four (R,) float32 tensors: the blank plane, the label
    plane, the row max m and log s."""
    r, v = h.shape[0], w.shape[1]
    hb, wb, y = _bf16(h), _bf16(w), y.long()
    out = torch.empty((4, r), dtype=torch.float32, device=h.device)
    for r0 in range(0, r, rows):
        hr, yr = hb[r0:r0 + rows], y[r0:r0 + rows]
        m = torch.full((hr.shape[0],), _NEG, dtype=torch.float32,
                       device=h.device)
        s, xb, xy = (torch.zeros_like(m) for _ in range(3))
        for c0, c1 in _tiles(v, tile):
            x = hr @ wb[:, c0:c1] + b[c0:c1]
            m_new = torch.maximum(m, x.amax(1))
            s = s * torch.exp(m - m_new) + torch.exp(x - m_new[:, None]).sum(1)
            m = m_new
            if c0 <= blank < c1:
                xb = x[:, blank - c0]
            hit, col = _label_index(yr, c0, c1)
            xy = torch.where(hit, x.gather(1, col)[:, 0], xy)
        logs = torch.log(s)
        out[:, r0:r0 + rows] = torch.stack([(xb - m) - logs, (xy - m) - logs,
                                            m, logs])
    return out[0], out[1], out[2], out[3]


def _d_tiles(h, w, b, y, blank, m, logs, gb, gl, rows, tile):
    """Yield (r0, rows' bf16 h, c0, c1, d) for every row block and tile:
    d is the float32 gradient of (b_pl, l_pl) wrt the tile's logits,
    weighted by the cotangents gb, gl."""
    v = w.shape[1]
    hb, wb, y = _bf16(h), _bf16(w), y.long()
    for r0 in range(0, h.shape[0], rows):
        sl = slice(r0, r0 + rows)
        hr, yr = hb[sl], y[sl]
        mr, lr, gbr, glr = m[sl, None], logs[sl, None], gb[sl], gl[sl]
        c = (gbr + glr)[:, None]
        for c0, c1 in _tiles(v, tile):
            x = hr @ wb[:, c0:c1] + b[c0:c1]
            d = -torch.exp((x - mr) - lr) * c
            if c0 <= blank < c1:
                d[:, blank - c0] += gbr
            hit, col = _label_index(yr, c0, c1)
            d.scatter_add_(1, col, torch.where(hit, glr, 0.0)[:, None])
            yield r0, hr, c0, c1, d


def joint_dh(h, w, b, y, blank, m, logs, gb, gl, *, rows=ROWS, tile=TILE):
    """K11's twin: dh (R, J) = sum over tiles of bf16(d) W_tile^T, with
    the forward's m, logs and the planes' cotangents gb, gl (R,)."""
    wb = _bf16(w)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for r0, hr, c0, c1, d in _d_tiles(h, w, b, y, blank, m, logs, gb, gl,
                                      rows, tile):
        dh[r0:r0 + hr.shape[0]] += _bf16(d) @ wb[:, c0:c1].T
    return dh


def joint_dw(h, w, b, y, blank, m, logs, gb, gl, *, rows=ROWS, tile=TILE):
    """K12's twin: dW (J, V) = sum over row blocks of bf16(h)^T bf16(d),
    and db (V,) = the column sums of the float32 d."""
    dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    db = torch.zeros(w.shape[1], dtype=torch.float32, device=w.device)
    for _, hr, c0, c1, d in _d_tiles(h, w, b, y, blank, m, logs, gb, gl,
                                     rows, tile):
        dw[:, c0:c1] += hr.T @ _bf16(d)
        db[c0:c1] += d.sum(0)
    return dw, db

"""The port's online-softmax fused joint on the CPU (ops/rnnt_joint.py and
its plain twins, ops/rnnt_joint_plain.py) against the JAX package's
`rnnt_joint_pallas.py`, whose Pallas kernels run in interpret mode here, as
its own tests run them.

Tolerances, and why:
  * the twins' forward (planes, m, log s) within 1e-5 of the kernel's: the
    same tiles (512 lanes, 512 rows), the same bf16 products; only the
    order of the float32 sums and the exp's last bits differ;
  * dh, dW and db within 1e-3 of each tensor's max: d is rounded to bf16
    before the products, and a last-bit difference of the float32 d can
    round it to the neighbouring bf16 value (2^-8 of it);
  * `rnnt_nll_fused_pallas` against JAX's: the NLL rtol 1e-5 (the same
    planes to 1e-5 through the same DP), the gradients as dh/dW/db;
  * against the port's own bf16-joint `rnnt_nll_fused`: the JAX test's
    budget (2e-3 on the value; gradient cosine > 0.995 and 1.5e-2), since
    that path keeps float32 cotangents where the kernels round d.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import rnnt_joint_pallas as jjoint
from end2end_tpu_torch import (fused_additive_joint, rnnt_nll_fused,
                               rnnt_nll_fused_pallas)
from end2end_tpu_torch.ops import rnnt_joint_cuda, rnnt_joint_plain
from end2end_tpu_torch.tools import joint_fwd_breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import patched
from end2end_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

GRAD_RTOL = 1e-3

# name: (seed, n, t, u, v, j, blank)
CASES = {
    "jax_setup": (0, 2, 7, 3, 11, 8, 0),         # test_rnnt_joint_pallas
    "blank5_v13": (1, 2, 7, 3, 13, 8, 5),
    # three 512-lane tiles, the last ragged, blank in the second; R = 720
    # rows: two 512-row blocks, the last ragged
    "v1100_j16": (2, 3, 40, 5, 1100, 16, 600),
    "v16_blank9": (5, 2, 7, 3, 16, 8, 9),
    "j256": (3, 2, 7, 3, 40, 256, 0),  # two of the kernels' 128-row J slabs
}


@functools.cache
def problem(name):
    """tests/test_rnnt_joint_pallas.py's `_setup` draw, with a third sample
    when n = 3, labels kept off the blank; variable lengths."""
    seed, n, t, u, v, j, blank = CASES[name]
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, t, j)).astype(np.float32)
    pred = rng.normal(size=(n, u + 1, j)).astype(np.float32)
    w = (rng.normal(size=(j, v)) / np.sqrt(j)).astype(np.float32)
    b = (0.1 * rng.normal(size=(v,))).astype(np.float32)
    tgt = rng.integers(1, v, (n, u)).astype(np.int32)
    tgt = np.where(tgt == blank, (blank + 1) % v, tgt).astype(np.int32)
    il = np.array([t, t - 2, t - 5], np.int32)[:n]
    ul = np.array([u, 1, u - 2], np.int32)[:n]
    return (enc, pred, w, b), tgt, il, ul, blank


@functools.cache
def rows_problem(name):
    """The kernels' row inputs: h = tanh(enc + pred) (R, J), w, b, labels
    y (R,), and random plane cotangents gb, gl (R,)."""
    (enc, pred, w, b), tgt, _, _, blank = problem(name)
    n, t, j = enc.shape
    up = pred.shape[1]
    h = np.tanh(enc[:, :, None] + pred[:, None]).reshape(-1, j)
    y = np.broadcast_to(np.pad(tgt, ((0, 0), (0, up - tgt.shape[1])))
                        [:, None], (n, t, up)).reshape(-1).astype(np.int32)
    g = np.random.default_rng(7).random((2, h.shape[0])).astype(np.float32)
    return h.astype(np.float32), w, b, y, blank, g[0], g[1]


@functools.cache
def cut_rows(name, cut):
    """rows_problem(name) with the last `cut` of J's columns of h and rows
    of W taken away (J not a multiple of 8 when cut = 3)."""
    h, w, b, y, blank, gb, gl = rows_problem(name)
    j = h.shape[1] - cut
    return (np.ascontiguousarray(h[:, :j]), np.ascontiguousarray(w[:j]), b,
            y, blank, gb, gl)


@functools.cache
def jax_rows(name, cut=0):
    """JAX's forward (planes, m, log s) and backward (dh, dW, db)."""
    h, w, b, y, blank, gb, gl = cut_rows(name, cut)
    v = w.shape[1]
    (b_pl, l_pl), res = jjoint._joint_planes_fwd_impl(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(y),
        blank, v)
    r = h.shape[0]
    m, logs = res[4][:r, 0], res[5][:r, 0]
    grads = jjoint._joint_planes_bwd(blank, v, res, (jnp.asarray(gb),
                                                     jnp.asarray(gl)))[:3]
    return ([np.asarray(x) for x in (b_pl, l_pl, m, logs)],
            [np.asarray(x) for x in grads])


def torch_rows(name):
    h, w, b, y, blank, gb, gl = rows_problem(name)
    return (*(torch.tensor(a) for a in (h, w, b, y)), blank), (
        torch.tensor(gb), torch.tensor(gl))


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rtol, f"{what}: {err} of the max"


@pytest.mark.parametrize("name", list(CASES))
def test_joint_fwd_matches_jax(name):
    args, _ = torch_rows(name)
    got = rnnt_joint_plain.joint_fwd(*args, rows=512, tile=512)
    want, _ = jax_rows(name)
    for g, w, what in zip(got, want, ("b_pl", "l_pl", "m", "logs")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_joint_dh_dw_match_jax(name):
    args, (gb, gl) = torch_rows(name)
    (_, _, m, logs), (dh, dw, db) = jax_rows(name)
    stats = (torch.tensor(m), torch.tensor(logs), gb, gl)
    got_dh = rnnt_joint_plain.joint_dh(*args, *stats, rows=512, tile=512)
    got_dw, got_db = rnnt_joint_plain.joint_dw(*args, *stats, rows=512,
                                               tile=512)
    for g, w, what in ((got_dh, dh, "dh"), (got_dw, dw, "dW"),
                       (got_db, db, "db")):
        assert g.shape == w.shape
        assert_rel(g.numpy(), w, GRAD_RTOL, what)


def test_twins_tile_and_row_widths_agree():
    """The kernels' widths (row blocks of 64, tiles of 128) give the 512
    ones' results up to float32 sum order."""
    args, (gb, gl) = torch_rows("v1100_j16")
    wide = rnnt_joint_plain.joint_fwd(*args, rows=512, tile=512)
    narrow = rnnt_joint_plain.joint_fwd(*args, rows=64, tile=128)
    for a, c in zip(wide, narrow):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-5)
    stats = (wide[2], wide[3], gb, gl)
    for fn in (rnnt_joint_plain.joint_dh, rnnt_joint_plain.joint_dw):
        a, c = fn(*args, *stats, rows=512, tile=512), fn(*args, *stats,
                                                         rows=64, tile=128)
        for x, z in zip(a if isinstance(a, tuple) else (a,),
                        c if isinstance(c, tuple) else (c,)):
            assert_rel(x.numpy(), z.numpy(), GRAD_RTOL)


@pytest.mark.parametrize("cut", [0, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_bf16_padding_keeps_dh_dw(name, cut):
    """The backward kernels' inputs (rnnt_joint_cuda._bf16_padded: h and W
    in bf16, J padded with zeros to a multiple of 8, W's columns to whole
    128-column tiles): the plain twins fed them (W's first V columns) give
    the unpadded inputs' dh and dW in the first J columns and rows, zeros
    past them and the same db, to the float32 sum order; and match JAX's
    `_joint_planes_bwd` to GRAD_RTOL.  cut = 3 makes J not a multiple of 8
    (5, 5, 13, 5 and 253: the padding adds 3)."""
    h, w, b, y, blank, gb, gl = (torch.tensor(a) if isinstance(a, np.ndarray)
                                 else a for a in cut_rows(name, cut))
    (_, _, m, logs), (dh, dw, db) = jax_rows(name, cut)
    stats = (torch.tensor(m), torch.tensor(logs), gb, gl)
    r, j = h.shape
    v = w.shape[1]
    hb, wb, j8, vp = rnnt_joint_cuda._bf16_padded(h, w, v)
    assert (j8, vp) == (-(-j // 8) * 8, -(-v // 128) * 128)
    assert hb.dtype == wb.dtype == torch.bfloat16
    assert hb.shape == (r, j8) and wb.shape == (j8, vp)
    assert torch.equal(hb[:, :j], h.to(torch.bfloat16))
    assert torch.equal(wb[:j, :v], w.to(torch.bfloat16))
    assert not hb[:, j:].any() and not wb[j:].any() and not wb[:, v:].any()
    kw = {"rows": 512, "tile": 512}
    p_dh = rnnt_joint_plain.joint_dh(hb, wb[:, :v], b, y, blank, *stats, **kw)
    p_dw, p_db = rnnt_joint_plain.joint_dw(hb, wb[:, :v], b, y, blank,
                                           *stats, **kw)
    u_dh = rnnt_joint_plain.joint_dh(h, w, b, y, blank, *stats, **kw)
    u_dw, u_db = rnnt_joint_plain.joint_dw(h, w, b, y, blank, *stats, **kw)
    assert p_dh.shape == (r, j8) and p_dw.shape == (j8, v)
    assert not p_dh[:, j:].any() and not p_dw[j:].any()
    for g, u in ((p_dh[:, :j], u_dh), (p_dw[:j], u_dw), (p_db, u_db)):
        torch.testing.assert_close(g, u, rtol=1e-6, atol=1e-7)
    for g, want, what in ((p_dh[:, :j], dh, "dh"), (p_dw[:j], dw, "dW"),
                          (p_db, db, "db")):
        assert g.shape == want.shape
        assert_rel(g.numpy(), want, GRAD_RTOL, what)


@pytest.mark.parametrize("j,v", [(5, 11), (16, 300), (200, 130)])
def test_dh_w_tiles_hold_w_in_stage_order(j, v):
    """K11's W (rnnt_joint_cuda.w_tiles of the padded bf16 W): for each
    128-column tile, the rows padded with zeros to the kernel's J width (16,
    32, 64, 128 or whole 128-row slabs), in 8 x 8 core matrices of rows
    8a.. and columns 8b.. at (16 a + b) * 64 elements, row i of one at 8 i:
    every element of W once, zeros elsewhere."""
    w = torch.tensor(np.random.default_rng(j).standard_normal((j, v)),
                     dtype=torch.float32)
    _, wb, j8, vp = rnnt_joint_cuda._bf16_padded(torch.zeros((3, j)), w, v)
    jw = rnnt_joint_cuda._slab_width(j8)
    wt = rnnt_joint_cuda.w_tiles(wb, jw).reshape(-1)
    assert wt.numel() == jw * vp
    jj, cc = np.meshgrid(np.arange(jw), np.arange(vp), indexing="ij")
    tile, c = np.divmod(cc, 128)
    at = (tile * jw * 128 + (16 * (jj // 8) + c // 8) * 64 + 8 * (jj % 8)
          + c % 8)
    want = torch.zeros((jw, vp), dtype=torch.bfloat16)
    want[:j, :v] = w.to(torch.bfloat16)
    assert torch.equal(wt[torch.from_numpy(at)], want)


@pytest.mark.parametrize("r,j", [(5, 8), (300, 776)])
def test_dh_h_tiles_hold_h_in_stage_order(r, j):
    """K11's streamed h (rnnt_joint_cuda.h_tiles, above 640 columns):
    zeros past R and J up to whole 128-row blocks and 128-column slabs,
    then per block and slab the 8 x 8 core matrices of rows 8a.. and
    columns 8b.. at (16 b + a) * 64 elements, row i of one at 8 i: every
    element of h once, zeros elsewhere."""
    hb = torch.tensor(np.random.default_rng(r).standard_normal((r, j)),
                      dtype=torch.bfloat16)
    jw = -(-j // 128) * 128
    ht = rnnt_joint_cuda.h_tiles(hb, jw).reshape(-1)
    rp = -(-r // 128) * 128
    assert ht.numel() == rp * jw
    rr, jj = np.meshgrid(np.arange(rp), np.arange(jw), indexing="ij")
    (blk, rb), (slab, jb) = np.divmod(rr, 128), np.divmod(jj, 128)
    at = ((blk * (jw // 128) + slab) * 128 * 128
          + (16 * (jb // 8) + rb // 8) * 64 + 8 * (rb % 8) + jb % 8)
    want = torch.zeros((rp, jw), dtype=torch.bfloat16)
    want[:r, :j] = hb
    assert torch.equal(ht[torch.from_numpy(at)], want)


def k10_emulation(h, w, b, y, blank, raw=False, lanes_out=None):
    """The arithmetic of K10 (csrc/rnnt_joint.cu) in plain torch: W as the
    kernel reads it from `w_tiles`' layout and the bias from `dh_bias`
    (log2 units, -inf past V), each tile's logits x = bf16(h) W_tile,
    v = x log2 e + b2 (-inf past V); tile column 8 nf + 2 t + e belongs to
    lane t of its row's four, and each lane keeps a running max M (from the
    finite identity -3e38) and sum S over its columns, tile by tile: with
    M' = max(M, the tile's max), S' = (S + sum 2^(v - M)) 2^(M - M'), or,
    where the tile's max exceeds M by more than 64 (every lane's first tile
    with a column), S' = S 2^(M - M') + sum 2^(v - M'); then the quad
    combine, m = M ln 2, log s = ln S, and the blank and label logits, each
    a dot of the row of bf16(h) with W's column, + b[c].  Returns (b_pl,
    l_pl, m, logs), with `raw` the raw logits in place of the planes;
    `lanes_out`, a list, receives the lanes' final (M, S), each (4, R)."""
    r, v = h.shape[0], w.shape[1]
    hb, wb, j8, vp = rnnt_joint_cuda._bf16_padded(h, w, v)
    jw = rnnt_joint_cuda._slab_width(j8)
    wt = rnnt_joint_cuda.w_tiles(wb, jw)
    b2 = rnnt_joint_cuda.dh_bias(b, vp)
    hf = torch.nn.functional.pad(hb.float(), (0, jw - j8))
    lane = (torch.arange(128) >> 1) & 3
    big_m = torch.full((4, r), -3.0e38)
    big_s = torch.zeros((4, r))
    w_all = torch.cat([wt[c].permute(0, 2, 1, 3).reshape(jw, 128)
                       for c in range(vp // 128)], 1).float()
    y = y.long()
    own = (y >= 0) & (y < v)
    xy = torch.where(own, (hf * w_all[:, y.clamp(0, v - 1)].T).sum(1)
                     + b[y.clamp(0, v - 1)], 0.0)
    xb = hf @ w_all[:, blank] + b[blank] if blank >= 0 else torch.zeros(r)
    for c in range(vp // 128):
        x = hf @ w_all[:, c * 128:(c + 1) * 128]
        c0 = c * 128
        vals = x * rnnt_joint_cuda.LOG2E + b2[c0:c0 + 128]
        for t in range(4):
            vt = vals[:, lane == t]
            top = vt.amax(1)
            new = torch.maximum(big_m[t], top)
            lagged = ((big_s[t] + torch.exp2(vt - big_m[t][:, None]).sum(1))
                      * torch.exp2(big_m[t] - new))
            redo = (big_s[t] * torch.exp2(big_m[t] - new)
                    + torch.exp2(vt - new[:, None]).sum(1))
            big_s[t] = torch.where(top > big_m[t] + 64.0, redo, lagged)
            big_m[t] = new
    if lanes_out is not None:
        lanes_out.append((big_m.clone(), big_s.clone()))
    mr = big_m.amax(0)
    sr = (big_s * torch.exp2(big_m - mr)).sum(0)
    m, logs = mr * float(np.log(2.0)), torch.log(sr)
    if raw:
        return xb, xy, m, logs
    return (xb - m) - logs, (xy - m) - logs, m, logs


@pytest.mark.parametrize("name", list(CASES))
def test_k10_arithmetic_matches_jax(name):
    """K10's formulation (k10_emulation: the W tiles and log2 bias it
    reads, the columns split over four lanes, per-lane running max and
    sum in tile order, the quad combine) against JAX's forward within
    1e-5."""
    args, _ = torch_rows(name)
    want, _ = jax_rows(name)
    got = k10_emulation(*args)
    for g, w, what in zip(got, want, ("b_pl", "l_pl", "m", "logs")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=what)


def test_k10_arithmetic_tp_shards():
    """K10tp's formulation on D=4 shards of V=16 (four columns each: two
    lanes of every row own no column below V and keep the finite
    identity, with a zero sum) against the TP twins shard by shard within
    1e-5, and the shards combined against JAX's unsharded forward."""
    args, _ = torch_rows("v16_blank9")
    h, w, b, y, blank = args
    d, v = 4, w.shape[1]
    vl = v // d
    fwd = []
    for lo in range(0, v, vl):
        own = (y >= lo) & (y < lo + vl)
        shard = (h, w[:, lo:lo + vl].contiguous(), b[lo:lo + vl].contiguous(),
                 torch.where(own, y - lo, -1),
                 blank - lo if lo <= blank < lo + vl else -1)
        lanes = []
        got = k10_emulation(*shard, raw=True, lanes_out=lanes)
        big_m, big_s = lanes[0]
        assert bool((big_m[2:] == -3.0e38).all()) and not big_s[2:].any()
        for g, p, what in zip(got, rnnt_joint_plain.joint_fwd_tp(*shard),
                              ("xb", "xy", "m", "logs")):
            torch.testing.assert_close(g, p, rtol=0, atol=1e-5, msg=what)
        fwd.append(got)
    xb, xy, m_l, logs_l = (torch.stack(c) for c in zip(*fwd))
    m = m_l.amax(0)
    logs = torch.log(torch.exp(logs_l + (m_l - m)).sum(0))
    want, _ = jax_rows("v16_blank9")
    for g, w_, what in zip(((xb.sum(0) - m) - logs, (xy.sum(0) - m) - logs,
                            m, logs), want, ("b_pl", "l_pl", "m", "logs")):
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("kernel,name", [
    ("wgmma", n) for n in joint_fwd_breakdown.NEW] + [
    ("wmma", n) for n in joint_fwd_breakdown.OLD])
def test_fwd_breakdown_patches_apply(kernel, name):
    """Each of K10's breakdown patches finds its text exactly once: the
    wgmma kernel's in csrc/rnnt_joint.cu, the wmma kernel's in the copy
    kept as tools/joint_fwd_reference.cu; the tool tells the two apart."""
    if kernel == "wgmma":
        src, patches = ((cuda_build.CSRC / "rnnt_joint.cu").read_text(),
                        joint_fwd_breakdown.NEW)
    else:
        src, patches = (joint_fwd_breakdown.REFERENCE.read_text(),
                        joint_fwd_breakdown.OLD)
    assert joint_fwd_breakdown.is_old(src) == (kernel == "wmma")
    assert patched(src, patches[name]) != src


def jax_fused(name):
    arrays, tgt, il, ul, blank = problem(name)

    def total(*xs):
        return jnp.sum(jjoint.rnnt_nll_fused_pallas(
            *xs, tgt, il, ul, blank=blank, implementation="xla"))

    value = jjoint.rnnt_nll_fused_pallas(
        *(jnp.asarray(a) for a in arrays), tgt, il, ul, blank=blank,
        implementation="xla")
    grads = jax.grad(total, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    return np.asarray(value), [np.asarray(g) for g in grads]


def torch_fused(name, loss_fn=None):
    arrays, tgt, il, ul, blank = problem(name)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    if loss_fn is None:
        nll = rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank)
    else:
        nll = loss_fn(xs, tgt, il, ul, blank)
    nll.sum().backward()
    return nll.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("name", list(CASES))
def test_fused_pallas_matches_jax(name):
    """Values and the gradients of enc_proj, pred_proj, w_out, b_out
    against jax.grad of the JAX function (variable lengths throughout)."""
    want, want_g = jax_fused(name)
    got, got_g = torch_fused(name)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    for g, w, what in zip(got_g, want_g, ("enc_proj", "pred_proj", "w_out",
                                          "b_out")):
        assert_rel(g, w, GRAD_RTOL, what)


@pytest.mark.parametrize("name", ["jax_setup", "blank5_v13"])
def test_fused_pallas_close_to_bf16_joint(name):
    """tests/test_rnnt_joint_pallas.py's oracle: the same joint with bf16
    operands, materialised chunk by chunk in float32 sums."""
    got, got_g = torch_fused(name)

    def bf16_joint(xs, tgt, il, ul, blank):
        joint = fused_additive_joint(xs[2], xs[3], matmul_dtype="bfloat16")
        return rnnt_nll_fused(xs[0], xs[1], joint, tgt, il, ul, blank=blank,
                              chunk_t=4)

    want, want_g = torch_fused(name, bf16_joint)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    for a, c in zip(got_g, want_g):
        a, c = a.ravel(), c.ravel()
        assert a @ c / (np.linalg.norm(a) * np.linalg.norm(c)) > 0.995
        np.testing.assert_allclose(a, c, rtol=0, atol=1.5e-2)


def test_training_descends():
    (enc, pred, w, b), tgt, il, ul, _ = problem("jax_setup")
    enc, pred, b = (torch.tensor(a) for a in (enc, pred, b))
    w = torch.tensor(w, requires_grad=True)

    def loss():
        return rnnt_nll_fused_pallas(enc, pred, w, b, tgt, il, ul).mean()

    l0 = loss().item()
    for _ in range(10):
        w.grad = None
        loss().backward()
        with torch.no_grad():
            w -= 0.1 * w.grad
    assert loss().item() < l0 - 0.05


def test_routing_on_the_cpu(monkeypatch):
    """CPU tensors take the plain twins (no kernel launch), every
    `implementation` of the DP but 'pallas', which needs the card."""
    arrays, tgt, il, ul, blank = problem("blank5_v13")
    xs = [torch.tensor(a) for a in arrays]
    calls = []
    for fn in ("joint_fwd", "joint_dh", "joint_dw"):
        orig = getattr(rnnt_joint_plain, fn)
        monkeypatch.setattr(rnnt_joint_plain, fn,
                            lambda *a, _f=orig, _n=fn: calls.append(_n)
                            or _f(*a))
    before = dict(rnnt_joint_cuda.launches)
    auto = rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank)
    assert torch.equal(auto, rnnt_nll_fused_pallas(
        *xs, tgt, il, ul, blank=blank, implementation="xla"))
    x = xs[0].clone().requires_grad_(True)
    rnnt_nll_fused_pallas(x, *xs[1:], tgt, il, ul, blank=blank).sum(
    ).backward()
    assert calls == ["joint_fwd"] * 3 + ["joint_dh"]  # w, b need no grad
    assert rnnt_joint_cuda.launches == before
    with pytest.raises(ValueError, match="pallas"):
        rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank,
                              implementation="pallas")
    with pytest.raises(ValueError, match="implementation"):
        rnnt_nll_fused_pallas(*xs, tgt, il, ul, implementation="cuda")


def test_bad_inputs_raise():
    arrays, tgt, il, ul, _ = problem("jax_setup")
    xs = [torch.tensor(a) for a in arrays]
    with pytest.raises(ValueError, match="targets must be"):
        rnnt_nll_fused_pallas(*xs, tgt[0], il, ul)
    with pytest.raises(ValueError, match="targets must be"):
        rnnt_nll_fused_pallas(*xs, np.ones((2, 4), np.int32), il, ul)
    with pytest.raises(ValueError, match="blank"):
        rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=11)
    with pytest.raises(ValueError, match="fit"):
        rnnt_nll_fused_pallas(xs[0], xs[1], xs[2].T, xs[3], tgt, il, ul)


@pytest.mark.parametrize("name", ["v16_blank9", "v1100_j16"])
def test_tp_twins_combine_to_unsharded(name):
    """The TP twins on D=4 shards (blank and labels shard-relative, -1 on
    the shards that do not own them), combined with MAX and SUM as the
    vocabulary-parallel loss combines them, equal the unsharded twins: the
    forward within 1e-5 (m exactly: a max), the summed partial dh and the
    concatenated dW, db within GRAD_RTOL of each tensor's max."""
    args, (gb, gl) = torch_rows(name)
    h, w, b, y, blank = args
    d, v = 4, w.shape[1]
    vl = v // d
    want = rnnt_joint_plain.joint_fwd(*args, rows=64)
    stats = (want[2], want[3], gb, gl)
    fwd, dh, dw, db = [], 0.0, [], []
    for lo in range(0, v, vl):
        own = (y >= lo) & (y < lo + vl)
        shard = (h, w[:, lo:lo + vl], b[lo:lo + vl],
                 torch.where(own, y - lo, -1),
                 blank - lo if lo <= blank < lo + vl else -1)
        fwd.append(rnnt_joint_plain.joint_fwd_tp(*shard, rows=64))
        dh = dh + rnnt_joint_plain.joint_dh_tp(*shard, *stats, rows=64)
        s_dw, s_db = rnnt_joint_plain.joint_dw_tp(*shard, *stats, rows=64)
        dw, db = dw + [s_dw], db + [s_db]
    xb, xy, m_l, logs_l = (torch.stack(c) for c in zip(*fwd))
    m = m_l.amax(0)
    logs = torch.log(torch.exp(logs_l + (m_l - m)).sum(0))
    got = ((xb.sum(0) - m) - logs, (xy.sum(0) - m) - logs, m, logs)
    for g, p, what in zip(got, want, ("b_pl", "l_pl", "m", "logs")):
        torch.testing.assert_close(g, p, rtol=0, atol=1e-5, msg=what)
    assert torch.equal(m, want[2])
    assert_rel(dh.numpy(), rnnt_joint_plain.joint_dh(*args, *stats,
                                                     rows=64).numpy(),
               GRAD_RTOL, "dh")
    u_dw, u_db = rnnt_joint_plain.joint_dw(*args, *stats, rows=64)
    assert_rel(torch.cat(dw, 1).numpy(), u_dw.numpy(), GRAD_RTOL, "dW")
    assert_rel(torch.cat(db).numpy(), u_db.numpy(), GRAD_RTOL, "db")


# (R, tiles, SMs, blocks per SM): R < 64, R not a multiple of 64, one
# tile, S capped by the row blocks, a grid past one wave, the bench row
# unsharded and per shard on an H100 (132 SMs, 2 blocks each)
PLANS = [(0, 1, 132, 2), (1, 3, 132, 2), (63, 1, 4, 1), (65, 1, 4, 1),
         (1000, 9, 132, 2), (20000, 1, 132, 2), (20000, 3, 132, 2),
         (20000, 300, 132, 2), (259200, 256, 132, 2), (259200, 64, 132, 2),
         (259200, 512, 132, 1), (777, 2, 3, 2)]


@pytest.mark.parametrize("rows,tiles,sms,per_sm", PLANS)
def test_dw_planner_covers_every_row_once(rows, tiles, sms, per_sm):
    """K12's planner: 1 <= S <= the 64-row blocks; the grid fills a wave
    where the row blocks allow; each split a contiguous run of whole
    64-row blocks, the splits in order covering [0, R) once."""
    s = rnnt_joint_cuda.plan_splits(rows, tiles, sms, per_sm)
    blocks = rnnt_joint_cuda.row_blocks(rows)
    assert 1 <= s <= blocks
    assert tiles * s >= sms * per_sm or s == blocks
    ranges = rnnt_joint_cuda.split_rows(rows, s)
    assert len(ranges) == s and ranges[0][0] == 0 and ranges[-1][1] == rows
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for r0, r1 in ranges:
        assert r0 % 64 == 0 and (r1 % 64 == 0 or r1 == rows)
        assert r1 > r0 or rows == 0
    sizes = [-(-(r1 - r0) // 64) for r0, r1 in ranges]
    assert max(sizes) - min(sizes) <= 1


def test_dw_planner_at_the_bench_row():
    """The split counts the kernel's design is sized for on an H100 (one
    block per SM): two at V=32768 (128 tiles of 256 columns), eight on a
    V/D=8192 shard (32 tiles), one wave of 132 at one tile."""
    assert rnnt_joint_cuda.plan_splits(259200, 128, 132, 1) == 2
    assert rnnt_joint_cuda.plan_splits(259200, 32, 132, 1) == 8
    assert rnnt_joint_cuda.plan_splits(20000, 1, 132, 1) == 132


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (2, 1)])
def test_dw_split_partials_match_jax(name, sms, per_sm):
    """K12's two passes on the CPU: the plain twin on each of the planner's
    row ranges, the partials summed in split order, against JAX's
    `_dw_kernel` (a small `sms` makes more than one split)."""
    args, (gb, gl) = torch_rows(name)
    (_, _, m, logs), (_, dw, db) = jax_rows(name)
    h, w, b, y, blank = args
    rows = h.shape[0]
    tiles = (-(-w.shape[1] // rnnt_joint_cuda.DW_TILE)
             * max(1, -(-h.shape[1] // 128)))
    splits = rnnt_joint_cuda.plan_splits(rows, tiles, sms, per_sm)
    stats = (torch.tensor(m), torch.tensor(logs), gb, gl)
    got_dw, got_db = 0.0, 0.0
    for r0, r1 in rnnt_joint_cuda.split_rows(rows, splits):
        part = rnnt_joint_plain.joint_dw(
            h[r0:r1], w, b, y[r0:r1], blank, *(s[r0:r1] for s in stats),
            rows=64, tile=128)
        got_dw, got_db = got_dw + part[0], got_db + part[1]
    assert_rel(got_dw.numpy(), dw, GRAD_RTOL, "dW")
    assert_rel(got_db.numpy(), db, GRAD_RTOL, "db")

"""The top-k kernel's design (csrc/topk.cu, K3) checked on the CPU.

The kernel orders (value, index) pairs by one 64-bit composite
(`topk_cuda.sort_key`) and selects by bitonic networks over a warp's lanes.
Here the composite is held against the plain version's order (a stable
descending sort, the order of the JAX package's `topk_pallas` and of
`jax.lax.top_k` for all but signed zeros, which lax.top_k orders -0.0
below +0.0) on +-0.0, +-inf, denormals and ties; the two paths are
modelled in Python lane by lane, exactly as the kernel runs them, and
held against `topk_plain` bit for bit and against JAX's `topk_pallas`
(interpret mode, as the JAX package's own tests run it on the CPU); the
plan and the breakdown tool's patches are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops.topk_pallas import topk_pallas
from end2end_tpu_torch.ops import topk_cuda
from end2end_tpu_torch.tools import topk_breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import patched
from end2end_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


def _rows(rng, v, n=8):
    """Normal rows, then rows of rounded values (ties), +-0.0, +inf
    runs, -inf runs, +-denormals, and one mixing all of them."""
    x = rng.standard_normal((n, v)).astype(np.float32)
    x[0] = np.round(x[0])
    x[1] = np.where(rng.random(v) < 0.5, -0.0, 0.0)
    x[2, rng.random(v) < 0.4] = np.inf
    x[3, rng.random(v) < 0.4] = -np.inf
    x[4] = np.where(rng.random(v) < 0.5, 1e-45, -1e-45)
    kinds = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-38, 1.0],
                     np.float32)
    x[5] = kinds[rng.integers(0, len(kinds), v)]
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _check(vals, idx, x, k):
    pv, pi = topk_cuda.topk_plain(torch.from_numpy(x), k)
    assert np.array_equal(np.asarray(idx), pi.numpy())
    assert np.array_equal(_bits(vals), _bits(pv.numpy()))


# ---- the kernel's two paths, lane by lane ----------------------------------

def _segment_sort(c, P):
    """segment_sort_desc<P> on the warp's 32 composites."""
    c = list(c)
    k = 2
    while k <= P:
        j = k >> 1
        while j:
            o = [c[lane ^ j] for lane in range(32)]
            c = [c[lane] if (((lane & j) == 0) == ((lane & k & (P - 1)) == 0))
                 == (c[lane] > o[lane]) else o[lane] for lane in range(32)]
            j >>= 1
        k <<= 1
    return c


def _merge(lst, g):
    """merge_sorted<M>: the list (M register rows of 32 lanes) and the
    sorted composites g."""
    M = len(lst)
    lst = [list(r) for r in lst]
    lst[-1] = [max(a, g[31 - lane]) for lane, a in enumerate(lst[-1])]
    jr = M >> 1
    while jr:
        for r in range(M):
            if not r & jr:
                a, b = lst[r], lst[r | jr]
                lst[r] = [max(p, q) for p, q in zip(a, b)]
                lst[r | jr] = [min(p, q) for p, q in zip(a, b)]
        jr >>= 1
    for j in (16, 8, 4, 2, 1):
        for r in range(M):
            o = [lst[r][lane ^ j] for lane in range(32)]
            lst[r] = [x if ((lane & j) == 0) == (x > o[lane]) else o[lane]
                      for lane, x in enumerate(lst[r])]
    return lst


def _sort_path(x, k, segment):
    """topk_sort_kernel: rows in segments of P lanes, 32 / P a warp."""
    n, v = x.shape
    per = 32 // segment
    vals, idx = np.zeros((n, k), np.float32), np.zeros((n, k), np.int64)
    for first in range(0, n, per):
        c = []
        for lane in range(32):
            g, e = divmod(lane, segment)
            live = first + g < n and e < v
            c.append(topk_cuda.sort_key(float(x[first + g, e]), e)
                     if live else 0)
        c = _segment_sort(c, segment)
        for g in range(min(per, n - first)):
            for e in range(k):
                i = ~c[g * segment + e] & 0xFFFFFFFF
                vals[first + g, e], idx[first + g, e] = x[first + g, i], i
    return vals, idx


def _select_path(row, k, length, aligned):
    """topk_select_kernel on one row: 128-value chunks (lane-major with
    float4 loads, slot-major with scalar ones), the first chunk's bound
    for k <= 32 (the k-th of the lanes' maxima), a ballot admission into
    the buffer, a merge of each 32 buffered composites."""
    v = len(row)
    lst = [[0] * 32 for _ in range(length // 32)]
    thr, buf = 0, []
    for c0 in range(0, v, 128):
        vector = aligned and c0 + 128 <= v
        if c0 == 0 and k <= 32 and v >= 128:  # the first chunk's bound
            heads = [max(topk_cuda.sort_key(float(row[i]), i) for i in
                         ((4 * lane + j) if vector else (32 * j + lane)
                          for j in range(4))) for lane in range(32)]
            thr = _segment_sort(heads, 32)[k - 1] - 1
        for j in range(4):
            for lane in range(32):
                i = c0 + 4 * lane + j if vector else c0 + 32 * j + lane
                if i < v and topk_cuda.sort_key(float(row[i]), i) > thr:
                    buf.append(topk_cuda.sort_key(float(row[i]), i))
        while len(buf) >= 32:
            lst = _merge(lst, _segment_sort(buf[-32:], 32))
            buf = buf[:-32]
            thr = lst[(k - 1) >> 5][(k - 1) & 31]
    if buf:
        lst = _merge(lst, _segment_sort(buf + [0] * (32 - len(buf)), 32))
    idx = [~lst[e >> 5][e & 31] & 0xFFFFFFFF for e in range(k)]
    return row[idx], idx


@pytest.mark.parametrize("v", [1, 2, 3, 16, 17, 29, 32])
def test_sort_path_model_matches_plain(v):
    """The sort path (V <= 32), several rows a warp below V = 17: the
    stable sort's values and indices, bit for bit."""
    x = _rows(np.random.default_rng(v), v, n=11)
    for k in sorted({1, max(1, v // 2), min(24, v), v}):
        plan = topk_cuda.topk_plan(v, k)
        assert plan["path"] == "sort"
        _check(*_sort_path(x, k, plan["segment"]), x, k)


@pytest.mark.parametrize("v,k", [(33, 1), (33, 33), (64, 24), (100, 40),
                                 (129, 64), (300, 136), (1000, 24),
                                 (1024, 40), (1024, 256)])
def test_select_path_model_matches_plain(v, k):
    """The select path (V > 32, k <= 256) at each list length, with the
    float4 loads where the row allows them and with scalar loads."""
    x = _rows(np.random.default_rng(v * 7 + k), v, n=6)
    plan = topk_cuda.topk_plan(v, k)
    assert plan["path"] == "select" and k <= plan["list"] < 2 * max(k, 32)
    for aligned in ((True, False) if v % 4 == 0 else (False,)):
        out = [_select_path(r, k, plan["list"], aligned) for r in x]
        _check(np.stack([o[0] for o in out]), [o[1] for o in out], x, k)


def test_sort_key_orders_like_the_plain_sort():
    """Sorting by sort_key descending is the stable descending sort:
    -0.0 ties +0.0 (by index), +-inf ties by index, denormals above and
    below zero, and equal values by ascending index."""
    rng = np.random.default_rng(3)
    for it in range(40):
        x = _rows(rng, int(rng.integers(1, 300)), n=6)[it % 6]
        order = sorted(range(x.size), reverse=True,
                       key=lambda i: topk_cuda.sort_key(float(x[i]), i))
        _, want = topk_cuda.topk_plain(torch.from_numpy(x), x.size)
        assert order == want.tolist()
    keys = [topk_cuda.sort_key(f, 0) for f in
            (float("inf"), 1.0, 1e-45, 0.0, -0.0, -1e-45, -1.0,
             float("-inf"))]
    assert keys[3] == keys[4] and sorted(keys, reverse=True) == keys
    assert topk_cuda.sort_key(0.0, 3) > topk_cuda.sort_key(-0.0, 4)


@pytest.mark.parametrize("v,k", [(29, 24), (64, 24), (1000, 40)])
def test_models_match_jax_topk_pallas(v, k):
    """The kernel's model against the JAX package's top-k kernel (interpret
    mode) on rows with ties and +-0.0 ties: the same indices, values equal
    as floats (the Pallas kernel writes the row max, +0.0, for a -0.0
    entry; the port keeps the entry's bits, as the stable sort does)."""
    x = _rows(np.random.default_rng(11), v, n=6)[:2]
    jv, ji = (a[0] for a in topk_pallas(jnp.asarray(x)[None], k,
                                        interpret=True))
    plan = topk_cuda.topk_plan(v, k)
    if plan["path"] == "sort":
        vals, idx = _sort_path(x, k, plan["segment"])
    else:
        out = [_select_path(r, k, plan["list"], v % 4 == 0) for r in x]
        vals, idx = np.stack([o[0] for o in out]), [o[1] for o in out]
    assert np.array_equal(np.asarray(idx), np.asarray(ji))
    assert np.array_equal(vals, np.asarray(jv))


def test_topk_plan():
    """The sort path up to V = 32 (segments of the next power of two), the
    select path's list the power-of-two multiple of 32 at or above k,
    the rounds past k = 256; k outside [1, V] raises."""
    assert [topk_cuda.topk_plan(v, 1)["segment"] for v in
            (1, 2, 3, 16, 17, 29, 32)] == [1, 2, 4, 16, 32, 32, 32]
    assert topk_cuda.topk_plan(16, 4)["rows_per_warp"] == 2
    assert [topk_cuda.topk_plan(4096, k)["list"] for k in
            (1, 32, 33, 64, 65, 128, 129, 256)] == [32, 32, 64, 64, 128,
                                                    128, 256, 256]
    assert topk_cuda.topk_plan(4096, 257)["path"] == "rounds"
    for v, k in ((8, 0), (8, 9)):
        with pytest.raises(ValueError):
            topk_cuda.topk_plan(v, k)


@pytest.mark.parametrize("name", list(topk_breakdown.NEW))
def test_topk_breakdown_patches_apply(name):
    """Each of the K3 breakdown tool's text patches finds its text exactly
    once in csrc/topk.cu, so the variants it times exist."""
    src = (cuda_build.CSRC / "topk.cu").read_text()
    assert patched(src, topk_breakdown.NEW[name]) != src


def test_topk_breakdown_shapes():
    """The tool's shapes: the serving slice's and the LM decode's on the
    sort path, the reference shape and the beam-16 row's k on the select
    path; its problems are seeded."""
    paths = {name: topk_cuda.topk_plan(v, k)["path"]
             for name, (_, _, v, k) in topk_breakdown.SHAPES.items()}
    assert paths == {"main": "sort", "b128": "sort", "ref": "select",
                     "beam16": "select"}
    a, b = (topk_breakdown.problem("main", "cpu") for _ in range(2))
    assert a.shape == (750, 8, 32) and torch.equal(a, b)

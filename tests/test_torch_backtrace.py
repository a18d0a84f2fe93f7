"""The beam backtrace of the torch port (ops/beam_search_cuda.py) against
the JAX package's, on the CPU.

The same seeded backpointer codes in [0, W + W K) (stays, extensions and
the codes dead picks and frozen frames write), top-k ids and scores (some
at log-zero: dead beams) go through the port's `backtrace` (the host walk
`lane_walk_plain`, what a CPU tensor runs) and JAX's `_backtrace`
(`end2end_tpu/ops/beam_search_pallas.py`, its associative lane-map
composition).  Tokens, lengths, scores and times must be equal, with an
`s_cap` that truncates.  The port's `lane_walk` (the chunked decode's
boundary) is held against JAX's `_chunk_emissions`
(`end2end_tpu/ops/beam_chunked.py`) the same way.  The kernels of
csrc/backtrace.cu are modelled in Python shuffle by shuffle, as their
warps run them, and held against the host walk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops.beam_chunked import _chunk_emissions
from end2end_tpu.ops.beam_search_pallas import _backtrace
from end2end_tpu_torch.ops import beam_search_cuda
from end2end_tpu_torch.ops.semiring import LOG0
from end2end_tpu_torch.tools import lane_walk_breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import patched
from end2end_tpu_torch.utils import cuda_build

torch.set_num_threads(1)


def _codes(rng, t, W, K, n):
    """bp (T, W, N) int32 codes, ck (T, N, K + 3) ids, scores (W, N) with
    about a third of the beams dead (log-zero)."""
    bp = rng.integers(0, W + W * K, (t, W, n)).astype(np.int32)
    stay = rng.random((t, W, n)) < 0.4  # blank-heavy frames: many stays
    bp = np.where(stay, np.arange(W)[None, :, None], bp).astype(np.int32)
    ck = rng.integers(0, 50, (t, n, K + 3)).astype(np.int32)
    scores = rng.standard_normal((W, n)).astype(np.float32) * 10
    scores[rng.random((W, n)) < 0.3] = LOG0
    scores[:, 0] = np.round(scores[:, 0])  # ties, ranked by lane
    return bp, ck, scores


@pytest.mark.parametrize("t", [1, 37, 300])
@pytest.mark.parametrize("W", [1, 8, 32])
def test_backtrace_matches_jax(W, t):
    """The port's backtrace (host walk) against JAX's `_backtrace`, with a
    cap that truncates long paths and one that does not."""
    K, n = 5, 4
    rng = np.random.default_rng(W * 1000 + t)
    bp, ck, scores = _codes(rng, t, W, K, n)
    for s_cap in (max(1, t // 4), t + 1):
        got = beam_search_cuda.backtrace(torch.from_numpy(bp),
                                         torch.from_numpy(ck),
                                         torch.from_numpy(scores), W, K,
                                         s_cap)
        want = _backtrace(jnp.asarray(bp), jnp.asarray(ck),
                          jnp.asarray(scores), W, K, s_cap, t, n)
        for name, a, b in zip(("tokens", "lengths", "scores", "times"), got,
                              want):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("t", [1, 37, 128])
@pytest.mark.parametrize("W", [1, 8, 32])
def test_lane_walk_matches_jax_chunk_emissions(W, t):
    """The port's lane walk (host walk) against JAX's `_chunk_emissions`
    on one chunk's codes: lane0, the frame-aligned tokens and their
    counts."""
    K, n = 5, 4
    rng = np.random.default_rng(W * 100 + t)
    bp, ck, _ = _codes(rng, t, W, K, n)
    got = beam_search_cuda.lane_walk(torch.from_numpy(bp),
                                     torch.from_numpy(ck[:, :, :K]), W, K)
    want = _chunk_emissions(jnp.asarray(bp),
                            jnp.asarray(ck[:, :, :K].transpose(0, 2, 1)), W,
                            K, t)
    for name, a, b in zip(("lane0", "toks", "n_emit"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def _walk_model(bp, ck, W, K):
    """csrc/backtrace.cu's lane walk: a sequence is a segment of W lanes
    (32 / W sequences a warp); lane w holds final beam w's current lane as
    an absolute lane, and each frame takes the entry that lane offers by
    one shuffle: its parent and its slot + 1 (0 for a stay), kept in a
    frame-major scratch; then the block's rows take ck's id at each frame's
    slot (-1 for a stay)."""
    t_max, _, n = bp.shape
    seqs = 32 // W
    took = np.zeros((t_max, n, W), np.int64)
    lane0 = np.zeros((n, W), np.int64)
    n_emit = np.zeros((n, W), np.int64)
    for first in range(0, n, seqs):
        s = np.arange(32) // W
        w = np.arange(32) - s * W
        base = s * W
        act = (s < seqs) & (first + s < n)
        cur = base + w
        emitted = np.zeros(32, np.int64)
        for t in range(t_max - 1, -1, -1):
            c = np.where(act, bp[t, w, np.minimum(first + s, n - 1)], w)
            offer = (base + np.where(c < W, c, (c - W) // K)) | np.where(
                c >= W, ((c - W) % K + 1) << 5, 0)
            got = offer[cur]  # __shfl_sync(kFull, offer, cur)
            cur = got & 31
            emitted += got >= 32
            for lane in np.flatnonzero(act):
                took[t, first + s[lane], w[lane]] = got[lane] >> 5
        for lane in np.flatnonzero(act):
            lane0[first + s[lane], w[lane]] = cur[lane] - base[lane]
            n_emit[first + s[lane], w[lane]] = emitted[lane]
    ids = np.take_along_axis(ck, np.maximum(took - 1, 0), axis=2)
    toks = np.where(took > 0, ids, -1).transpose(1, 2, 0)
    return lane0, toks, n_emit


def _backtrace_model(bp, ck, scores, W, K, s_cap):
    """csrc/backtrace.cu's e2e_backtrace: each lane walks as in _walk_model,
    and a frame whose entry (the offer of the lane it walks to) is an
    extension appends (t, slot) to its scratch row, last first; its rank
    among its sequence's beams by score (log-zero as -inf, ties by lane);
    its row in frame order, the entry past s_cap on the last slot the
    scratch row's first."""
    t_max, _, n = bp.shape
    tokens = np.full((n, W, s_cap), -1, np.int32)
    times = np.full((n, W, s_cap), -1, np.int32)
    lens = np.zeros((n, W), np.int32)
    sc = np.zeros((n, W), np.float32)
    for seq in range(n):
        mine = np.where(scores[:, seq] > np.float32(-1e29), scores[:, seq],
                        -np.inf).astype(np.float32)
        for w in range(W):
            cur, rev = w, []
            for t in range(t_max - 1, -1, -1):
                c = int(bp[t, cur, seq])
                if c >= W:
                    rev.append((t, (c - W) % K))
                cur = c if c < W else (c - W) // K
            rank = sum(o > mine[w] or (o == mine[w] and j < w)
                       for j, o in enumerate(mine))
            lens[seq, rank] = min(len(rev), s_cap)
            sc[seq, rank] = mine[w]
            for p in range(lens[seq, rank]):
                t, slot = rev[0 if p == s_cap - 1 else len(rev) - 1 - p]
                tokens[seq, rank, p] = ck[t, seq, slot]
                times[seq, rank, p] = t
    return tokens, lens, sc, times


@pytest.mark.parametrize("W,t,s_cap", [(1, 30, 4), (5, 23, 23), (8, 40, 7),
                                       (8, 40, 41), (32, 9, 3)])
def test_backtrace_model_matches_backtrace_plain(W, t, s_cap):
    """The backtrace kernel's arithmetic, modelled per beam, equals
    backtrace_plain: dead beams and tied scores ranked, caps that truncate
    (the last emission on the cap's last slot) and one that does not."""
    rng = np.random.default_rng(W * 100 + t + s_cap)
    bp, ck, scores = _codes(rng, t, W, 6, 5)
    want = beam_search_cuda.backtrace_plain(
        *(torch.from_numpy(a) for a in (bp, ck, scores)), W, 6, s_cap)
    for name, a, b in zip(("tokens", "lengths", "scores", "times"),
                          _backtrace_model(bp, ck, scores, W, 6, s_cap),
                          want):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("W,n", [(1, 40), (5, 13), (8, 9), (16, 3),
                                 (32, 2)])
def test_lane_walk_model_matches_host_walk(W, n):
    """The lane-walk kernel, modelled lane by lane (several sequences a
    warp, a partial last warp, W that does not divide 32), equals
    `lane_walk_plain`: lane0, the frame-aligned tokens and their counts."""
    rng = np.random.default_rng(W + n)
    bp, ck, _ = _codes(rng, 23, W, 7, n)
    want = beam_search_cuda.lane_walk_plain(torch.from_numpy(bp),
                                            torch.from_numpy(ck), W, 7)
    for a, b in zip(_walk_model(bp, ck, W, 7), want):
        np.testing.assert_array_equal(a, b.numpy())


def test_lane_walk_dispatch_on_cpu_runs_the_host_walk():
    """CPU tensors take the host walks and launch nothing; the kernels'
    wrappers refuse CPU tensors."""
    rng = np.random.default_rng(0)
    bp, ck, scores = (torch.from_numpy(a) for a in _codes(rng, 9, 4, 3, 2))
    before = (beam_search_cuda.launches_walk,
              beam_search_cuda.launches_backtrace)
    for a, b in zip(beam_search_cuda.lane_walk(bp, ck, 4, 3),
                    beam_search_cuda.lane_walk_plain(bp, ck, 4, 3)):
        assert torch.equal(a, b)
    for a, b in zip(beam_search_cuda.backtrace(bp, ck, scores, 4, 3, 5),
                    beam_search_cuda.backtrace_plain(bp, ck, scores, 4, 3,
                                                     5)):
        assert torch.equal(a, b)
    assert (beam_search_cuda.launches_walk,
            beam_search_cuda.launches_backtrace) == before
    with pytest.raises(ValueError, match="CUDA"):
        beam_search_cuda.lane_walk_cuda(bp, ck, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        beam_search_cuda.backtrace_cuda(bp, ck, scores, 4, 3, 5)


@pytest.mark.parametrize("name", list(lane_walk_breakdown.NEW))
def test_lane_walk_breakdown_patches_apply(name):
    """Each of the lane-walk breakdown tool's text patches finds its text
    exactly once in csrc/backtrace.cu, so the variants it times exist."""
    src = (cuda_build.CSRC / "backtrace.cu").read_text()
    assert patched(src, lane_walk_breakdown.NEW[name]) != src


def test_lane_walk_breakdown_problems():
    """The tool's codes: seeded, of the (T, W, N) shape of each row, every
    code a stay or an extension of its beam width and prune."""
    for name, (t, n, W, K) in lane_walk_breakdown.SHAPES.items():
        bp, ck, scores = lane_walk_breakdown.problem(name, "cpu")
        again = lane_walk_breakdown.problem(name, "cpu")[0]
        assert bp.shape == (t, W, n) and torch.equal(bp, again)
        assert int(bp.min()) >= 0 and int(bp.max()) < W + W * K
        assert ck.shape == (t, n, K + 8) and scores.shape == (W, n)

"""CTC forced alignment in the torch port (CPU: the plain loops) against the
JAX package's `ctc_forced_alignment`, its brute force, and a model of the
alignment kernel (csrc/ctc_align.cu) run in numpy.

Tolerances: labels and positions equal; scores within 1e-5 of JAX's (the
same maxes and float32 adds, in a different order only where XLA fuses).
The kernel model's labels, positions and scores equal align_plain's bit
for bit (the same float32 max and add per state and frame).
"""

import numpy as np
import pytest
import torch

from end2end_tpu.ops.alignment import ctc_forced_alignment as jax_align
from end2end_tpu_torch import (ForcedAlignment, ctc_forced_alignment,
                               greedy_decode)
from end2end_tpu_torch.ops import alignment as talign
from end2end_tpu_torch.ops.semiring import LOG0, LOG0_THRESHOLD
from tests.test_alignment import _brute_best_path, _collapse

torch.set_num_threads(1)

SCORE_TOL = 1e-5


def _lattice(rng, t, b, v, scale=2.0):
    x = rng.standard_normal((t, b, v)) * scale
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _edge_problem(seed, blank):
    """Variable lengths, a repeat that needs a blank between its copies,
    an empty target, an input length of 0 and an infeasible sample (S
    labels in fewer frames than they need)."""
    rng = np.random.default_rng(seed)
    t, b, s, v = 30, 7, 6, 7
    lp = _lattice(rng, t, b, v)
    labels = [c for c in range(v) if c != blank]
    tgt = rng.choice(labels, (b, s)).astype(np.int32)
    tgt[1, :3] = labels[2]  # "x x x" needs two blanks
    tgt[3, :2] = labels[1]  # "y y z" needs 4 frames; it gets 3
    il = np.array([30, 25, 0, 3, 12, 30, 17], np.int32)
    tl = np.array([6, 4, 2, 3, 0, 6, 5], np.int32)
    return lp, tgt, il, tl


def _check_against_jax(lp, tgt, il, tl, blank):
    want = jax_align(lp, tgt, il, tl, blank=blank)
    got = ctc_forced_alignment(torch.from_numpy(lp), tgt, il, tl,
                               blank=blank)
    assert isinstance(got, ForcedAlignment)
    assert got.labels.dtype == got.positions.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("blank", [0, 4])
def test_alignment_matches_jax_on_edge_batches(seed, blank):
    lp, tgt, il, tl = _edge_problem(seed, blank)
    got = _check_against_jax(lp, tgt, il, tl, blank)
    scores = got.scores.numpy()
    assert np.isneginf(scores[3])  # infeasible
    assert (got.labels[:, 2] == -1).all()  # input length 0
    assert (got.positions[:, 4] == -1).all()  # the empty target
    for n in (0, 1, 5, 6):
        path = got.labels[: il[n], n].tolist()
        assert _collapse(path, blank) == tgt[n, : tl[n]].tolist()


def test_alignment_matches_jax_at_peaked_lattices():
    rng = np.random.default_rng(7)
    t, b, s, v = 60, 4, 12, 29
    x = np.log(0.003 / (v - 1)) + 0.5 * rng.standard_normal((t, b, v))
    ids = np.where(rng.random((t, b)) < 0.5, 0, rng.integers(1, v, (t, b)))
    np.put_along_axis(x, ids[..., None], np.log(0.997), axis=-1)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    tgt = rng.integers(1, v, (b, s)).astype(np.int32)
    il = np.array([60, 41, 33, 60], np.int32)
    tl = np.array([12, 9, 7, 1], np.int32)
    _check_against_jax(lp, tgt, il, tl, 0)


def test_alignment_matches_brute_force():
    rng = np.random.default_rng(11)
    t, v = 6, 4
    for trial in range(4):
        lp = _lattice(rng, t, 1, v)
        target = [1, 2] if trial % 2 == 0 else [3, 3]
        out = ctc_forced_alignment(torch.from_numpy(lp),
                                   np.array([target], np.int32),
                                   np.array([t]), np.array([len(target)]))
        want_path, want_p = _brute_best_path(lp[:, 0, :], target)
        np.testing.assert_allclose(float(out.scores[0]), want_p,
                                   rtol=SCORE_TOL)
        assert out.labels[:, 0].tolist() == list(want_path)


def test_alignment_float64_matches_float32_path():
    lp, tgt, il, tl = _edge_problem(5, 0)
    a32 = ctc_forced_alignment(torch.from_numpy(lp), tgt, il, tl)
    a64 = ctc_forced_alignment(torch.from_numpy(lp).double(), tgt, il, tl)
    assert a64.scores.dtype == torch.float64
    assert torch.equal(a32.labels, a64.labels)
    np.testing.assert_allclose(a64.scores.numpy(), a32.scores.numpy(),
                               rtol=1e-6)


def test_alignment_of_the_greedy_transcript_scores_the_best_path():
    """The argmax path is the best path of all and collapses to the greedy
    transcript, so aligning that transcript scores the sum of each frame's
    max log-prob (chip_smoke's phase 26 invariant)."""
    rng = np.random.default_rng(3)
    t, b, v = 40, 5, 9
    lp = torch.from_numpy(_lattice(rng, t, b, v))
    il = torch.tensor([40, 31, 22, 9, 1])
    tokens, lengths, scores = greedy_decode(lp, il)
    s = max(int(lengths.max()), 1)
    out = ctc_forced_alignment(lp, tokens[:, :s].clamp(min=0), il, lengths)
    np.testing.assert_allclose(out.scores.numpy(), scores.numpy(),
                               atol=1e-4, rtol=0)


def _kernel_model(lp, tgt, il, tl, blank):
    """csrc/ctc_align.cu's block for each sequence in numpy float32: the
    states' labels, skips and validity from the targets, delta from frame
    0, frames 1..il-1 only (the tape elsewhere never written), the end
    state, then one walk from e* down to frame 0."""
    t_max, n, v = lp.shape
    s_max = tgt.shape[1]
    L = 2 * s_max + 1
    log0 = np.float32(LOG0)
    labels = np.full((t_max, n), -1, np.int32)
    positions = np.full((t_max, n), -1, np.int32)
    scores = np.empty(n, np.float32)

    def ext(nn, s):
        return blank if s % 2 == 0 else min(max(int(tgt[nn, (s - 1) // 2]),
                                                0), v - 1)

    for nn in range(n):
        tape = np.full((t_max, L), 99, np.int8)  # never-written marker
        lab = [ext(nn, s) for s in range(L)]
        valid = [s < 2 * tl[nn] + 1 for s in range(L)]
        skip = [s % 2 == 1 and s >= 3 and lab[s] != lab[s - 2]
                for s in range(L)]

        def emis(t, s):
            return max(lp[t, nn, lab[s]], log0) if valid[s] else log0

        cur = np.full(L, log0, np.float32)
        cur[0] = emis(0, 0)
        if tl[nn] > 0:
            cur[1] = emis(0, 1)
        for t in range(1, il[nn]):
            nxt = np.empty(L, np.float32)
            for s in range(L):
                d = cur[s]
                d1 = cur[s - 1] if s >= 1 else log0
                d2 = cur[s - 2] if skip[s] else log0
                best = max(max(d, d1), d2)
                tape[t, s] = 2 if d2 >= best else (1 if d1 >= best else 0)
                nxt[s] = max(np.float32(best + np.float32(emis(t, s))), log0)
            cur = nxt
        k = 2 * tl[nn]
        end1 = cur[k]
        end2 = cur[k - 1] if tl[nn] > 0 else log0
        score = max(end1, end2)
        scores[nn] = score if score > LOG0_THRESHOLD else -np.inf
        s = k if end1 >= end2 else max(k - 1, 0)
        for t in range(il[nn] - 1, -1, -1):
            if t < il[nn] - 1:
                ch = tape[t + 1, min(max(s, 0), L - 1)]
                assert ch != 99, "the walk read a frame the kernel skips"
                s -= int(ch)
            labels[t, nn] = ext(nn, s) if s >= 0 else -1
            positions[t, nn] = (s - 1) // 2 if s >= 0 and s % 2 else -1
    return labels, positions, scores


@pytest.mark.parametrize("seed,blank", [(0, 0), (1, 4), (2, 0)])
def test_kernel_model_matches_plain(seed, blank):
    lp, tgt, il, tl = _edge_problem(seed, blank)
    want = talign.align_plain(torch.from_numpy(lp), torch.from_numpy(tgt)
                              .long(), torch.from_numpy(il).long(),
                              torch.from_numpy(tl).long(), blank)
    labels, positions, scores = _kernel_model(lp, tgt, il, tl, blank)
    np.testing.assert_array_equal(labels, want.labels.numpy())
    np.testing.assert_array_equal(positions, want.positions.numpy())
    assert scores.view(np.int32).tolist() == (
        want.scores.numpy().view(np.int32).tolist())


def test_kernel_plan_and_envelope():
    assert talign.align_plan(1) == (1, 32)
    assert talign.align_plan(301) == (1, 320)
    assert talign.align_plan(1024) == (1, 1024)
    assert talign.align_plan(1025) == (2, 544)
    assert talign.align_plan(talign.MAX_STATES) == (8, 1024)
    for L in range(1, talign.MAX_STATES + 1, 97):
        r, threads = talign.align_plan(L)
        assert threads % 32 == 0 and threads <= 1024 and threads * r >= L
    with pytest.raises(ValueError, match="states"):
        talign.align_plan(talign.MAX_STATES + 2)


def test_alignment_rejects_bad_lengths():
    lp = torch.zeros((5, 2, 4))
    tgt = np.ones((2, 3), np.int32)
    with pytest.raises(ValueError, match="input_lengths"):
        ctc_forced_alignment(lp, tgt, [6, 5], [3, 3])
    with pytest.raises(ValueError, match="target_lengths"):
        ctc_forced_alignment(lp, tgt, [5, 5], [4, 3])
    with pytest.raises(ValueError, match="padded"):
        ctc_forced_alignment(lp, np.ones(3, np.int32), [5, 5], [3, 3])

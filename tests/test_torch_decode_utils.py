"""Blank collapse, bucketing and the candidate-only beam search in the
torch port (CPU) against the JAX package.

Exact equality throughout (the same comparisons and copies; the beam
search's scores within 1e-5: the same float32 steps, libm's exp and log1p
against XLA's).
"""

import numpy as np
import pytest
import torch

from end2end_tpu.ops import beam_search as jbeam
from end2end_tpu.ops import decode_utils as jdu
from end2end_tpu.ops import lm as jlm
from end2end_tpu.utils import bucketing as jbk
from end2end_tpu_torch.ops import beam_search as tbeam
from end2end_tpu_torch.ops import decode_utils as tdu
from end2end_tpu_torch.ops import lm as tlm
from end2end_tpu_torch.utils import bucketing as tbk

torch.set_num_threads(1)

SCORE_TOL = 1e-5


def _peaked(seed, t, b, v, blank_share=0.6):
    rng = np.random.default_rng(seed)
    x = np.log(0.01 / (v - 1)) + 0.5 * rng.standard_normal((t, b, v))
    ids = np.where(rng.random((t, b)) < blank_share, 0,
                   rng.integers(1, v, (t, b)))
    np.put_along_axis(x, ids[..., None], np.log(0.99), axis=-1)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.5, 0.98])
def test_blank_collapse_matches_jax(threshold):
    lp = _peaked(0, 40, 5, 7)
    il = np.array([40, 33, 1, 0, 12], np.int32)
    want = [np.asarray(x) for x in jdu.blank_collapse(lp, il,
                                                      threshold=threshold)]
    got = [x.numpy() for x in tdu.blank_collapse(torch.from_numpy(lp), il,
                                                 threshold=threshold)]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])  # padding frames zeros
    for n in range(lp.shape[1]):
        assert not got[0][got[1][n]:, n].any()


def test_blank_collapse_keeps_one_blank_between_repeats():
    """"6 _ _ 6": the blank run shrinks to one frame and still separates
    the two 6s, so greedy decoding of the packed frames keeps both."""
    v = 8
    seq = [6, 0, 0, 0, 6, 0, 3, 3, 0, 0]
    lp = np.full((len(seq), 1, v), np.log(0.001 / (v - 1)), np.float32)
    lp[np.arange(len(seq)), 0, seq] = np.log(0.999)
    packed, new_len = tdu.blank_collapse(torch.from_numpy(lp))
    want = jdu.blank_collapse(lp)
    assert int(new_len[0]) == int(want[1][0]) == 7
    kept = packed[: int(new_len[0]), 0].argmax(-1).tolist()
    assert kept == [6, 0, 6, 0, 3, 3, 0]
    blank_rows = tdu.blank_collapse(torch.from_numpy(lp), blank=6)
    np.testing.assert_array_equal(blank_rows[1].numpy(),
                                  np.asarray(jdu.blank_collapse(lp,
                                                                blank=6)[1]))


def test_collapse_and_bucket_matches_jax():
    lp = _peaked(1, 300, 4, 9, blank_share=0.85)
    il = np.array([300, 250, 120, 40], np.int32)
    want = [np.asarray(x) for x in jdu.collapse_and_bucket(lp, il)]
    got = tdu.collapse_and_bucket(torch.from_numpy(lp), torch.from_numpy(il))
    assert got[0].shape == want[0].shape and got[0].shape[0] < 300
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    edges = (16, 64, 128)
    small = tdu.collapse_and_bucket(torch.from_numpy(lp), il, t_edges=edges)
    np.testing.assert_array_equal(
        small[0].numpy(), np.asarray(jdu.collapse_and_bucket(
            lp, il, t_edges=edges)[0]))


def test_bucketing_matches_jax():
    assert tbk.DEFAULT_T_EDGES == jbk.DEFAULT_T_EDGES
    assert tbk.DEFAULT_S_EDGES == jbk.DEFAULT_S_EDGES
    for lo, hi, ratio in ((8, 100, 1.3), (32, 4096, 1.5), (5, 5, 2.0)):
        assert tbk.geometric_edges(lo, hi, ratio) == jbk.geometric_edges(
            lo, hi, ratio)
    for n in (0, 1, 31, 32, 33, 4095, 4096, 5000):
        assert tbk.bucket_size(n, tbk.DEFAULT_T_EDGES) == jbk.bucket_size(
            n, jbk.DEFAULT_T_EDGES)
    rng = np.random.default_rng(2)
    lp = rng.standard_normal((45, 3, 5)).astype(np.float32)
    tgt = rng.integers(1, 5, (3, 11)).astype(np.int32)
    il = np.array([45, 30, 12], np.int32)
    tl = np.array([11, 7, 0], np.int32)
    spec = tbk.BucketSpec(t_edges=(16, 48, 96), s_edges=(4, 8, 16))
    jspec = jbk.BucketSpec(t_edges=(16, 48, 96), s_edges=(4, 8, 16))
    got = tbk.bucket_pad(lp, tgt, il, tl, spec, lp_pad=-3.0, label_pad=2)
    want = jbk.bucket_pad(lp, tgt, il, tl, jspec, lp_pad=-3.0, label_pad=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (48, 3, 5) and got[1].shape == (3, 16)
    with pytest.raises(ValueError, match="padded"):
        tbk.bucket_pad(lp, tgt[0], il, tl)


def _candidates(lp, k):
    """(lpk, ck) from numpy: the K best per frame, ties by index (the
    order of jax.lax.top_k and of the port's top-k)."""
    order = np.argsort(-lp, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(lp, order, -1), order.astype(np.int32)


@pytest.mark.parametrize("k", [9, 5, 3])
@pytest.mark.parametrize("w", [1, 4])
def test_beam_search_from_topk_matches_jax(k, w):
    """K = V is the exact prefix beam search; K < V the candidate-only
    prune (the stay term reads the K candidates only) on both sides."""
    t, b, v = 30, 3, 9
    lp = _peaked(3 + k, t, b, v, blank_share=0.4)
    il = np.array([30, 21, 7], np.int32)
    lpk, ck = _candidates(lp, k)
    lpb = np.ascontiguousarray(lp[:, :, 0])
    want = [np.asarray(x) for x in jbeam.beam_search_from_topk(
        lpk, ck, lpb, il, beam_width=w, blank=0, max_symbols=12,
        return_timestamps=True)]
    got = [x.numpy() for x in tbeam.beam_search_from_topk(
        torch.from_numpy(lpk), torch.from_numpy(ck), torch.from_numpy(lpb),
        torch.from_numpy(il), w, 0, 12, return_timestamps=True)]
    for i in (0, 1, 3):  # tokens, lengths, times
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], atol=SCORE_TOL, rtol=0)


def test_beam_search_from_topk_with_a_bigram_lm_matches_jax():
    t, b, v = 25, 3, 7
    lp = _peaked(11, t, b, v, blank_share=0.4)
    rng = np.random.default_rng(12)
    big = jlm.bigram_from_counts(rng.integers(0, 20, (v, v)))
    st = rng.standard_normal(v).astype(np.float32)
    eos = rng.standard_normal(v).astype(np.float32)
    il = np.array([25, 19, 4], np.int32)
    lpk, ck = _candidates(lp, v)
    lpb = np.ascontiguousarray(lp[:, :, 0])
    kw = dict(beam_width=4, blank=0, max_symbols=10, lm_alpha=0.7,
              lm_beta=0.5)
    want = [np.asarray(x) for x in jbeam.beam_search_from_topk(
        lpk, ck, lpb, il, lm=jlm.NGramLM(big, st, eos), **kw)]
    got = [x.numpy() for x in tbeam.beam_search_from_topk(
        torch.from_numpy(lpk), torch.from_numpy(ck), torch.from_numpy(lpb),
        il, lm=tlm.NGramLM(big, st, eos, device="cpu"), **kw)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=5e-4, rtol=0)

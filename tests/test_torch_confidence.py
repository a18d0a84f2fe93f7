"""Decode confidences in the torch port (CPU) against the JAX package's
`ops/confidence.py`.

Tolerance 1e-6 on confidences: the JAX package's float32 exp/log
polynomials (~1 ulp) against libm, on values in [0, 1]; tokens, times,
lengths and word tuples equal.
"""

import numpy as np
import pytest
import torch

from end2end_tpu.ops import confidence as jconf
from end2end_tpu.utils.text import asr_alphabet as jax_alphabet
from end2end_tpu_torch import (aggregate_confidence, frame_confidence,
                               greedy_decode_with_confidence,
                               token_confidence, word_confidences)
from end2end_tpu_torch.utils.text import asr_alphabet

torch.set_num_threads(1)

CONF_TOL = 1e-6


def _lattice(seed, t=24, b=3, v=9, peak=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, b, v)) * (3.0 if peak else 1.0)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("method", ["max_prob", "shannon", "tsallis",
                                    "renyi"])
@pytest.mark.parametrize("exclude_blank", [False, True])
@pytest.mark.parametrize("blank", [0, 5])
def test_frame_confidence_matches_jax(method, exclude_blank, blank):
    lp = _lattice(1)
    for alpha in (1 / 3, 0.7):
        want = np.asarray(jconf.frame_confidence(
            lp, method=method, alpha=alpha, blank=blank,
            exclude_blank=exclude_blank))
        got = frame_confidence(torch.from_numpy(lp), method=method,
                               alpha=alpha, blank=blank,
                               exclude_blank=exclude_blank)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=CONF_TOL, rtol=0)
        assert ((got >= 0) & (got <= 1)).all()


def test_frame_confidence_rejects_bad_arguments():
    lp = torch.from_numpy(_lattice(2))
    with pytest.raises(ValueError, match="method"):
        frame_confidence(lp, method="entropy")
    with pytest.raises(ValueError, match="alpha"):
        frame_confidence(lp, method="tsallis", alpha=1.5)
    with pytest.raises(ValueError, match="non-blank"):
        frame_confidence(lp[..., :2], exclude_blank=True)


@pytest.mark.parametrize("how", ["mean", "min", "prod"])
def test_token_and_aggregate_confidence_match_jax(how):
    rng = np.random.default_rng(4)
    t, n, w, s = 20, 3, 4, 7
    fc = rng.random((t, n)).astype(np.float32)
    times = rng.integers(-1, t + 3, (n, w, s)).astype(np.int32)
    lengths = np.array([[7, 3, 0, 1], [2, 0, 5, 6], [0, 0, 0, 4]], np.int32)
    want = np.asarray(jconf.token_confidence(fc, times, lengths))
    got = token_confidence(torch.from_numpy(fc), times, lengths)
    np.testing.assert_array_equal(got.numpy(), want)
    want_nt = np.asarray(jconf.token_confidence(fc.T, times, lengths,
                                                time_axis_first=False))
    got_nt = token_confidence(torch.from_numpy(fc.T.copy()), times, lengths,
                              time_axis_first=False)
    np.testing.assert_array_equal(got_nt.numpy(), want_nt)
    agg_w = np.asarray(jconf.aggregate_confidence(want, lengths, how))
    agg = aggregate_confidence(got, lengths, how)
    np.testing.assert_allclose(agg.numpy(), agg_w, atol=CONF_TOL, rtol=0)
    assert (agg[lengths == 0] == 1.0).all()  # empty hypotheses give 1
    with pytest.raises(ValueError, match="aggregation"):
        aggregate_confidence(got, lengths, "median")


@pytest.mark.parametrize("method,aggregation,exclude_blank", [
    ("tsallis", "mean", True), ("max_prob", "min", False),
    ("renyi", "prod", True), ("shannon", "mean", False)])
def test_greedy_decode_with_confidence_matches_jax(method, aggregation,
                                                   exclude_blank):
    lp = _lattice(6, t=30, b=4, v=8)
    il = np.array([30, 17, 1, 0], np.int32)
    kw = dict(method=method, aggregation=aggregation,
              exclude_blank=exclude_blank)
    want = [np.asarray(x) for x in jconf.greedy_decode_with_confidence(
        lp, il, **kw)]
    got = [x.numpy() for x in greedy_decode_with_confidence(
        torch.from_numpy(lp), torch.from_numpy(il), **kw)]
    for i in (0, 1, 3):  # tokens, lengths, times
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[4], want[4], atol=CONF_TOL, rtol=0)
    np.testing.assert_allclose(got[5], want[5], atol=CONF_TOL, rtol=0)


def test_greedy_decode_with_confidence_batch_first_from_logits():
    rng = np.random.default_rng(8)
    logits = (2 * rng.standard_normal((3, 16, 6))).astype(np.float32)
    want = [np.asarray(x) for x in jconf.greedy_decode_with_confidence(
        logits, from_logits=True, batch_first=True)]
    got = [x.numpy() for x in greedy_decode_with_confidence(
        torch.from_numpy(logits), from_logits=True, batch_first=True)]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 4, 5):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, rtol=0)


@pytest.mark.parametrize("how", ["mean", "min", "prod"])
def test_word_confidences_match_jax(how):
    ab, jab = asr_alphabet(), jax_alphabet()
    space = ab.encode(" ")[0]
    ids = ab.encode(" hello  big world ")
    times = list(range(3, 3 + 2 * len(ids), 2))
    conf = np.linspace(0.2, 0.95, len(ids)).astype(np.float32)
    want = jconf.word_confidences(ids, times, conf, space_id=space,
                                  alphabet=jab, how=how)
    got = word_confidences(ids, times, conf, space_id=space, alphabet=ab,
                           how=how)
    assert got == want
    assert [w for w, *_ in got] == ["hello", "big", "world"]
    bnd = [ab.encode("b")[0], ab.encode("w")[0]]
    assert word_confidences(ids, times, conf, boundary_ids=bnd, how=how) == (
        jconf.word_confidences(ids, times, conf, boundary_ids=bnd, how=how))
    with pytest.raises(ValueError, match="exactly one"):
        word_confidences(ids, times, conf)

"""Prefix beam search of the torch port (ops/beam_search.py, the plain
versions a CPU tensor runs) against the JAX package.

References: the Pallas beam kernel in interpret mode (`beam_search_pallas`,
the semantics the port keeps at every prune_k) and, at prune_k = V, the XLA
scan (`implementation='xla'`).  Beam sets (prefix -> score) must be equal
with scores within 5e-4, the tolerance of the JAX package's own
kernel-vs-scan tests.
"""

import numpy as np
import pytest
import torch

from end2end_tpu.ops.beam_search import BeamSearchCTCDecoder as JaxDecoder
from end2end_tpu.ops.beam_search import beam_search_decode as jax_beam
from end2end_tpu.ops.beam_search_pallas import beam_search_pallas
from end2end_tpu_torch.ops import beam_search_cuda
from end2end_tpu_torch.ops.lm import WordNGramLM
from end2end_tpu_torch.ops.beam_search import (
    BeamSearchCTCDecoder,
    beam_search_decode,
)

torch.set_num_threads(1)

ATOL = 5e-4


def lsm(x):
    x = np.asarray(x, np.float64)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _beam_sets(tokens, lens, scores):
    tokens, lens, scores = (np.asarray(x) for x in (tokens, lens, scores))
    return [{tuple(tokens[b, w, : int(lens[b, w])].tolist()):
             float(scores[b, w])
             for w in range(tokens.shape[1]) if np.isfinite(scores[b, w])}
            for b in range(tokens.shape[0])]


def _port(lp, il=None, **kw):
    il = None if il is None else torch.from_numpy(il)
    out = beam_search_decode(torch.from_numpy(lp), il, **kw)
    return tuple(x.numpy() for x in out)


def _assert_same_sets(got, want):
    for b, (g, w) in enumerate(zip(_beam_sets(*got[:3]),
                                   _beam_sets(*want[:3]))):
        assert set(g) == set(w), (b, set(g) ^ set(w))
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=ATOL, rtol=0)


def _peaked(rng, T, B, V):
    lp = np.full((T, B, V), np.log(0.003 / (V - 1)))
    ids = np.where(rng.random((T, B)) < 0.5, 0, rng.integers(1, V, (T, B)))
    for t in range(T):
        lp[t, np.arange(B), ids[t]] = np.log(0.997)
    return lsm(lp).astype(np.float32)


@pytest.mark.parametrize("B,T,V,W", [(2, 12, 6, 4), (3, 40, 8, 8),
                                     (2, 25, 40, 8)])
def test_beam_full_vocab_matches_kernel_and_scan(rng, B, T, V, W):
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    il[0] = T
    got = _port(lp, il, beam_width=W)
    _assert_same_sets(got, beam_search_pallas(lp, il, beam_width=W,
                                              interpret=True))
    _assert_same_sets(got, jax_beam(lp, il, beam_width=W,
                                    implementation="xla"))


def test_beam_repeats_and_cap():
    path = [1, 1, 0, 1, 1, 2, 2, 0, 2]
    lp = np.full((9, 1, 4), -12.0)
    for t, c in enumerate(path):
        lp[t, 0, c] = -0.01
    lp = lsm(lp).astype(np.float32)
    tok, lens, _ = _port(lp, beam_width=4)
    assert tok[0, 0, : lens[0, 0]].tolist() == [1, 1, 2, 2]
    _assert_same_sets(_port(lp, beam_width=4),
                      jax_beam(lp, beam_width=4, implementation="xla"))
    got = _port(lp, beam_width=4, max_symbols=2)
    assert got[1].max() <= 2 and got[0].shape == (1, 4, 2)
    _assert_same_sets(got, beam_search_pallas(lp, beam_width=4,
                                              max_symbols=2, interpret=True))


@pytest.mark.parametrize("K", [1, 8])
def test_beam_pruned_matches_kernel_and_top1_scan(rng, K):
    B, T, V, W = 3, 30, 20, 8
    lp = _peaked(rng, T, B, V)
    il = np.array([30, 25, 20], np.int32)
    got = _port(lp, il, beam_width=W, prune_k=K)
    _assert_same_sets(got, beam_search_pallas(lp, il, beam_width=W,
                                              prune_k=K, interpret=True))
    xt, xl, _ = (np.asarray(x) for x in jax_beam(
        lp, il, beam_width=W, prune_k=K, implementation="xla"))
    for b in range(B):
        assert (got[0][b, 0, : got[1][b, 0]].tolist()
                == xt[b, 0, : xl[b, 0]].tolist())


def test_beam_timestamps_match_kernel(rng):
    B, T, V, W = 2, 20, 7, 4
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([20, 14], np.int32)
    got = _port(lp, il, beam_width=W, return_timestamps=True)
    want = [np.asarray(x) for x in beam_search_pallas(
        lp, il, beam_width=W, return_timestamps=True, interpret=True)]
    assert len(got) == 4
    for b in range(B):
        for w in range(W):
            if np.isfinite(got[2][b, w]):
                n = got[1][b, w]
                assert got[0][b, w, :n].tolist() == want[0][b, w, :n].tolist()
                assert got[3][b, w, :n].tolist() == want[3][b, w, :n].tolist()
                assert (np.diff(got[3][b, w, :n]) > 0).all()


def test_beam_dead_beams_and_token_min_logp(rng):
    # W > finite candidates early on: dead beams must score -inf, as in JAX
    lp = lsm(rng.standard_normal((3, 2, 3))).astype(np.float32)
    got = _port(lp, beam_width=8)
    want = [np.asarray(x) for x in beam_search_pallas(lp, beam_width=8,
                                                      interpret=True)]
    np.testing.assert_array_equal(np.isfinite(got[2]), np.isfinite(want[2]))
    _assert_same_sets(got, want)
    lp = lsm(rng.standard_normal((15, 2, 12)) * 2.0).astype(np.float32)
    _assert_same_sets(
        _port(lp, beam_width=4, prune_k=6, token_min_logp=-2.5),
        beam_search_pallas(lp, beam_width=4, prune_k=6, token_min_logp=-2.5,
                           interpret=True))


def test_beam_decoder_class_matches_jax(rng):
    B, T, V = 3, 16, 5
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([16, 11, 6], np.int32)
    labels = "_abcd"
    texts, scores = BeamSearchCTCDecoder(beam_width=4, labels=labels).decode(
        torch.from_numpy(lp), il)
    want_t, want_s = JaxDecoder(beam_width=4, labels=labels,
                                implementation="xla").decode(lp, il)
    assert texts == want_t
    np.testing.assert_allclose(scores, want_s, atol=ATOL)
    beams = BeamSearchCTCDecoder(beam_width=4).decode_beams(
        torch.from_numpy(lp), il, return_timestamps=True)
    beams_bf = BeamSearchCTCDecoder(beam_width=4, batch_first=True)
    assert beams_bf.decode_beams(np.swapaxes(lp, 0, 1), il,
                                 return_timestamps=True) == beams


def test_beam_envelope_and_unported_options(rng):
    lp = torch.from_numpy(lsm(rng.standard_normal((5, 1, 6))).astype(
        np.float32))
    for kw in ({"beam_width": 33}, {"prune_k": 129}):
        with pytest.raises(ValueError):
            beam_search_decode(torch.zeros(4, 1, 200), **kw)
    with pytest.raises(ValueError, match="float32"):
        beam_search_decode(lp.double())
    # still unported: an LM outside the in-kernel envelope under 'auto'
    # (it needs the per-frame LM scan), the scan itself, approx_topk
    word = WordNGramLM([(1,), (2,)], np.zeros((2, 2)), np.zeros(2), 3,
                       device="cpu")
    for kw in ({"lm": object()}, {"lm": word}, {"implementation": "xla"},
               {"approx_topk": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            beam_search_decode(lp, **kw)
    with pytest.raises(ValueError, match="implementation"):
        beam_search_decode(lp, implementation="scan")
    with pytest.raises(ValueError, match="CUDA"):
        beam_search_cuda.beam_step_cuda(
            torch.zeros(5, 1, 6), torch.zeros(5, 1, 6, dtype=torch.int32),
            torch.zeros(5, 1), torch.full((1,), 5, dtype=torch.int32),
            4, 6, 5, 0)
    # max_symbols defaults to min(T, 512)
    long = torch.full((600, 1, 3), -1.0986123)
    assert beam_search_decode(long, beam_width=2)[0].shape == (1, 2, 512)
    # a half-precision lattice is decoded in float32
    full = beam_search_decode(lp, beam_width=4)
    half = beam_search_decode(lp.to(torch.bfloat16), beam_width=4)
    assert half[2].dtype == torch.float32 and full[0].shape == half[0].shape


def test_prefix_hash_wraps_like_int32(rng):
    h = rng.integers(-2**31, 2**31, 1000).astype(np.int32)
    c = rng.integers(0, 5000, 1000).astype(np.int32)
    with np.errstate(over="ignore"):
        for m in (beam_search_cuda._M1, beam_search_cuda._M2):
            want = h * np.uint32(m).astype(np.int32) + (c + 1)
            got = beam_search_cuda._wrap32(
                torch.from_numpy(h).long() * m + torch.from_numpy(c).long()
                + 1)
            np.testing.assert_array_equal(got.numpy(), want)

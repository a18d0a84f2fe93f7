"""LM shallow fusion in the torch port's beam search (plain versions, CPU)
against the JAX package.

References: the Pallas beam kernel with in-kernel bigram fusion in
interpret mode (`beam_search_pallas(lm=NGramLM)`), the chunked decode
(`beam_search_chunked_lm`, interpret mode) with every LM and guide kind of
the slice, and `rescore_nbest`.  Beam sets (prefix -> score) must be equal,
tokens and lengths identical, scores within 5e-4: the JAX interpret kernel
uses its fastmath polynomials, the port libm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import lm as jlm
from end2end_tpu.ops.beam_chunked import beam_search_chunked_lm as jax_chunked
from end2end_tpu.ops.beam_search import beam_search_decode as jax_beam
from end2end_tpu.ops.beam_search_pallas import beam_search_pallas
from end2end_tpu.ops.rescore import rescore_nbest as jax_rescore
from end2end_tpu_torch.ops import beam_search_cuda, lm as tlm
from end2end_tpu_torch.ops.beam_chunked import beam_search_chunked_lm
from end2end_tpu_torch.ops.beam_search import (
    BeamSearchCTCDecoder,
    beam_search_decode,
)
from end2end_tpu_torch.ops.rescore import rescore_nbest

torch.set_num_threads(1)

ATOL = 5e-4


def lsm(x):
    x = np.asarray(x, np.float64)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _sets(tokens, lens, scores):
    tokens, lens, scores = (np.asarray(x) for x in (tokens, lens, scores))
    return [{tuple(tokens[b, w, : int(lens[b, w])].tolist()):
             float(scores[b, w])
             for w in range(tokens.shape[1]) if np.isfinite(scores[b, w])}
            for b in range(tokens.shape[0])]


def _assert_same(got, want):
    """Same beam sets, scores within ATOL, and the same ranked tokens and
    lengths."""
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    for b, (g, w) in enumerate(zip(_sets(*got[:3]), _sets(*want[:3]))):
        assert set(g) == set(w), (b, set(g) ^ set(w))
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_array_equal(got[1][:, 0], want[1][:, 0])
    if len(got) == 4:
        for b in range(got[0].shape[0]):
            n = got[1][b, 0]
            np.testing.assert_array_equal(got[3][b, 0, :n], want[3][b, 0, :n])


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _peaked(rng, T, B, V, peak=0.9995):
    lp = np.full((T, B, V), np.log((1 - peak) / (V - 1)))
    ids = np.where(rng.random((T, B)) < 0.5, 0, rng.integers(1, V, (T, B)))
    for t in range(T):
        lp[t, np.arange(B), ids[t]] = np.log(peak)
    return lsm(lp).astype(np.float32)


def bigram_pair(rng, V, start=True, eos=True):
    """The same dense bigram LM in both packages."""
    big = jlm.bigram_from_counts(rng.integers(0, 20, (V, V)))
    st = rng.standard_normal(V).astype(np.float32) if start else None
    eo = rng.standard_normal(V).astype(np.float32) if eos else None
    return (jlm.NGramLM(big, start_logp=st, eos_logp=eo),
            tlm.NGramLM(big, start_logp=st, eos_logp=eo, device="cpu"))


def word_pair(rng, bpe=False):
    """The same word bigram in both packages: separator mode over tokens
    1, 2 with space 3, or BPE prefix mode with word starters {1, 3}."""
    if bpe:
        words, space = [(1, 2), (3,), (1, 4), (3, 2, 2)], None
        kw = {"boundary_ids": [1, 3]}
    else:
        words, kw, space = [(1,), (2,), (1, 2), (2, 1)], {}, 3
    wv = len(words)
    args = (words,
            np.log(np.maximum(rng.random((wv, wv)), 0.05)).astype(np.float32),
            rng.standard_normal(wv).astype(np.float32), space)
    kw.update(unigram_logp=rng.standard_normal(wv).astype(np.float32),
              eos_logp=rng.standard_normal(wv).astype(np.float32),
              unk_logp=-3.0)
    return (jlm.WordNGramLM(*args, **kw),
            tlm.WordNGramLM(*args, **kw, device="cpu"))


@pytest.mark.parametrize("W,K", [(4, None), (8, None), (32, None), (8, 4)])
def test_fused_bigram_matches_kernel(rng, W, K):
    B, T, V = 3, 24, 7
    jl, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([24, 19, 11], np.int32)
    a, b = 0.6, 0.3
    got = beam_search_decode(_t(lp), _t(il), beam_width=W, prune_k=K, lm=tl,
                             lm_alpha=a, lm_beta=b, return_timestamps=True)
    want = beam_search_pallas(lp, il, beam_width=W, prune_k=K, lm=jl,
                              lm_alpha=a, lm_beta=b, interpret=True,
                              return_timestamps=True)
    _assert_same(got, want)
    # 'pallas' is the same kernel path
    forced = beam_search_decode(_t(lp), _t(il), beam_width=W, prune_k=K,
                                lm=tl, lm_alpha=a, lm_beta=b,
                                implementation="pallas")
    for x, y in zip(forced, got):
        assert torch.equal(x, y)


def test_fused_bigram_changes_the_winner_like_jax(rng):
    # an opinionated LM on a diffuse lattice moves the best hypothesis
    B, T, V, W = 2, 16, 5, 4
    big = np.full((V, V), np.log(0.02), np.float32)
    big[1, 2] = big[2, 1] = np.log(0.9)
    jl = jlm.NGramLM(big)
    tl = tlm.NGramLM(big, device="cpu")
    lp = lsm(rng.standard_normal((T, B, V)) * 0.5).astype(np.float32)
    plain = beam_search_decode(_t(lp), beam_width=W)
    got = beam_search_decode(_t(lp), beam_width=W, lm=tl, lm_alpha=2.0)
    _assert_same(got, beam_search_pallas(lp, beam_width=W, lm=jl,
                                         lm_alpha=2.0, interpret=True))
    assert not torch.equal(got[0][:, 0], plain[0][:, 0])


def _chunked_pair(lp, il, jl, tl, chunk, W=8, K=None, jg=None, tg=None,
                  a=0.7, b=0.2, **kw):
    got = beam_search_chunked_lm(_t(lp), _t(il), beam_width=W, prune_k=K,
                                 lm=tl, lm_alpha=a, lm_beta=b, chunk_t=chunk,
                                 guide_lm=tg, **kw)
    want = jax_chunked(lp, il, beam_width=W, prune_k=K, lm=jl, lm_alpha=a,
                       lm_beta=b, chunk_t=chunk, guide_lm=jg, interpret=True,
                       **kw)
    _assert_same(got, want)
    return got


@pytest.mark.parametrize("name,chunk", [("bigram", 5), ("word", 4),
                                        ("word", 7), ("bpe", 6)])
def test_chunked_matches_jax(rng, name, chunk):
    B, T, V = 3, 26, 5
    jl, tl = (bigram_pair(rng, V) if name == "bigram"
              else word_pair(rng, bpe=name == "bpe"))
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([26, 20, 13], np.int32)
    _chunked_pair(lp, il, jl, tl, chunk, return_timestamps=True)
    _chunked_pair(_peaked(rng, T, B, V), il, jl, tl, chunk, K=3)


@pytest.mark.parametrize("guide", ["symbol", "class"])
def test_chunked_with_guide_matches_jax(rng, guide):
    B, T, V = 3, 30, 6
    jl, tl = word_pair(rng)
    jg, tg = bigram_pair(rng, V, eos=False)
    if guide == "class":
        jg = jlm.QuantizedBigramGuide.from_bigram(jg, n_classes=3, iters=4)
        tg = tlm.QuantizedBigramGuide.from_bigram(tg, n_classes=3, iters=4)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([30, 23, 9], np.int32)
    _chunked_pair(lp, il, jl, tl, 7, jg=jg, tg=tg, a=0.8, b=0.4)


def test_class_guide_at_large_vocab_matches_jax(rng):
    # V = 80: past the 64-row symbol-keyed cap, the class-keyed guide steers
    B, T, V, W = 2, 20, 80, 4
    jl, tl = bigram_pair(rng, V)
    jg = jlm.QuantizedBigramGuide.from_bigram(jl, n_classes=4, iters=4)
    tg = tlm.QuantizedBigramGuide.from_bigram(tl, n_classes=4, iters=4)
    np.testing.assert_array_equal(tg._cls_map.numpy(),
                                  np.asarray(jg._cls_map))
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([20, 15], np.int32)
    _chunked_pair(lp, il, jl, tl, 8, W=W, K=6, jg=jg, tg=tg, a=0.5, b=0.1)


def test_guide_equal_to_lm_reproduces_fused_decode(rng):
    # guide == lm (dense bigram): the guided chunked decode is the fused
    # kernel decode, whatever the chunk width (the JAX package's identity)
    B, T, V, W = 2, 21, 5, 4
    _, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    fused = beam_search_decode(_t(lp), beam_width=W, lm=tl, lm_alpha=0.9,
                               lm_beta=0.1)
    chunked = beam_search_chunked_lm(_t(lp), beam_width=W, lm=tl,
                                     guide_lm=tl, lm_alpha=0.9, lm_beta=0.1,
                                     chunk_t=6)
    assert torch.equal(chunked[0], fused[0])
    torch.testing.assert_close(chunked[2], fused[2], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["bigram", "word", "bpe"])
def test_one_chunk_equals_rescored_nolm_decode(rng, name):
    B, T, V, W = 3, 18, 5, 8
    jl, tl = (bigram_pair(rng, V) if name == "bigram"
              else word_pair(rng, bpe=name == "bpe"))
    lp = _t(lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32))
    il = _t(np.array([18, 12, 9], np.int32))
    a, b = 0.8, 0.3
    one = beam_search_chunked_lm(lp, il, beam_width=W, lm=tl, lm_alpha=a,
                                 lm_beta=b, chunk_t=64)
    # K = V: the no-LM path's +8 stay window and the chunked path's top-K
    # are both the whole vocabulary
    nt, nl, ns = beam_search_decode(lp, il, beam_width=W)
    rescored = rescore_nbest(nt, nl, ns, tl, lm_alpha=a, lm_beta=b)
    for g, w in zip(_sets(*one), _sets(*rescored)):
        assert set(g) == set(w)
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["bigram", "word", "bpe"])
def test_rescore_nbest_matches_jax(rng, name):
    B, T, V, W = 3, 15, 5, 4
    jl, tl = (bigram_pair(rng, V) if name == "bigram"
              else word_pair(rng, bpe=name == "bpe"))
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    nt, nl, ns, times = beam_search_decode(_t(lp), beam_width=W,
                                           return_timestamps=True)
    got = rescore_nbest(nt, nl, ns, tl, lm_alpha=0.7, lm_beta=0.4,
                        times=times)
    want = jax_rescore(jnp.asarray(nt.numpy()), jnp.asarray(nl.numpy()),
                       jnp.asarray(ns.numpy()), jl, lm_alpha=0.7,
                       lm_beta=0.4, times=jnp.asarray(times.numpy()))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=0)
    for x, y in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_decoder_class_with_lm_matches_jax(rng):
    from end2end_tpu.ops.beam_search import BeamSearchCTCDecoder as JaxDec

    B, T, V = 2, 14, 5
    jl, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    texts, scores = BeamSearchCTCDecoder(
        beam_width=4, labels="_abcd", lm=tl, lm_alpha=0.5,
        lm_beta=0.2).decode(_t(lp))
    want_t, want_s = JaxDec(beam_width=4, labels="_abcd", lm=jl,
                            lm_alpha=0.5, lm_beta=0.2,
                            implementation="pallas").decode(lp)
    assert texts == want_t
    np.testing.assert_allclose(scores, want_s, atol=ATOL)


def test_routing_and_validation_match_jax(rng):
    lp = lsm(rng.standard_normal((6, 1, 5))).astype(np.float32)
    jl, tl = bigram_pair(rng, 5)
    for impl in ("auto", "pallas"):  # a guide without 'chunked'
        with pytest.raises(ValueError, match="guide_lm"):
            jax_beam(lp, lm=jl, guide_lm=jl, implementation=impl)
        with pytest.raises(ValueError, match="guide_lm"):
            beam_search_decode(_t(lp), lm=tl, guide_lm=tl,
                               implementation=impl)
    # V + 1 > 64 under 'pallas'
    big = lsm(rng.standard_normal((4, 1, 64))).astype(np.float32)
    jb, tb = bigram_pair(rng, 64)
    with pytest.raises(ValueError, match="vocab \\+ 1 <= 64"):
        jax_beam(big, lm=jb, implementation="pallas")
    with pytest.raises(ValueError, match="vocab \\+ 1 <= 64"):
        beam_search_decode(_t(big), lm=tb, implementation="pallas")
    # ... and under 'auto' both run the per-frame scan
    _assert_same(beam_search_decode(_t(big), lm=tb, lm_alpha=0.5),
                 jax_beam(big, lm=jb, lm_alpha=0.5))
    # 'chunked' needs an LM with score_chunk
    for fn in (jax_beam, beam_search_decode):
        with pytest.raises(ValueError, match="score_chunk"):
            fn(lp if fn is jax_beam else _t(lp), implementation="chunked")
    # a word LM as guide, and a guide over another vocabulary
    jw, tw = word_pair(rng)
    _, t6 = bigram_pair(rng, 6)
    for guide in (tw, t6):
        with pytest.raises(ValueError, match="guide_lm"):
            beam_search_chunked_lm(_t(lp), lm=tl, guide_lm=guide)
    with pytest.raises(ValueError, match="guide_lm"):
        jax_chunked(lp, lm=jl, guide_lm=jw)
    # class-guide validation
    with pytest.raises(ValueError, match="cls_map"):
        tlm.QuantizedBigramGuide(np.array([0, 1, 2, 3, 9]),
                                 np.zeros((3, 5)), device="cpu")
    # an LM on another device than the lattice
    meta = tlm.NGramLM(np.zeros((5, 5), np.float32), device="meta")
    with pytest.raises(ValueError, match="device"):
        beam_search_decode(_t(lp), lm=meta)


def _assert_scan(got, want, tol=1e-5):
    """The scan against JAX's: the same ranked tokens, lengths and
    frames, scores within tol."""
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    for b, (g, w) in enumerate(zip(_sets(*got[:3]), _sets(*want[:3]))):
        assert set(g) == set(w), (b, set(g) ^ set(w))
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=tol, rtol=0)
    for x, y in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_bigram_scan_past_the_kernel_matches_jax(rng, impl):
    """A dense bigram at V + 1 > 64 (outside the in-kernel envelope) runs
    the per-frame scan under 'auto'; 'xla' runs it too; both against
    JAX's scan, start and end-of-sequence rows included."""
    B, T, V = 3, 18, 80
    jl, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([18, 12, 6], np.int32)
    kw = dict(beam_width=8, prune_k=12, lm_alpha=0.5, lm_beta=0.2,
              return_timestamps=True)
    got = beam_search_decode(_t(lp), _t(il), lm=tl, implementation=impl,
                             **kw)
    _assert_scan(got, jax_beam(lp, il, lm=jl, implementation="xla", **kw))


@pytest.mark.parametrize("bpe", [False, True])
def test_word_lm_scan_matches_jax(rng, bpe):
    """A word bigram (separator or BPE prefix mode) fused per frame: the
    scan under 'auto', against JAX's scan."""
    B, T, V = 3, 22, 5
    jl, tl = word_pair(rng, bpe=bpe)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([22, 17, 9], np.int32)
    kw = dict(beam_width=6, lm_alpha=0.7, lm_beta=0.3,
              return_timestamps=True)
    got = beam_search_decode(_t(lp), _t(il), lm=tl, **kw)
    _assert_scan(got, jax_beam(lp, il, lm=jl, implementation="xla", **kw))


def test_in_kernel_bigram_under_xla_runs_the_scan(rng):
    """'xla' takes the scan even where the kernel would fuse the LM: JAX's
    'xla' to 1e-5, and the kernel path's beam sets to 5e-4 (the kernel's
    ks-slot stay window is the whole vocabulary here)."""
    B, T, V = 3, 20, 7
    jl, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    kw = dict(beam_width=8, lm_alpha=0.6, lm_beta=0.3)
    got = beam_search_decode(_t(lp), lm=tl, implementation="xla", **kw)
    _assert_scan(got, jax_beam(lp, lm=jl, implementation="xla", **kw))
    _assert_same(got, beam_search_decode(_t(lp), lm=tl, **kw))


def test_decoder_class_with_lm_scan_matches_jax(rng):
    """BeamSearchCTCDecoder with a word LM goes through the scan."""
    from end2end_tpu.ops.beam_search import BeamSearchCTCDecoder as JaxDec

    B, T, V = 2, 16, 5
    jl, tl = word_pair(rng)
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    kw = dict(beam_width=6, labels="_ab c", lm_alpha=0.5, lm_beta=0.2)
    texts, scores = BeamSearchCTCDecoder(lm=tl, **kw).decode(_t(lp))
    want_t, want_s = JaxDec(lm=jl, implementation="xla", **kw).decode(lp)
    assert texts == want_t
    np.testing.assert_allclose(scores, want_s, atol=1e-5, rtol=0)


def test_plain_state_in_out_resumes_exactly(rng):
    # two resumed halves == one pass, for every LM mode of the beam step
    T, B, V, W, K = 20, 3, 9, 4, 5
    lp = _t(lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32))
    lpk, ck = torch.sort(lp, dim=-1, descending=True, stable=True)
    lpk, ck = lpk[..., :K].contiguous(), ck[..., :K].to(torch.int32)
    lpb = lp[:, :, 0].contiguous()
    il = torch.tensor([20, 13, 6], dtype=torch.int32)
    def table(c):
        return torch.from_numpy(rng.standard_normal((c, V)).astype(
            np.float32))

    cls_map = torch.from_numpy(rng.integers(0, 3, V).astype(np.int32))
    for kw in ({}, {"inc": table(V + 1)},
               {"inc": table(4), "cls_map": cls_map}):
        whole = beam_search_cuda.beam_step_plain(lpk, ck, lpb, il, W, K, 12,
                                                 0, **kw)
        s0 = beam_search_cuda.beam_state_init(W, B)
        first = beam_search_cuda.beam_step_plain(
            lpk[:9], ck[:9], lpb[:9], il, W, K, 12, 0, state_in=s0, **kw)
        second = beam_search_cuda.beam_step_plain(
            lpk[9:], ck[9:], lpb[9:], il - 9, W, K, 12, 0,
            state_in=first[3], **kw)
        assert torch.equal(torch.cat([first[0], second[0]]), whole[0])
        for x, y in zip(second[3], whole[3]):
            assert torch.equal(x, y)
        assert torch.equal(second[1], whole[1])


# --- the rest of LM fusion: hashed, composite and neural LMs on every
# decode path; the chunked entry points' API repairs ---


def protocol_lm_pair(rng, name):
    """(JAX LM, port LM) over tokens 1-4 (space 4): a hashed word trigram
    ('word3'), a hashed token trigram ('token3'), the word trigram plus a
    hotword booster ('composite') or a GRU ('neural')."""
    from end2end_tpu.ops import neural_lm as jnl
    from end2end_tpu_torch.ops import neural_lm as tnl

    from .test_torch_lm_hashed import (composite_pair, rand_ngrams,
                                       word_lm_pair)

    if name == "word3":
        return word_lm_pair(rng, 3)
    if name == "composite":
        return composite_pair(rng)
    if name == "token3":
        ng = rand_ngrams(rng, 6, 3)
        return (jlm.HashedNGramLM(3, ng, 6),
                tlm.HashedNGramLM(3, ng, 6, device="cpu"))
    params = tnl.random_gru_params(rng, 6, emb_dim=6, hidden_dim=10)
    import jax

    return (jnl.NeuralLM.gru(params, eos_id=2,
                             precision=jax.lax.Precision.HIGHEST),
            tnl.NeuralLM.gru(params, eos_id=2, device="cpu"))


class ProtocolOnly:
    """An LM with score/select/final and no score_chunk (rescoring's
    per-token fallback), wrapping another."""

    def __init__(self, lm):
        self._lm = lm

    def __getattr__(self, name):
        if name == "score_chunk":
            raise AttributeError(name)
        return getattr(self._lm, name)


@pytest.mark.parametrize("name", ["word3", "token3", "composite", "neural"])
def test_scan_with_protocol_lms_matches_jax(rng, name):
    B, T, V = 3, 20, 6
    jl, tl = protocol_lm_pair(rng, name)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([20, 14, 9], np.int32)
    kw = dict(beam_width=6, prune_k=5, lm_alpha=0.7, lm_beta=0.3,
              return_timestamps=True)
    got = beam_search_decode(_t(lp), _t(il), lm=tl, implementation="xla",
                             **kw)
    _assert_scan(got, jax_beam(lp, il, lm=jl, implementation="xla", **kw))


@pytest.mark.parametrize("name", ["word3", "composite", "neural"])
def test_chunked_with_protocol_lms_matches_jax(rng, name):
    B, T, V = 3, 26, 6
    jl, tl = protocol_lm_pair(rng, name)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([26, 19, 11], np.int32)
    _chunked_pair(lp, il, jl, tl, 7, W=6, return_timestamps=True)


@pytest.mark.parametrize("name", ["word3", "composite", "neural"])
def test_rescore_by_both_routes_matches_jax(rng, name):
    """score_chunk and the per-token fallback (an LM without score_chunk)
    against JAX's rescore_nbest, and against each other."""
    B, T, V, W = 3, 15, 6, 4
    jl, tl = protocol_lm_pair(rng, name)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    nt, nl, ns = beam_search_decode(_t(lp), beam_width=W)
    want = jax_rescore(jnp.asarray(nt.numpy()), jnp.asarray(nl.numpy()),
                       jnp.asarray(ns.numpy()), jl, lm_alpha=0.7,
                       lm_beta=0.4)
    chunk = rescore_nbest(nt, nl, ns, tl, lm_alpha=0.7, lm_beta=0.4)
    fold = rescore_nbest(nt, nl, ns, ProtocolOnly(tl), lm_alpha=0.7,
                         lm_beta=0.4)
    jfold = jax_rescore(jnp.asarray(nt.numpy()), jnp.asarray(nl.numpy()),
                        jnp.asarray(ns.numpy()), ProtocolOnly(jl),
                        lm_alpha=0.7, lm_beta=0.4)
    for got in (chunk, fold):
        for ref in (want, jfold):
            np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                       atol=1e-5, rtol=0)
            for x, y in zip(got[:2], ref[:2]):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("name", ["word3", "composite", "bigram80"])
def test_from_topk_with_protocol_lms_matches_jax(rng, name):
    """beam_search_from_topk with an LM outside the fused kernel: the
    candidate-only scan, against JAX's."""
    from end2end_tpu.ops.beam_search import beam_search_from_topk as jft
    from end2end_tpu_torch.ops.beam_search import beam_search_from_topk

    B, T, V, K, W = 3, 18, 6, 4, 5
    if name == "bigram80":  # a dense bigram past the kernel's 64 rows
        V = 80
        jl, tl = bigram_pair(rng, V)
    else:
        jl, tl = protocol_lm_pair(rng, name)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([18, 12, 6], np.int32)
    lpk, ck = torch.sort(_t(lp), dim=-1, descending=True, stable=True)
    lpk, ck = lpk[..., :K].contiguous(), ck[..., :K].to(torch.int32)
    lpb = _t(lp[:, :, 0])
    got = beam_search_from_topk(lpk, ck, lpb, _t(il), W, 0, 12, lm=tl,
                                lm_alpha=0.6, lm_beta=0.2,
                                return_timestamps=True)
    want = jft(jnp.asarray(lpk.numpy()), jnp.asarray(ck.numpy()),
               jnp.asarray(lp[:, :, 0]), jnp.asarray(il), W, 0, 12, lm=jl,
               lm_alpha=0.6, lm_beta=0.2, return_timestamps=True)
    _assert_scan(got, want)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_approx_topk_matches_jax(rng, impl):
    """approx_topk=True: JAX's lax.approx_max_k is exact off the TPU, and
    the port's top-k is exact: the kernel path against JAX's kernel in
    interpret mode, the scan against JAX's scan (prune_k < V)."""
    B, T, V = 3, 18, 12
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([18, 13, 7], np.int32)
    kw = dict(beam_width=6, prune_k=5, approx_topk=True,
              return_timestamps=True)
    got = beam_search_decode(_t(lp), _t(il), implementation=impl, **kw)
    if impl == "auto":
        _assert_same(got, beam_search_pallas(lp, il, interpret=True, **kw))
    else:
        _assert_scan(got, jax_beam(lp, il, implementation="xla", **kw))
    exact = beam_search_decode(_t(lp), _t(il), implementation=impl,
                               **{**kw, "approx_topk": False})
    for a, b in zip(got, exact):
        assert torch.equal(a, b)


def test_chunked_float64_matches_jax(rng):
    """A float64 lattice is decoded in float32, as JAX's chunked entry
    points do (it raised before); the same from precomputed candidates."""
    from end2end_tpu.ops.beam_chunked import (
        beam_search_chunked_lm_from_topk as jax_from_topk)
    from end2end_tpu_torch.ops.beam_chunked import (
        beam_search_chunked_lm_from_topk)

    B, T, V = 2, 40, 8
    jl, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5)  # float64
    il = np.array([40, 27], np.int32)
    got = _chunked_pair(lp, il, jl, tl, 16)
    assert got[2].dtype == torch.float32
    lpk, ck = torch.sort(_t(lp), dim=-1, descending=True, stable=True)
    lpk, ck = lpk[..., :5], ck[..., :5].to(torch.int32)
    kw = dict(v=V, beam_width=8, lm_alpha=0.7, lm_beta=0.2, chunk_t=16)
    got = beam_search_chunked_lm_from_topk(lpk, ck, _t(lp[:, :, 0]),
                                           _t(il), lm=tl, **kw)
    want = jax_from_topk(lpk.numpy(), ck.numpy(), lp[:, :, 0], il, lm=jl,
                         interpret=True, **kw)
    _assert_same(got, want)


def test_chunked_takes_jax_positional_arguments(rng):
    """`interpret` stands in JAX's 11th position (accepted, ignored), so a
    positional call in JAX's order binds return_timestamps right."""
    B, T, V = 2, 20, 5
    jl, tl = bigram_pair(rng, V)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([20, 13], np.int32)
    args = (8, 0, None, None)  # beam_width, blank, prune_k, max_symbols
    got = beam_search_chunked_lm(_t(lp), _t(il), *args, tl, 0.7, 0.2, 6,
                                 None, True)
    want = jax_chunked(lp, il, *args, jl, 0.7, 0.2, 6, True, True)
    assert len(got) == len(want) == 4
    _assert_same(got, want)
    for flag in (False, True):
        again = beam_search_chunked_lm(_t(lp), _t(il), lm=tl, lm_alpha=0.7,
                                       lm_beta=0.2, chunk_t=6,
                                       interpret=flag,
                                       return_timestamps=True)
        for a, b in zip(again, got):
            assert torch.equal(a, b)


def test_init_state_takes_jax_argument_name(rng):
    """init_state(w=...) as in JAX, for both ported bigram LMs."""
    jb, tb = bigram_pair(rng, 5)
    jw, tw = word_pair(rng)
    for jl, tl in ((jb, tb), (jw, tw)):
        got, want = tl.init_state(w=3), jl.init_state(w=3)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

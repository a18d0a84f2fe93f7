"""The torch port's LM training and ARPA parsing (utils/lm_train.py,
utils/arpa.py) against the JAX package's (CPU).

The port keeps its own copy of the pure-Python Kneser-Ney estimator: the
n-gram lists must be equal and the ARPA text identical.  The emitted
backoff model must stay normalised (every context sums to 1 within 1e-9
in float64 through the port's `ArpaScorer`), `parse_arpa_order` must
equal JAX's Python parser (and its native float32 parser to a float32
ulp), and `word_lm_from_corpus` must give JAX's word LM.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.utils import arpa as jarpa
from end2end_tpu.utils import lm_train as jtrain
from end2end_tpu.utils import native
from end2end_tpu.utils.text import asr_alphabet as jax_alphabet
from end2end_tpu_torch.ops.beam_search import beam_search_decode
from end2end_tpu_torch.utils import arpa as tarpa
from end2end_tpu_torch.utils import lm_train as ttrain
from end2end_tpu_torch.utils.text import asr_alphabet

torch.set_num_threads(1)


def _corpus(rng, v=8, n_sent=40, max_len=12):
    """Skewed random corpus: token i drawn with weight ~ (i+1)^2."""
    w = (np.arange(v) + 1.0) ** 2
    w /= w.sum()
    return [[str(t) for t in rng.choice(v, size=rng.integers(1, max_len + 1),
                                        p=w)]
            for _ in range(n_sent)]


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("kw", [{}, {"include_unk": False},
                                {"discount": 0.5, "vocab": list("01234567x")}])
def test_train_and_render_match_jax(order, kw):
    rng = np.random.default_rng(order)
    corpus = _corpus(rng)
    got = ttrain.train_ngram_lm(corpus, order=order, **kw)
    want = jtrain.train_ngram_lm(corpus, order=order, **kw)
    assert got == want
    assert ttrain.render_arpa(*got) == jtrain.render_arpa(*want)
    assert (ttrain.train_ngram_arpa(corpus, order, **kw)
            == jtrain.train_ngram_arpa(corpus, order, **kw))
    # whitespace-joined sentences are split into tokens, as in JAX
    text = [" ".join(s) for s in corpus]
    assert ttrain.train_ngram_lm(text, order=order, **kw) == got


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_every_context_sums_to_one(order):
    """sum over vocab + </s> + <unk> of p(w | ctx) == 1 (float64) for
    empty, <s>-initial and unseen-token contexts."""
    rng = np.random.default_rng(order)
    _, ngrams, vocab = ttrain.train_ngram_lm(_corpus(rng), order=order)
    v = len(vocab)
    sc = tarpa.ArpaScorer(order, ngrams, v)
    ctxs = [[], [sc.bos], [sc.bos, 0], [v + 5]]
    ctxs += [[int(rng.integers(0, v + 6)) for _ in range(int(
        rng.integers(0, 4)))] for _ in range(40)]
    for ctx in ctxs:
        total = sum(math.exp(sc.score(ctx, w)) for w in range(v))
        total += math.exp(sc.score(ctx, sc.eos))
        total += math.exp(sc.score(ctx, v + 7))  # the <unk> chain
        assert abs(total - 1.0) < 1e-9, (ctx, total)


_ARPA4 = (
    "\\data\\\nngram 1=7\nngram 2=5\nngram 3=4\nngram 4=1\n\n\\1-grams:\n"
    "-1.9 <unk>\n-0.3 <s> -0.2\n-0.9 </s>\n"
    "-0.5 a -0.25\n-0.5 b -0.2\n-0.9 c\n-1.1 zz -0.3\n\n"
    "\\2-grams:\n-0.4 <s> a -0.1\n-0.4 a b -0.1\n-0.5 b b\n-0.9 b c -0.05\n"
    "-0.7 zz a\n\n"
    "\\3-grams:\n-0.05 a b c -0.01\n-0.1 b b a\n-0.2 a b </s>\n"
    "-0.3 <unk> a b\n\n"
    "\\4-grams:\n-0.15 <s> a b c\n\n\\end\\\n")


def test_parse_arpa_order_matches_jax(tmp_path):
    """The Python parser equal to JAX's (<unk> unigram, an out-of-vocabulary
    word and an <unk> gram dropped); the default (the native parser where
    it builds) equal to JAX's default, and within one float32 ulp of the
    Python parser (the native one multiplies by ln 10 in float32)."""
    path = tmp_path / "order4.arpa"
    path.write_text(_ARPA4)
    vocab = ["a", "b", "c"]
    got = tarpa.parse_arpa_order(str(path), vocab, prefer_native=False)
    assert got == jarpa.parse_arpa_order(str(path), vocab,
                                         prefer_native=False)
    assert (tarpa.parse_arpa_order(str(path), vocab)
            == jarpa.parse_arpa_order(str(path), vocab))
    order, ng = got
    assert order == 4 and len(ng[1]) == 5 and len(ng[3]) == 3
    if native.available():
        n_order, n_ng = tarpa.parse_arpa_order(str(path), vocab)
        assert n_order == order
        def ulp1(x, y):
            np.testing.assert_array_max_ulp(np.float32(x), np.float32(y), 1)

        ulp1(n_ng["unk"], ng["unk"])
        for k in range(1, order + 1):
            a, b = sorted(ng[k]), sorted(n_ng[k])
            assert [g for g, _, _ in a] == [g for g, _, _ in b]
            for (_, la, ba), (_, lb, bb) in zip(a, b):
                ulp1([la, ba], [lb, bb])


def test_arpa_scorer_matches_jax(tmp_path):
    path = tmp_path / "order4.arpa"
    path.write_text(_ARPA4)
    vocab = ["a", "b", "c"]
    got = tarpa.ArpaScorer.from_file(str(path), vocab)
    want = jarpa.ArpaScorer.from_file(str(path), vocab)
    assert (got.order, got.bos, got.eos, got.unk) == (
        want.order, want.bos, want.eos, want.unk)
    rng = np.random.default_rng(0)
    for _ in range(200):
        ctx = [int(x) for x in rng.integers(0, 6, int(rng.integers(0, 5)))]
        w = int(rng.integers(0, 6))
        assert got.score(ctx, w) == want.score(ctx, w)
    assert tarpa.ArpaScorer.from_file(str(path), vocab,
                                      unk_logp=-5.0).unk == -5.0


@pytest.mark.parametrize("bpe", [False, True])
def test_word_lm_from_corpus_matches_jax(bpe):
    """A word trigram trained on a corpus, in separator mode over the ASR
    alphabet or in BPE mode from spellings: the same scores and states
    as JAX's over token streams with words out of the corpus."""
    rng = np.random.default_rng(3)
    words = ["the", "cat", "cab", "sat", "on", "mat", "a"]
    sents = [list(rng.choice(words, int(rng.integers(1, 7))))
             for _ in range(30)]
    if bpe:
        vocab = sorted({w for s in sents for w in s})
        spell = [(1 + i % 3, 4 + i // 3) for i in range(len(vocab))]
        kw = {"spellings": spell, "boundary_ids": [1, 2, 3]}
        jl = jtrain.word_lm_from_corpus(sents, None, order=3, **kw)
        tl = ttrain.word_lm_from_corpus(sents, None, order=3, **kw,
                                        device="cpu")
        toks = rng.integers(1, 8, (6, 24))
    else:
        jl = jtrain.word_lm_from_corpus(sents, jax_alphabet(), order=3)
        tl = ttrain.word_lm_from_corpus(sents, asr_alphabet(), order=3,
                                        device="cpu")
        ab = asr_alphabet()
        text = [" ".join(rng.choice(words + ["dog"], 5)) for _ in range(6)]
        toks = np.full((6, 40), -1)
        for i, t in enumerate(text):
            ids = ab.encode(t)[:40 - i]  # some rows end inside a word
            toks[i, :len(ids)] = ids
    toks = toks.astype(np.int32)
    lp_t, st_t = tl.score_chunk(tl.init_state(6), torch.from_numpy(toks))
    lp_j, st_j = jl.score_chunk(jl.init_state(6), jnp.asarray(toks))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5)
    for a, b in zip(st_t, st_j):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).astype(np.int64))
    np.testing.assert_allclose(tl.final(st_t).numpy(),
                               np.asarray(jl.final(st_j)), atol=1e-5)


def test_word_lm_from_corpus_steers_the_decode():
    """Trained from text and fused into the scan, the word LM flips an
    acoustically ambiguous last letter to the corpus's word."""
    alphabet = asr_alphabet()
    lm = ttrain.word_lm_from_corpus([["the", "cat"]] * 12 + [["the", "cab"]],
                                    alphabet, order=2, device="cpu")
    ids, ids_b = alphabet.encode("the cat"), alphabet.encode("the cab")
    T, V = len(ids) + 2, len(alphabet)
    lat = np.full((T, 1, V), -12.0, np.float32)
    for t, c in enumerate(ids[:-1]):
        lat[t, 0, c] = -0.05
    lat[len(ids) - 1, 0, ids[-1]] = -0.75
    lat[len(ids) - 1, 0, ids_b[-1]] = -0.65
    lat[len(ids):, 0, 0] = -0.05
    lat = torch.from_numpy(lat - np.log(np.exp(lat).sum(-1, keepdims=True)))

    def best(lm_):
        toks, lens, _ = beam_search_decode(
            lat, beam_width=4, max_symbols=12, lm=lm_, lm_alpha=1.0,
            implementation="xla")
        return alphabet.decode(toks[0, 0, :int(lens[0, 0])].tolist())

    assert best(None) == "the cab"
    assert best(lm) == "the cat"


def test_errors_match_jax():
    for mod in (ttrain, jtrain):
        with pytest.raises(ValueError, match="order"):
            mod.train_ngram_lm([["a"]], order=0)
        with pytest.raises(ValueError, match="empty"):
            mod.train_ngram_lm([])
        with pytest.raises(ValueError, match="outside vocab"):
            mod.train_ngram_lm([["a", "zzz"]], vocab=["a"])

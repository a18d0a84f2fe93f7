"""The torch port's LMs (ops/lm.py, utils/arpa.py) against the JAX
package's, on the same tables, states and tokens (CPU).

Token-level results (states, word ids, hashes, class maps) must be equal;
log-prob sums within 1e-5 (float32 sums in another order).  `score_chunk`
must equal folding `score`/`select` token by token, as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import lm as jlm
from end2end_tpu.utils.arpa import parse_arpa_python as jax_parse_arpa
from end2end_tpu_torch.ops import lm as tlm
from end2end_tpu_torch.utils import arpa as tarpa

torch.set_num_threads(1)

TOL = 1e-5

_ARPA = """\
\\data\\
ngram 1=7
ngram 2=7

\\1-grams:
-0.8 ab -0.3
-0.9 b -0.2
-1.2 ba
-0.5 <s> -0.4
-1.0 </s>
-2.0 <unk>
-1.7 c

\\2-grams:
-0.4 <s> ab
-0.7 ab b
-0.6 b ba
-0.9 ab ab
-1.1 ba </s>
-0.8 b ab
-0.3 c </s>

\\end\\
"""


def _np(x):
    """A state (tensor, JAX array or tuple of them) as int64/float numpy."""
    if isinstance(x, tuple):
        return tuple(_np(y) for y in x)
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.astype(np.int64) if x.dtype.kind in "iu" else x


def _to_jax(state, like):
    """A torch state in the dtypes of the JAX LM's state `like`."""
    if isinstance(state, tuple):
        return tuple(_to_jax(s, l) for s, l in zip(state, like))
    return jnp.asarray(state.numpy().astype(np.asarray(like).dtype))


def _assert_state_equal(got, want):
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (_np(got), _np(want)))):
        np.testing.assert_array_equal(g, w)


def bigram_pair(rng, V):
    big = jlm.bigram_from_counts(rng.integers(0, 20, (V, V)))
    st = rng.standard_normal(V).astype(np.float32)
    eo = rng.standard_normal(V).astype(np.float32)
    return (jlm.NGramLM(big, start_logp=st, eos_logp=eo),
            tlm.NGramLM(big, start_logp=st, eos_logp=eo, device="cpu"))


def word_pair(rng, bpe=False):
    if bpe:
        words, space = [(1, 2), (3,), (1, 4), (3, 2, 2)], None
        kw = {"boundary_ids": [1, 3]}
    else:
        words, kw, space = [(1,), (2,), (1, 2), (2, 1), (1, 1, 2, 2)], {}, 3
    wv = len(words)
    args = (words,
            np.log(np.maximum(rng.random((wv, wv)), 0.05)).astype(np.float32),
            rng.standard_normal(wv).astype(np.float32), space)
    kw.update(unigram_logp=rng.standard_normal(wv).astype(np.float32),
              eos_logp=rng.standard_normal(wv).astype(np.float32),
              unk_logp=-3.0)
    return (jlm.WordNGramLM(*args, **kw),
            tlm.WordNGramLM(*args, **kw, device="cpu"))


def lm_pair(rng, name):
    return {"bigram": lambda: bigram_pair(rng, 6),
            "word": lambda: word_pair(rng),
            "bpe": lambda: word_pair(rng, bpe=True)}[name]()


def _tokens(rng, m, c, v, heavy=(3,)):
    """(M, C) token rows, -1 padded at the end, with the ids in `heavy`
    (separators, word starters) drawn often."""
    toks = rng.integers(0, v, (m, c))
    toks = np.where(rng.random((m, c)) < 0.3, rng.choice(heavy, (m, c)), toks)
    lens = rng.integers(0, c + 1, m)
    return np.where(np.arange(c)[None] < lens[:, None], toks, -1)


def _advanced_state(rng, lm_t, m, v):
    """A torch state reached by replaying random tokens from the start."""
    _, st = lm_t.score_chunk(lm_t.init_state(m),
                             torch.from_numpy(_tokens(rng, m, 9, v)))
    return st


@pytest.mark.parametrize("name", ["bigram", "word", "bpe"])
def test_score_select_final_match_jax(rng, name):
    jl, tl = lm_pair(rng, name)
    W, v = 6, 6
    st = _advanced_state(rng, tl, W, v)
    st_j = _to_jax(st, jl.init_state(W))
    ck = np.array([0, 1, 2, 3, 4, 5], np.int32)
    lp_t, ext_t = tl.score(st, torch.from_numpy(ck))
    lp_j, ext_j = jl.score(st_j, jnp.asarray(ck))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=TOL)
    _assert_state_equal(ext_t, ext_j)
    parent = rng.integers(0, W, W)
    kk = rng.integers(0, len(ck), W)
    is_stay = rng.random(W) < 0.4
    sel_t = tl.select(st, ext_t, torch.from_numpy(parent),
                      torch.from_numpy(kk), torch.from_numpy(is_stay))
    sel_j = jl.select(st_j, ext_j, jnp.asarray(parent), jnp.asarray(kk),
                      jnp.asarray(is_stay))
    _assert_state_equal(sel_t, sel_j)
    np.testing.assert_allclose(tl.final(st).numpy(),
                               np.asarray(jl.final(st_j)), atol=TOL)
    _assert_state_equal(tl.init_state(3), jl.init_state(3))


@pytest.mark.parametrize("name", ["bigram", "word", "bpe"])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_score_chunk_matches_jax_and_the_fold(rng, name, c):
    jl, tl = lm_pair(rng, name)
    m, v = 12, 6
    st = _advanced_state(rng, tl, m, v)
    toks = _tokens(rng, m, c, v, heavy=(1, 3))
    lp_t, new_t = tl.score_chunk(st, torch.from_numpy(toks))
    lp_j, new_j = jl.score_chunk(_to_jax(st, jl.init_state(m)),
                                 jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=TOL)
    _assert_state_equal(new_t, new_j)
    # the fold of score/select, one row-wise token at a time
    rows = torch.arange(m)
    total = torch.zeros(m)
    fold = st
    for j in range(c):
        tok = torch.from_numpy(toks[:, j])
        valid = tok >= 0
        lp, ext = tl.score(fold, tok.clamp(min=0))
        total = total + torch.where(valid, lp[rows, rows], 0.0)
        fold = tl.select(fold, ext, rows, rows, ~valid)
    np.testing.assert_allclose(lp_t.numpy(), total.numpy(), atol=TOL)
    _assert_state_equal(new_t, fold)


@pytest.mark.parametrize("bpe", [False, True])
def test_chunk_words_hashes_match_jax(rng, bpe):
    # long rows: the rolling hashes wrap around 2**32 many times
    m, c = 16, 40
    toks = _tokens(rng, m, c, 30, heavy=(3, 7))
    curh = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    curlen = rng.integers(0, 5, m).astype(np.int32)
    jt = jnp.asarray(toks, jnp.int32)
    tt = torch.from_numpy(toks)
    if bpe:
        is_b = (toks == 3) | (toks == 7)
        jt = jlm._prefix_to_separator(jt, jnp.asarray(is_b))
        tt = tlm._prefix_to_separator(tt, torch.from_numpy(is_b))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    space = jlm._VSEP if bpe else 3
    want = jlm._chunk_words(jt, space, jnp.asarray(curh), jnp.asarray(curlen),
                            np.uint32(31), np.uint32(5381))
    got = tlm._chunk_words(tt, space, torch.from_numpy(curh.astype(np.int64)),
                           torch.from_numpy(curlen.astype(np.int64)), 31,
                           5381)
    for key in ("whash", "n_words", "new_curh", "new_curlen"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_from_bigram_matches_jax(rng):
    for V, n_cls in ((12, 5), (80, 63)):
        jl, tl = bigram_pair(rng, V)
        jg = jlm.QuantizedBigramGuide.from_bigram(jl, n_classes=n_cls)
        tg = tlm.QuantizedBigramGuide.from_bigram(tl, n_classes=n_cls)
        np.testing.assert_array_equal(tg._cls_map.numpy(),
                                      np.asarray(jg._cls_map))
        np.testing.assert_array_equal(tg._table.numpy(),
                                      np.asarray(jg._table))
        assert tg.device == tl.device


def test_arpa_matches_jax(tmp_path):
    path = tmp_path / "lm.arpa"
    path.write_text(_ARPA)
    vocab = ["ab", "b", "ba", "c", "zz"]
    for got, want in zip(tarpa.parse_arpa_python(str(path), vocab),
                         jax_parse_arpa(str(path), vocab)):
        np.testing.assert_array_equal(got, want)
    from end2end_tpu.utils.arpa import ngram_lm_from_arpa

    for native in (False, True):  # True: the native parser where it builds
        tl = tarpa.ngram_lm_from_arpa(str(path), vocab, native,
                                      device="cpu")
        jl = ngram_lm_from_arpa(str(path), vocab, prefer_native=native)
        np.testing.assert_array_equal(tl._table.numpy(),
                                      np.asarray(jl._table))
        np.testing.assert_array_equal(tl._eos.numpy(), np.asarray(jl._eos))


@pytest.mark.parametrize("native", [True, False])
def test_arpa_loaders_take_prefer_native(tmp_path, native):
    """`prefer_native`, by name and by position, as JAX's loaders take it:
    True reads with the native parser where it builds, False with the
    Python parser."""
    from end2end_tpu_torch.utils import native as tnative

    path = tmp_path / "lm.arpa"
    path.write_text(_ARPA)
    vocab = ["ab", "b", "ba", "c", "zz"]
    want = (tnative.parse_arpa_native(str(path), vocab)
            if native and tnative.available()
            else tarpa.parse_arpa_python(str(path), vocab))
    for got in (tarpa.load_arpa(str(path), vocab, prefer_native=native),
                tarpa.load_arpa(str(path), vocab, native)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for lm in (tarpa.ngram_lm_from_arpa(str(path), vocab, native,
                                        device="cpu"),
               tarpa.ngram_lm_from_arpa(str(path), vocab,
                                        prefer_native=native, device="cpu")):
        np.testing.assert_array_equal(lm._table[:-1].numpy(), want[1])
        np.testing.assert_array_equal(lm._table[-1].numpy(), want[2])
        np.testing.assert_array_equal(lm._eos.numpy(), want[3])


def test_word_lm_from_arpa_matches_jax(tmp_path, rng):
    from end2end_tpu.utils.text import Alphabet

    path = tmp_path / "words.arpa"
    path.write_text(_ARPA)
    alphabet = Alphabet("_abc ")  # the separator is id 4
    words = ["ab", "b", "ba", "c"]
    jl = jlm.WordNGramLM.from_arpa(str(path), words, alphabet)
    tl = tlm.WordNGramLM.from_arpa(str(path), words, alphabet, device="cpu")
    # JAX reads the file with its native C parser here: float32 ulps apart
    np.testing.assert_allclose(tl._table.numpy(), np.asarray(jl._table),
                               rtol=1e-6)
    np.testing.assert_allclose(tl._eos.numpy(), np.asarray(jl._eos),
                               rtol=1e-6)
    toks = _tokens(rng, 8, 12, 5, heavy=(4,))
    got = tl.score_chunk(tl.init_state(8), torch.from_numpy(toks))
    want = jl.score_chunk(jl.init_state(8), jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL)
    _assert_state_equal(got[1], want[1])


def test_word_hash_duplicates_and_misses():
    with pytest.raises(ValueError, match="collision"):
        tlm.WordNGramLM([(1, 2), (1, 2)], np.zeros((2, 2)), np.zeros(2), 3,
                        device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tlm.WordNGramLM([(1,)], np.zeros((1, 1)), np.zeros(1), None,
                        device="cpu")
    lm = tlm.WordNGramLM([(1, 2), (2,)], np.zeros((2, 2)), np.zeros(2), 3,
                         device="cpu")
    h = torch.tensor([5381 * 31 + 3, 0, (5381 * 31 + 2) * 31 + 3])
    np.testing.assert_array_equal(lm._wh.lookup(h).numpy(), [1, 3, 0])

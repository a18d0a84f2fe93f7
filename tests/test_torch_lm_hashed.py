"""The torch port's hashed n-gram LMs, hotword boosting and composite LM
(ops/lm.py) against the JAX package's, on the same n-grams, states and
tokens (CPU).

Routes of `_HashedNGramTables`: the dense full table (bit-equal to JAX,
which gathers the same table), the dense unigram/bigram rows with hashed
higher orders, and hashed bigrams past 259 ids.  States must be equal and
log-probs within 1e-5 (`tests/test_torch_lm.py`'s TOL).  `score_chunk`
must equal folding `score`/`select` token by token, and the tables must
match the float64 `ArpaScorer` on an ARPA file from `train_ngram_arpa`.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from end2end_tpu.ops import lm as jlm
from end2end_tpu_torch.ops import lm as tlm
from end2end_tpu_torch.ops.rescore import _score_by_protocol
from end2end_tpu_torch.utils.arpa import ArpaScorer
from end2end_tpu_torch.utils.lm_train import train_ngram_arpa

torch.set_num_threads(1)

TOL = 1e-5
ROUTES = [(7, None), (7, False), (300, False)]  # (id space, dense_full)


def rand_ngrams(rng, n, order, counts=(0, 50, 120, 160)):
    """Random n-grams over ids 0..n+1 (n tokens, <s> = n, </s> = n + 1)
    with log-probs and backoffs, re-listed grams included."""
    ng = {"unk": float(rng.uniform(-9, -6))}
    ng[1] = [((a,), float(rng.uniform(-4, -1)), float(rng.uniform(-1, 0)))
             for a in range(n + 2)]
    for k in range(2, order + 1):
        ng[k] = [(tuple(int(x) for x in rng.integers(0, n + 2, k)),
                  float(rng.uniform(-3, -0.3)),
                  float(rng.uniform(-1, 0)) if k < order else 0.0)
                 for _ in range(counts[min(k, 3)])]
    return ng


def _to_jax(state, like):
    """A torch state in the dtypes of the JAX LM's state `like`."""
    if isinstance(state, tuple):
        return tuple(_to_jax(s, l) for s, l in zip(state, like))
    return jnp.asarray(state.numpy().astype(np.asarray(like).dtype))


def _assert_state_equal(got, want):
    g, w = tree_leaves(got), [np.asarray(x) for x in tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      b.astype(np.int64))


def _check_protocol(rng, jl, tl, W, ck, toks, exact=False):
    """score / select / final / score_chunk of a port LM against its JAX
    twin, from a state reached by replaying `toks`, and score_chunk
    against the token-by-token fold.  `exact`: score and final bit-equal
    (both gather one table); sums over a chunk within TOL (other orders)."""
    def close(a, b):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)

    cmp = np.testing.assert_array_equal if exact else close
    _assert_state_equal(tl.init_state(W), jl.init_state(W))
    st0 = tl.init_state(W)
    lp_t, st = tl.score_chunk(st0, torch.from_numpy(toks))
    lp_j, st_j = jl.score_chunk(jl.init_state(W), jnp.asarray(toks))
    close(lp_t.numpy(), np.asarray(lp_j))
    _assert_state_equal(st, st_j)
    fold_lp, fold_st = _score_by_protocol(tl, st0, torch.from_numpy(toks))
    close(fold_lp.numpy(), lp_t.numpy())
    _assert_state_equal(fold_st, st_j)
    st_j = _to_jax(st, st_j)
    lp_t, ext_t = tl.score(st, torch.from_numpy(ck))
    lp_j, ext_j = jl.score(st_j, jnp.asarray(ck))
    cmp(lp_t.numpy(), np.broadcast_to(np.asarray(lp_j), lp_t.shape))
    _assert_state_equal(ext_t, ext_j)
    # per-row candidates (the scan's (W, K) form) score as the shared ones
    lp_rows, ext_rows = tl.score(st, torch.from_numpy(ck).expand(W, -1))
    assert torch.equal(lp_rows, lp_t)
    _assert_state_equal(ext_rows, ext_j)
    parent = rng.integers(0, W, W)
    kk = rng.integers(0, len(ck), W)
    is_stay = rng.random(W) < 0.4
    sel_t = tl.select(st, ext_t, torch.from_numpy(parent),
                      torch.from_numpy(kk), torch.from_numpy(is_stay))
    sel_j = jl.select(st_j, ext_j, jnp.asarray(parent), jnp.asarray(kk),
                      jnp.asarray(is_stay))
    _assert_state_equal(sel_t, sel_j)
    cmp(tl.final(sel_t).numpy(), np.asarray(jl.final(sel_j)))
    # a second chunk from the advanced state
    lp2_t, st2 = tl.score_chunk(sel_t, torch.from_numpy(toks[::-1].copy()))
    lp2_j, st2_j = jl.score_chunk(sel_j, jnp.asarray(toks[::-1].copy()))
    close(lp2_t.numpy(), np.asarray(lp2_j))
    _assert_state_equal(st2, st2_j)


def _token_rows(rng, m, c, v, heavy=(), p_heavy=0.3):
    """(M, C) rows of ids in [0, v), -1 padded at the end (an empty row
    and a full row included), with the ids in `heavy` drawn often."""
    toks = rng.integers(0, v, (m, c))
    if heavy:
        toks = np.where(rng.random((m, c)) < p_heavy,
                        rng.choice(heavy, (m, c)), toks)
    lens = rng.integers(0, c + 1, m)
    lens[0], lens[-1] = 0, c
    return np.where(np.arange(c)[None] < lens[:, None], toks, -1)


def jax_score_is_right(n, order, dense_full):
    """Whether JAX's `_HashedNGramTables.score` keeps KenLM semantics on
    this route: it looks a hashed context gram of length k up by the fold
    of only its last k - 1 ids, so such a lookup misses and the context's
    backoff is dropped; the dense routes are right."""
    dense_bi = dense_full is False and n + 4 <= 259
    return dense_full is None or order <= 2 or (order == 3 and dense_bi)


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("n,dense_full", ROUTES)
def test_tables_score_matches_jax(rng, order, n, dense_full):
    """score_sequence and the context hashes bit-equal to JAX's on every
    route; score bit-equal to score_sequence at every position, and to
    JAX's score where that keeps KenLM semantics."""
    ng = rand_ngrams(rng, n, order)
    jt = jlm._HashedNGramTables(order, ng, dense_full=dense_full)
    tt = tlm._HashedNGramTables(order, ng, dense_full=dense_full)
    assert (tt._full is None) == (jt._full is None)
    assert (tt._bi is None) == (jt._bi is None)
    assert (tt._full is not None) == (dense_full is None)
    assert (tt._bi is not None) == (dense_full is False and n == 7)
    ids = np.array([-2, -1, 0, 1, n - 1, n, n + 1, n + 7])  # sentinels, oob
    full = rng.choice(ids, (16, order - 1 + 11))
    got = tt.score_sequence(torch.from_numpy(full), 11)
    want = jt.score_sequence(jnp.asarray(full, jnp.int32), 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per = torch.stack([tt.score(torch.from_numpy(full[:, j:j + order - 1]),
                                torch.from_numpy(full[:, j + order - 1]))
                       for j in range(11)], 1)
    assert torch.equal(per, got)
    wins = rng.choice(ids, (40, order - 1))
    ws = rng.choice(ids, 9)
    if jax_score_is_right(n, order, dense_full):
        got = tt.score(torch.from_numpy(wins)[:, None], torch.from_numpy(ws))
        want = np.asarray(jt.score(jnp.asarray(wins, jnp.int32)[:, None],
                                   jnp.asarray(ws, jnp.int32)))
        np.testing.assert_array_equal(got.numpy(),
                                      np.broadcast_to(want, got.shape))
    for a, b in zip(tt.ctx_hashes(torch.from_numpy(wins)),
                    jt.ctx_hashes(jnp.asarray(wins, jnp.int32))):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))


@pytest.mark.parametrize("n,order", [(7, 4), (300, 3)])
def test_hashed_context_grams_follow_the_oracle_not_jax(rng, n, order):
    """Pins a fault of the reference: on the hashed route JAX's `score`
    misses the backoff of a hashed context gram (order 4 with dense
    bigrams, order 3 past 259 ids: bench.py's 2000-word trigram).  The
    port looks the context up by all its ids and equals the float64
    `ArpaScorer`; JAX's `score_sequence` is right and the port's equals
    it bit for bit (test above)."""
    ng = rand_ngrams(rng, n, order)
    sc = ArpaScorer(order, ng, n)
    wins = rng.integers(0, n + 1, (400, order - 1))
    ws = rng.integers(0, n + 2, 400)
    ref = np.array([sc.score(tuple(w), x) for w, x in zip(wins, ws)])
    tt = tlm._HashedNGramTables(order, ng, dense_full=False)
    got = tt.score(torch.from_numpy(wins), torch.from_numpy(ws)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    jt = jlm._HashedNGramTables(order, ng, dense_full=False)
    jax = np.asarray(jt.score(jnp.asarray(wins, jnp.int32),
                              jnp.asarray(ws, jnp.int32)))
    assert np.abs(jax - ref).max() > 0.1


def test_dense_full_is_bit_equal_to_the_chain(rng):
    """The dense full table resolves the backoff chain at build time in
    score's float32 order: every window of ids, sentinels and out-of-range
    ids included, scores bit-equal on both routes."""
    ng = rand_ngrams(rng, 7, 3)
    full = tlm._HashedNGramTables(3, ng, dense_full=True)
    chain = tlm._HashedNGramTables(3, ng, dense_full=False)
    ids = list(range(-2, 9)) + [99]
    wins = torch.tensor(list(itertools.product(ids, ids)))
    ws = torch.tensor(ids)
    assert torch.equal(full.score(wins[:, None], ws),
                       chain.score(wins[:, None], ws))
    seq = torch.from_numpy(rng.integers(-1, 9, (32, 11)))
    assert torch.equal(full.score_sequence(seq, 8),
                       chain.score_sequence(seq, 8))
    with pytest.raises(ValueError, match="dense_full"):
        tlm._HashedNGramTables(3, rand_ngrams(rng, 300, 3), dense_full=True)


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("n,dense_full", ROUTES)
def test_hashed_ngram_lm_protocol_matches_jax(rng, order, n, dense_full):
    """Against JAX's LM on the same route, or where JAX's `score` drops
    a hashed context's backoff, against JAX's dense full table (bit-equal
    to the chain) if it fits, else against the oracle's sums."""
    ng = rand_ngrams(rng, n, order)
    tl = tlm.HashedNGramLM(order, ng, n, dense_full=dense_full,
                           device="cpu")
    ck = rng.integers(0, n, 6).astype(np.int32)
    toks = _token_rows(rng, 7, 13, n).astype(np.int32)
    if not jax_score_is_right(n, order, dense_full):
        if (n + 4) ** order > tlm._HashedNGramTables._FULL_MAX:
            sc = ArpaScorer(order, ng, n)
            lp, st = tl.score_chunk(tl.init_state(7), torch.from_numpy(toks))
            lp = lp + tl.final(st)
            for row, got in zip(toks, lp.tolist()):
                seq = (n,) + tuple(int(x) for x in row if x >= 0)
                want = sum(sc.score(seq[:j], seq[j])
                           for j in range(1, len(seq)))
                np.testing.assert_allclose(got, want + sc.score(seq, n + 1),
                                           atol=1e-4)
            return
        dense_full = None
    jl = jlm.HashedNGramLM(order, ng, n, dense_full=dense_full)
    _check_protocol(rng, jl, tl, 7, ck, toks,
                    exact=tl._t._full is not None)


def test_hashed_ngram_lm_without_eos_and_at_order_one(rng):
    ng = rand_ngrams(rng, 7, 3)
    jl = jlm.HashedNGramLM(3, ng, 7, use_eos=False)
    tl = tlm.HashedNGramLM(3, ng, 7, use_eos=False, device="cpu")
    st = tl.init_state(4)
    assert torch.equal(tl.final(st), torch.zeros(4))
    np.testing.assert_array_equal(
        np.asarray(jl.final(_to_jax(st, jl.init_state(4)))), 0.0)
    ng1 = {1: ng[1], "unk": ng["unk"]}
    for dense_full in (None, False):
        jl = jlm.HashedNGramLM(1, ng1, 7, dense_full=dense_full)
        tl = tlm.HashedNGramLM(1, ng1, 7, dense_full=dense_full,
                               device="cpu")
        _check_protocol(rng, jl, tl, 5, np.arange(7, dtype=np.int32),
                        _token_rows(rng, 5, 6, 7).astype(np.int32))


def word_lm_pair(rng, order, bpe=False, n_words=None, dense_full=None):
    """The same hashed word LM in both packages: separator mode over
    tokens 1-3 with space 4, or BPE prefix mode with word starters
    {1, 3}; random n-grams over the words.  Where JAX's `score` drops a
    hashed context's backoff, JAX's twin takes its dense full table,
    bit-equal to the chain."""
    if bpe:
        words = [(1, 2), (3,), (1, 4), (3, 2, 2), (1,), (3, 4, 2)]
        space, kw = None, {"boundary_ids": [1, 3]}
    else:
        words = [(1,), (2,), (1, 2), (2, 1), (3, 3), (1, 1, 2, 2), (3, 1)]
        space, kw = 4, {}
    if n_words:  # a larger lexicon: every spelling of 1-5 tokens in 1-3
        words = sorted(itertools.chain.from_iterable(
            itertools.product((1, 2, 3), repeat=n) for n in range(1, 6)))
        words = words[:n_words]
    ng = rand_ngrams(rng, len(words), order)
    args = (words, order, ng, space)
    jax_full = (dense_full if jax_score_is_right(len(words), order,
                                                 dense_full) else None)
    return (jlm.HashedWordNGramLM(*args, dense_full=jax_full, **kw),
            tlm.HashedWordNGramLM(*args, dense_full=dense_full, **kw,
                                  device="cpu"))


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("bpe", [False, True])
@pytest.mark.parametrize("dense_full", [None, False])
def test_hashed_word_lm_protocol_matches_jax(rng, order, bpe, dense_full):
    """Separator and BPE modes: unknown words (spellings outside the
    lexicon, which enter the history as -2), an empty chunk row and rows
    ending in a word still being typed (completed by `final`)."""
    jl, tl = word_lm_pair(rng, order, bpe=bpe, dense_full=dense_full)
    toks = _token_rows(rng, 9, 17, 5, heavy=(3,) if bpe else (4,))
    toks[1, :6] = [1, 1, 1, 1, 1, 4] if not bpe else [1, 2, 2, 2, 2, 3]
    _check_protocol(rng, jl, tl, 9, np.arange(5, dtype=np.int32),
                    toks.astype(np.int32), exact=dense_full is None)
    # the unknown word entered the separator-mode history as -2
    if not bpe:
        win = tl.score_chunk(tl.init_state(1),
                             torch.tensor([[1, 1, 1, 1, 1, 4]]))[1][0]
        assert int(win[0, -1]) == -2


def test_hashed_word_lm_large_lexicon_matches_jax(rng):
    """300 words: past 259 ids the bigrams are hashed too (a bigram model,
    where JAX's `score` looks contexts up densely)."""
    jl, tl = word_lm_pair(rng, 2, n_words=300, dense_full=False)
    assert tl._t._full is None and tl._t._bi is None
    toks = _token_rows(rng, 6, 25, 5, heavy=(4,))
    _check_protocol(rng, jl, tl, 6, np.arange(5, dtype=np.int32),
                    toks.astype(np.int32))


PHRASES = [(1, 2, 3), (2, 3, 4), (4,), (1, 1), (2, 3, 4, 5, 1)]


def _oracle_bonus(phrases, weight, cb, stream):
    """Token j earns `weight` iff a suffix of the stream ending at j is a
    phrase prefix, plus `cb` iff it is a whole phrase."""
    prefixes = {p[:n] for p in phrases for n in range(1, len(p) + 1)}
    total = 0.0
    for j in range(len(stream)):
        sufs = {tuple(stream[j + 1 - n: j + 1]) for n in range(1, j + 2)}
        total += weight * bool(sufs & prefixes)
        total += cb * bool(sufs & set(phrases))
    return total


@pytest.mark.parametrize("cb", [0.0, 2.5])
def test_hotword_protocol_matches_jax_and_the_oracle(rng, cb):
    jl = jlm.HotwordBoostLM(PHRASES, weight=1.5, complete_bonus=cb)
    tl = tlm.HotwordBoostLM(PHRASES, weight=1.5, complete_bonus=cb,
                            device="cpu")
    toks = _token_rows(rng, 8, 15, 6, heavy=(1, 2, 3, 4), p_heavy=0.7)
    toks[1, :4] = [1, 2, 3, 4]  # "1 2 3" fails at 4 and re-enters "2 3 4"
    _check_protocol(rng, jl, tl, 8, np.arange(6, dtype=np.int32),
                    toks.astype(np.int32), exact=True)
    lp, _ = tl.score_chunk(tl.init_state(8), torch.from_numpy(toks))
    for row, got in zip(toks, lp.tolist()):
        stream = [int(x) for x in row if x >= 0]
        np.testing.assert_allclose(got, _oracle_bonus(PHRASES, 1.5, cb,
                                                      stream), atol=1e-6)


def test_hotword_suffix_reentry():
    """'a b c d' against phrases 'a b c' and 'b c d': every token
    continues some phrase, 'd' by re-entering 'b c d'."""
    lm = tlm.HotwordBoostLM([(1, 2, 3), (2, 3, 4)], complete_bonus=10.0,
                            device="cpu")
    lp, win = lm.score_chunk(lm.init_state(1), torch.tensor([[1, 2, 3, 4]]))
    assert float(lp[0]) == 4.0 + 20.0
    assert win.tolist() == [[3, 4]]


def test_table_duplicates_and_validation_match_jax():
    """A re-listed (h1, h2) overwrites; with on_dup='error' distinct items
    sharing (h1, h2) raise, as JAX's `_FastTable` does."""
    items = [(5, 9, (1.0,)), (2 ** 32 - 1, 3, (2.0,)), (5, 9, (3.0,))]
    t = tlm._SortedTable(items, 1)
    j = jlm._FastTable(items, 1)
    h1 = torch.tensor([5, 2 ** 32 - 1, 5, 6])
    h2 = torch.tensor([9, 3, 8, 9])
    hit, (pay,) = t.lookup(h1, h2)
    jhit, (jpay,) = j.lookup(jnp.asarray(h1.numpy(), jnp.uint32),
                             jnp.asarray(h2.numpy(), jnp.uint32))
    assert hit.tolist() == [True, True, False, False] == np.asarray(
        jhit).tolist()
    assert pay.tolist() == [3.0, 2.0, 0.0, 0.0] == np.asarray(jpay).tolist()
    for make in (lambda: tlm._SortedTable(items, 1, on_dup="error"),
                 lambda: jlm._FastTable(items, 1, on_dup="error")):
        with pytest.raises(ValueError, match="collision"):
            make()
    for bad in ([], [()], [(1, -2)]):
        with pytest.raises(ValueError):
            jlm.HotwordBoostLM(bad)
        with pytest.raises(ValueError):
            tlm.HotwordBoostLM(bad, device="cpu")
    with pytest.raises(ValueError):
        tlm.CompositeLM([])
    with pytest.raises(ValueError, match="weights"):
        tlm.CompositeLM([tlm.HotwordBoostLM([(1,)], device="cpu")],
                        weights=[1.0, 2.0])
    with pytest.raises(ValueError, match="device"):
        tlm.CompositeLM([tlm.HotwordBoostLM([(1,)], device="cpu"),
                         tlm.HotwordBoostLM([(1,)], device="meta")])


def composite_pair(rng, bpe=False):
    """A word trigram plus a hotword booster in both packages."""
    jw, tw = word_lm_pair(rng, 3, bpe=bpe)
    phrases = [(1, 2, 4, 2), (3, 3)]
    return (jlm.CompositeLM([jw, jlm.HotwordBoostLM(phrases, 1.0, 0.5)],
                            weights=(1.0, 0.7)),
            tlm.CompositeLM([tw, tlm.HotwordBoostLM(phrases, 1.0, 0.5,
                                                    device="cpu")],
                            weights=(1.0, 0.7)))


@pytest.mark.parametrize("bpe", [False, True])
def test_composite_protocol_matches_jax(rng, bpe):
    jl, tl = composite_pair(rng, bpe)
    toks = _token_rows(rng, 7, 14, 5, heavy=(3,) if bpe else (4,))
    _check_protocol(rng, jl, tl, 7, np.arange(5, dtype=np.int32),
                    toks.astype(np.int32))
    # nested: a composite of a composite holds a tuple of tuples
    jn = jlm.CompositeLM([jl, jlm.HotwordBoostLM([(2,)])])
    tn = tlm.CompositeLM([tl, tlm.HotwordBoostLM([(2,)], device="cpu")])
    _check_protocol(rng, jn, tn, 7, np.arange(5, dtype=np.int32),
                    toks.astype(np.int32))


@pytest.mark.parametrize("dense_full", [None, False])
def test_hashed_lm_matches_the_float64_oracle(tmp_path, rng, dense_full):
    """Every (context, token) pair with histories up to 3 tokens (<s> and
    empty slots included) against `ArpaScorer` on a trigram ARPA file
    written by `train_ngram_arpa` from a seeded corpus; and a replay's
    sum against the oracle's sum over the sentence."""
    vocab = list("abcd")
    corpus = ["".join(rng.choice(vocab, int(rng.integers(1, 9))))
              for _ in range(40)]
    path = tmp_path / "kn3.arpa"
    path.write_text(train_ngram_arpa([list(s) for s in corpus], order=3,
                                     vocab=vocab))
    lm = tlm.HashedNGramLM.from_arpa(str(path), vocab,
                                     dense_full=dense_full, device="cpu")
    assert (lm._t._full is not None) == (dense_full is None)
    sc = ArpaScorer.from_file(str(path), vocab)
    toks = list(range(4))
    ctxs = [c for n in range(4) for c in itertools.product(toks, repeat=n)]
    wins, ws, want = [], [], []
    for ctx in ctxs:
        full = (sc.bos,) + ctx
        tail = full[-2:]
        wins.append([-1] * (2 - len(tail)) + list(tail))
        for w in toks + [sc.eos]:
            ws.append(w)
            want.append(sc.score(full, w))
    got = lm._t.score(torch.tensor(wins).repeat_interleave(5, 0),
                      torch.tensor(ws))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    sent = [int(x) for x in rng.integers(0, 4, 12)]
    lp, st = lm.score_chunk(lm.init_state(1), torch.tensor([sent]))
    ref = sum(sc.score((sc.bos,) + tuple(sent[:j]), sent[j])
              for j in range(len(sent)))
    ref += sc.score((sc.bos,) + tuple(sent), sc.eos)
    np.testing.assert_allclose(float(lp[0] + lm.final(st)[0]), ref,
                               atol=1e-4)

"""The torch port's `NeuralLM` (ops/neural_lm.py) against the JAX package's
(CPU).

`NeuralLM.gru` against JAX's with `precision=HIGHEST`: `score`, `select`,
`final` and `score_chunk` within 1e-5, pending tokens equal.  A
`NeuralLM` whose one-hot hidden (a nest: a dict with a counter) reproduces
a dense bigram must decode exactly as `NGramLM` through the port's scan,
and `score_chunk` must equal folding `score`/`select` token by token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import neural_lm as jnl
from end2end_tpu_torch.ops import lm as tlm
from end2end_tpu_torch.ops import neural_lm as tnl
from end2end_tpu_torch.ops.beam_search import beam_search_decode
from end2end_tpu_torch.ops.rescore import _score_by_protocol

torch.set_num_threads(1)

TOL = 1e-5


def lsm(x):
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def gru_pair(rng, V, eos_id=None, normalize=True):
    params = tnl.random_gru_params(rng, V, emb_dim=6, hidden_dim=10)
    return (jnl.NeuralLM.gru(params, eos_id=eos_id, normalize=normalize,
                             precision=jax.lax.Precision.HIGHEST),
            tnl.NeuralLM.gru(params, eos_id=eos_id, normalize=normalize,
                             device="cpu"))


def _rows(rng, m, c, v):
    toks = rng.integers(0, v, (m, c))
    lens = rng.integers(0, c + 1, m)
    lens[0], lens[-1] = 0, c
    return np.where(np.arange(c)[None] < lens[:, None], toks,
                    -1).astype(np.int32)


def _assert_state_close(got, want):
    (h_t, p_t), (h_j, p_j) = got, want
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("eos_id,normalize", [(None, True), (2, True),
                                              (3, False)])
def test_gru_protocol_matches_jax(rng, eos_id, normalize):
    V, M = 7, 6
    jl, tl = gru_pair(rng, V, eos_id, normalize)
    toks = _rows(rng, M, 9, V)
    lp_t, st = tl.score_chunk(tl.init_state(M), torch.from_numpy(toks))
    lp_j, st_j = jl.score_chunk(jl.init_state(M), jnp.asarray(toks))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=TOL,
                               rtol=0)
    _assert_state_close(st, st_j)
    st_j = (jnp.asarray(st[0].numpy()), jnp.asarray(st[1].numpy(),
                                                    jnp.int32))
    ck = np.array([0, 3, 6, 1], np.int32)
    lp_t, ext_t = tl.score(st, torch.from_numpy(ck))
    lp_j, ext_j = jl.score(st_j, jnp.asarray(ck))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=TOL,
                               rtol=0)
    _assert_state_close(ext_t, ext_j)
    parent = rng.integers(0, M, M)
    kk = rng.integers(0, len(ck), M)
    is_stay = rng.random(M) < 0.4
    sel_t = tl.select(st, ext_t, torch.from_numpy(parent),
                      torch.from_numpy(kk), torch.from_numpy(is_stay))
    sel_j = jl.select(st_j, ext_j, jnp.asarray(parent), jnp.asarray(kk),
                      jnp.asarray(is_stay))
    _assert_state_close(sel_t, sel_j)
    np.testing.assert_allclose(tl.final(sel_t).numpy(),
                               np.asarray(jl.final(sel_j)), atol=TOL, rtol=0)
    lp_t, _ = tl.score_chunk(sel_t, torch.from_numpy(toks[::-1].copy()))
    lp_j, _ = jl.score_chunk(sel_j, jnp.asarray(toks[::-1].copy()))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=TOL,
                               rtol=0)


def test_score_chunk_equals_fold(rng):
    """score_chunk == score/select folded token by token (each row its own
    candidate, -1 end padding), and the two states score alike."""
    V, M = 7, 5
    _, lm = gru_pair(rng, V, eos_id=2)
    toks = torch.from_numpy(_rows(rng, M, 9, V))
    lp_chunk, st_chunk = lm.score_chunk(lm.init_state(M), toks)
    lp_fold, st_fold = _score_by_protocol(lm, lm.init_state(M), toks)
    torch.testing.assert_close(lp_chunk, lp_fold, atol=TOL, rtol=0)
    assert torch.equal(st_chunk[1], st_fold[1])
    ck = torch.arange(V)
    torch.testing.assert_close(lm.score(st_chunk, ck)[0],
                               lm.score(st_fold, ck)[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(lm.final(st_chunk), lm.final(st_fold),
                               atol=1e-6, rtol=0)


def bigram_pair(rng, V):
    """(NGramLM, NeuralLM) with the same bigram scores: the neural hidden
    is a nest, {"ctx": one-hot context row (V = start), "n": tokens
    consumed}, and logp = ctx @ table (one nonzero product: exact)."""
    table = np.log(np.maximum(rng.random((V, V)), 0.05)).astype(np.float32)
    start = rng.standard_normal(V).astype(np.float32)
    ngram = tlm.NGramLM(table, start_logp=start, device="cpu")
    full = torch.from_numpy(np.concatenate([table, start[None]]))

    def step(h, tok):
        return {"ctx": torch.nn.functional.one_hot(tok, V + 1).float(),
                "n": h["n"] + 1}

    def logp(h):
        return h["ctx"] @ full

    h0 = {"ctx": torch.nn.functional.one_hot(torch.tensor(V), V + 1).float(),
          "n": torch.tensor(0)}
    return ngram, tnl.NeuralLM(step, logp, h0, V, normalize=False,
                               device="cpu")


@pytest.mark.parametrize("prune_k", [None, 5])
def test_nested_hidden_reproduces_the_bigram_decode(rng, prune_k):
    """Through the scan every protocol method runs on the nested state;
    the decode is bit-equal to NGramLM's, and the counter counts each
    surviving prefix's tokens."""
    T, B, V, W = 15, 3, 8, 6
    ngram, neural = bigram_pair(rng, V)
    lp = torch.from_numpy(lsm(rng.standard_normal((T, B, V)) * 1.5).astype(
        np.float32))
    il = torch.tensor([15, 11, 7])
    kw = dict(beam_width=W, prune_k=prune_k, max_symbols=14, lm_alpha=0.7,
              lm_beta=0.25, implementation="xla", return_timestamps=True)
    want = beam_search_decode(lp, il, lm=ngram, **kw)
    got = beam_search_decode(lp, il, lm=neural, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    toks = want[0].reshape(B * W, -1).long()
    toks = torch.where(torch.arange(14) < want[1].reshape(-1, 1), toks, -1)
    _, (h, pending) = neural.score_chunk(neural.init_state(B * W), toks)
    n_tok = (toks >= 0).sum(1)
    assert torch.equal(h["n"] + (pending >= 0), n_tok)


def test_device_and_validation():
    params = tnl.random_gru_params(np.random.default_rng(0), 5)
    lm = tnl.NeuralLM.gru(params, device="meta")
    assert lm.device.type == "meta"
    assert tnl.NeuralLM.gru(params, device="cpu").init_state(3)[0].shape == (
        3, 64)

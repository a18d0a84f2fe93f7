"""Transducer ALSD beam search, lookahead and the float32 cast: the port's
`rnnt_beam_decode` and `rnnt_greedy_decode` against the JAX package's on
the same seeded inputs (CPU), and against the float64 oracles of
tests/test_rnnt_beam.py (the dict ALSD, the exhaustive beam against
`rnnt_loss_ref`) and tests/test_rnnt_lm.py (the dict ALSD with a bigram).

Tolerances: tokens, lengths and times equal; scores against JAX's rtol
1e-5, atol 1e-4 (float32 joints and logsumexps in other orders, summed
over up to T + S steps); lookahead against lookahead 1 the same (the
window sums the same per-frame terms in another order); against the dict
oracles 2e-3, their own tolerance; the exhaustive beam against the
float64 DP 1e-4.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import lm as jlm
from end2end_tpu.ops import rnnt_decode as jdec
from end2end_tpu.ops.neural_lm import NeuralLM as JaxNeuralLM
from end2end_tpu.ops.neural_lm import gru_step as jax_gru_step
from end2end_tpu.utils.rnnt_reference import rnnt_loss_ref
from end2end_tpu_torch.ops import lm as tlm
from end2end_tpu_torch.ops import rnnt_decode as tdec
from end2end_tpu_torch.ops.neural_lm import NeuralLM, gru_step, \
    random_gru_params
from tests.test_rnnt_beam import _alsd_oracle, _lattice
from tests.test_rnnt_lm import _alsd_lm_oracle
from tests.test_torch_lm_hashed import word_lm_pair

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def problem(seed, n=3, t=12, v=7, h_enc=8, emb=4, hid=5, scale=1.0,
            blank_bias=0.0, factored=False):
    """Seeded encoder output and the same GRU predictor and additive joint
    in both packages: (enc numpy, JAX (pred, h0, joint), port (pred, h0,
    joint)).  `blank_bias` raises the blank logit (blank-dominated)."""
    rng = np.random.default_rng(seed)
    enc = (rng.normal(size=(n, t, h_enc)) * scale).astype(np.float32)
    params = random_gru_params(rng, v, emb_dim=emb, hidden_dim=hid)
    ws = [rng.normal(size=(h_enc, 7)).astype(np.float32) * 0.5,
          rng.normal(size=(hid, 7)).astype(np.float32) * 0.5,
          rng.normal(size=(7,)).astype(np.float32) * 0.1,
          rng.normal(size=(7, v)).astype(np.float32),
          rng.normal(size=(v,)).astype(np.float32) * 0.1]
    ws[4][0] += blank_bias
    if factored:
        jj, tj = jdec.FactoredAdditiveJoint(*ws), tdec.FactoredAdditiveJoint(
            *ws)
    else:
        jj = jdec.additive_joint(*map(jnp.asarray, ws))
        tj = tdec.additive_joint(*map(torch.from_numpy, ws))
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    tp = {k: torch.from_numpy(a) for k, a in params.items()}
    return (enc, (partial(jax_gru_step, jp), jnp.zeros(hid), jj),
            (partial(gru_step, tp), torch.zeros(hid), tj))


def assert_decodes_equal(got, want, atol=1e-4):
    """tokens, lengths (and times) equal, scores within tolerance."""
    got = [torch.as_tensor(x).numpy() for x in got]
    want = [np.asarray(x) for x in want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol)
        else:
            np.testing.assert_array_equal(g, w)


def beams(toks, lens, scores):
    """[(tuple(tokens), score)] of sample b's live beams, per sample."""
    toks, lens, scores = (torch.as_tensor(x).numpy()
                          for x in (toks, lens, scores))
    return [[(tuple(toks[b, w, :lens[b, w]].tolist()), float(scores[b, w]))
             for w in range(toks.shape[1]) if scores[b, w] > -1e9]
            for b in range(toks.shape[0])]


CASES = {  # name: problem kwargs, decode kwargs
    "saturated": (dict(seed=7, scale=1.3), dict(beam_width=4)),
    "blank_dominated": (dict(seed=5, t=20, blank_bias=2.5, factored=True),
                        dict(beam_width=4, max_symbols=8)),
    "capped": (dict(seed=31, scale=1.4, factored=True),
               dict(beam_width=4, max_symbols=2)),
    "narrow": (dict(seed=31, scale=1.4), dict(beam_width=2, prune_k=1,
                                              max_symbols=6)),
    "wide": (dict(seed=23, scale=1.1), dict(beam_width=8, prune_k=6,
                                            max_symbols=6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_alsd_matches_jax(name):
    """Plain and factored joints, emission-saturated and blank-dominated,
    a binding symbol cap, W=2/K=1 and W=8/K=V-1; sample 2 is empty."""
    pkw, dkw = CASES[name]
    enc, jf, tf = problem(**pkw)
    t = enc.shape[1]
    il = np.array([t, t - 3, 0], np.int32)
    want = jdec.rnnt_beam_decode(enc, il, *jf, return_timestamps=True, **dkw)
    got = tdec.rnnt_beam_decode(torch.from_numpy(enc), torch.from_numpy(il),
                                *tf, return_timestamps=True, **dkw)
    assert_decodes_equal(got, want)
    toks, lens, scores, times = got
    assert lens[2, 0] == 0 and abs(float(scores[2, 0])) < 1e-6
    for b in range(2):
        for w in range(toks.shape[1]):
            ts = times[b, w, :lens[b, w]]
            assert ((ts >= 0) & (ts < il[b])).all()
            assert (ts[1:] >= ts[:-1]).all()
            assert (times[b, w, lens[b, w]:] == -1).all()
    if name == "capped":
        assert (lens[:2, 0] == 2).all()


@pytest.mark.parametrize("lookahead", [1, 4])
def test_alsd_matches_the_dict_oracle(lookahead):
    n, t_max, v, W, K, s_cap = 3, 8, 6, 4, 4, 5
    enc, jf, tf = problem(7, n=n, t=t_max, v=v, scale=1.3)
    il = np.array([t_max, t_max - 2, t_max], np.int32)
    got = beams(*tdec.rnnt_beam_decode(
        torch.from_numpy(enc), il, *tf, beam_width=W, prune_k=K,
        max_symbols=s_cap, lookahead=lookahead))
    for b in range(n):
        oracle = _alsd_oracle(enc[b], int(il[b]), *jf, W, K, s_cap, 0,
                              t_max + s_cap)
        assert got[b][0][0] == oracle[0][0]
        odict = dict(oracle)
        for y, s in got[b]:
            np.testing.assert_allclose(s, odict[y], atol=2e-3)


def test_exhaustive_beam_scores_are_exact():
    """W above the reachable states and prune_k = V-1: each beam's score is
    its sequence's total log-probability, -rnnt_loss_ref's float64 DP."""
    v, t_max, s_cap = 3, 4, 3
    enc, jf, tf = problem(0, n=2, t=t_max, v=v)
    il = np.array([t_max, t_max - 1], np.int32)
    got = beams(*tdec.rnnt_beam_decode(
        torch.from_numpy(enc), il, *tf, beam_width=16, prune_k=v - 1,
        max_symbols=s_cap))
    for b in range(2):
        assert len(got[b]) >= 10
        for y, s in got[b]:
            lat = _lattice(enc[b, :il[b]], list(y), *jf)
            nll, _ = rnnt_loss_ref(lat[None], np.array([y], np.int64)
                                   .reshape(1, -1), [il[b]], [len(y)],
                                   blank=0)
            np.testing.assert_allclose(s, -nll[0], atol=1e-4)


def _bigram_pair(v, seed):
    """The same dense bigram NGramLM in both packages and its float64
    table, row 0 the start context (tests/test_rnnt_lm.py's `_bigram`)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(v, v)) * 1.5
    tbl = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    start = rng.normal(size=(v,))
    start = start - np.log(np.exp(start).sum())
    full = np.concatenate([start[None], tbl], axis=0)
    args = (tbl.astype(np.float32), start.astype(np.float32))
    return (jlm.NGramLM(jnp.asarray(args[0]), start_logp=jnp.asarray(
        args[1])), tlm.NGramLM(*args, device="cpu"), full)


def _neural_pair(v, seed):
    params = random_gru_params(np.random.default_rng(seed), v, emb_dim=4,
                               hidden_dim=6)
    return (JaxNeuralLM.gru(params, eos_id=v - 1),
            NeuralLM.gru(params, eos_id=v - 1, device="cpu"))


def _lm_pair(kind, v):
    if kind == "bigram":
        return _bigram_pair(v, 21)[:2]
    if kind == "neural":
        return _neural_pair(v, 4)
    return word_lm_pair(np.random.default_rng(9), 2)  # space id 4


@pytest.mark.parametrize("kind", ["bigram", "hashed_word", "neural"])
def test_alsd_with_an_lm_matches_jax(kind):
    """A dense bigram, a hashed word bigram (on the route where JAX's
    score is right) and a GRU NeuralLM ride the ALSD carry."""
    enc, jf, tf = problem(7, n=3, t=9, v=6, scale=1.3)
    il = np.array([9, 7, 0], np.int32)
    jl, tl = _lm_pair(kind, 6)
    kw = dict(beam_width=4, prune_k=4, max_symbols=5, lm_alpha=0.7,
              lm_beta=0.25, return_timestamps=True)
    want = jdec.rnnt_beam_decode(enc, il, *jf, lm=jl, **kw)
    got = tdec.rnnt_beam_decode(torch.from_numpy(enc), il, *tf, lm=tl, **kw)
    assert_decodes_equal(got, want)


def test_alsd_with_a_bigram_matches_the_dict_oracle():
    n, t_max, v, W, K, s_cap = 3, 8, 6, 4, 4, 5
    alpha, beta = 0.7, 0.25
    enc, jf, tf = problem(7, n=n, t=t_max, v=v, scale=1.3)
    il = np.array([t_max, t_max - 2, t_max], np.int32)
    _, tl, table = _bigram_pair(v, 21)
    got = beams(*tdec.rnnt_beam_decode(
        torch.from_numpy(enc), il, *tf, beam_width=W, prune_k=K,
        max_symbols=s_cap, lm=tl, lm_alpha=alpha, lm_beta=beta))
    for b in range(n):
        oracle = _alsd_lm_oracle(enc[b], int(il[b]), *jf, W, K, s_cap, 0,
                                 t_max + s_cap, table, alpha, beta)
        assert got[b][0][0] == oracle[0][0]
        odict = dict(oracle)
        for y, s in got[b]:
            np.testing.assert_allclose(s, odict[y], atol=2e-3)


def test_zero_lm_weights_are_neutral():
    enc, _, tf = problem(11, n=2, t=9, v=6, scale=1.2)
    x = torch.from_numpy(enc)
    _, tl, _ = _bigram_pair(6, 3)
    want = tdec.rnnt_beam_decode(x, None, *tf, beam_width=4,
                                 return_timestamps=True)
    got = tdec.rnnt_beam_decode(x, None, *tf, beam_width=4, lm=tl,
                                return_timestamps=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lookahead", [2, 4, 8])
def test_greedy_lookahead(lookahead):
    """Every F gives lookahead 1's tokens, lengths and times, and JAX's
    for the same F; the blank-dominated joint takes runs of blanks."""
    enc, jf, tf = problem(5, n=3, t=30, v=9, blank_bias=2.0, factored=True)
    il = np.array([30, 23, 0], np.int32)
    kw = dict(max_symbols=10, return_timestamps=True)
    x = torch.from_numpy(enc)
    one = tdec.rnnt_greedy_decode(x, il, *tf, **kw)
    got = tdec.rnnt_greedy_decode(x, il, *tf, lookahead=lookahead, **kw)
    assert_decodes_equal(got, one)
    assert_decodes_equal(got, jdec.rnnt_greedy_decode(
        enc, il, *jf, lookahead=lookahead, **kw))
    assert int(one[1].max()) > 0


def test_greedy_lookahead_with_a_binding_cap():
    enc, jf, tf = problem(31, n=3, t=12, v=6, scale=1.4)
    il = np.array([12, 5, 10], np.int32)
    kw = dict(max_symbols=2, max_symbols_per_frame=1, return_timestamps=True)
    x = torch.from_numpy(enc)
    got = tdec.rnnt_greedy_decode(x, il, *tf, lookahead=4, **kw)
    assert_decodes_equal(got, tdec.rnnt_greedy_decode(x, il, *tf, **kw))
    assert_decodes_equal(got, jdec.rnnt_greedy_decode(enc, il, *jf,
                                                      lookahead=4, **kw))
    assert (got[1] == 2).all()


def test_beam_lookahead():
    enc, jf, tf = problem(13, n=3, t=16, v=6, blank_bias=1.5)
    il = np.array([16, 13, 6], np.int32)
    kw = dict(beam_width=4, prune_k=4, max_symbols=5,
              return_timestamps=True)
    x = torch.from_numpy(enc)
    got = tdec.rnnt_beam_decode(x, il, *tf, lookahead=4, **kw)
    assert_decodes_equal(got, tdec.rnnt_beam_decode(x, il, *tf, **kw))
    assert_decodes_equal(got, jdec.rnnt_beam_decode(enc, il, *jf,
                                                    lookahead=4, **kw))


def test_beam_lookahead_rejects_an_lm():
    enc, _, tf = problem(5, n=2, t=6, v=5)
    _, tl, _ = _bigram_pair(5, 0)
    with pytest.raises(ValueError, match="lookahead"):
        tdec.rnnt_beam_decode(torch.from_numpy(enc), None, *tf, lm=tl,
                              lm_alpha=0.5, lookahead=2)


@pytest.mark.parametrize("beam_width", [0, 3])
def test_float64_encoder_output_decodes_as_float32(beam_width):
    """Float64 encoder outputs are cast to float32 at entry, as JAX does
    (the greedy decode raised on them: float32 weights against a float64
    frame projection)."""
    enc, jf, tf = problem(3, n=2, t=10, v=6, factored=True)
    il = np.array([10, 7], np.int32)
    if beam_width:
        kw = dict(beam_width=beam_width, max_symbols=5,
                  return_timestamps=True)
        fn, jfn = tdec.rnnt_beam_decode, jdec.rnnt_beam_decode
    else:
        kw = dict(max_symbols=5, return_timestamps=True)
        fn, jfn = tdec.rnnt_greedy_decode, jdec.rnnt_greedy_decode
    got = fn(torch.from_numpy(enc.astype(np.float64)), il, *tf, **kw)
    assert got[2].dtype == torch.float32
    want32 = fn(torch.from_numpy(enc), il, *tf, **kw)
    for g, w in zip(got, want32):
        assert torch.equal(g, w)
    assert_decodes_equal(got, jfn(enc.astype(np.float64), il, *jf, **kw))

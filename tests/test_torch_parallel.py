"""The port's data-, vocabulary- and time-parallel entry points on D=4 gloo
ranks on the CPU, against the port's unsharded functions and against the
JAX package's sharded functions on a 4-device mesh of tests/conftest.py's
virtual CPU devices (the cases of tests/test_sharding.py), and the
multi-GPU dry run at 4 ranks.

The four ranks are spawned once: a module fixture runs every case in
them and the tests below assert on what they saved, so each case counts
on its own.  The ranks import this module, which imports no JAX at its
top (the JAX references are computed in this process only); they meet
over a `file://` rendezvous under a temporary directory.  The problems
are drawn from numpy seeds by functions both sides call.

Conventions held: data parallel passes each rank its own rows (the tests
concatenate the ranks' rows); vocabulary and time parallel pass every
rank the global values (the ranks' results must agree, and each rank's
gradient is zero outside its columns or frames; their sum is the whole
gradient).

Tolerances, and why:
  * data parallel against the unsharded port: the per-sample losses and
    gradients bit-equal (the same functions on the same rows); reduced
    losses 1e-6 (JAX's test: the cross-rank sum in another order);
    decodes' tokens, lengths and times equal, scores 1e-5 (JAX's);
  * vocabulary parallel against the unsharded port: the NLL and the
    gradient bit-equal (the same floats through the same scans and
    scatter order), greedy and the merged top-K bit-equal, beam
    decodes' scores 1e-5 (JAX's test), the chunked decode 1e-6;
  * time parallel against the unsharded port: 1e-4 on the NLL, rtol
    1e-4 / atol 2e-4 on the gradient (JAX's: plain logsumexp over
    composed operators against the renormalised scan);
  * anything against JAX's sharded functions: losses rtol 2e-5 and
    gradients atol 1e-5 (tests/test_torch_ctc_loss.py's port-vs-JAX
    budget for the CTC scans), transducer losses rtol 1e-5, decode
    scores rtol 1e-5 / atol 1e-4 (tests/test_torch_rnnt_beam.py's),
    CTC beams as beam sets with scores within 5e-4
    (tests/test_torch_beam.py's), the chunked word-LM decode's tokens
    and lengths equal with scores within 5e-4
    (tests/test_torch_beam_lm.py's), time parallel 1e-4 as above.
"""

import functools
import time
from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from end2end_tpu_torch import (StreamingRNNTBeamDecoder,
                               StreamingRNNTGreedyDecoder,
                               beam_search_decode, ctc_loss, greedy_decode,
                               rnnt_beam_decode, rnnt_greedy_decode,
                               rnnt_loss)
from end2end_tpu_torch.ops.beam_chunked import beam_search_chunked_lm
from end2end_tpu_torch.ops.beam_search import beam_search_from_topk
from end2end_tpu_torch.ops.ctc_loss import ctc_nll
from end2end_tpu_torch.ops.lm import NGramLM, WordNGramLM, bigram_from_counts
from end2end_tpu_torch.ops.neural_lm import (NeuralLM, gru_step,
                                             random_gru_params)
from end2end_tpu_torch.ops.rnnt_decode import FactoredAdditiveJoint
from end2end_tpu_torch.ops.topk_cuda import topk_plain
from end2end_tpu_torch.parallel import (DataParallelStreamingRNNT,
                                        beam_search_decode_vocab_parallel,
                                        beam_topk_prep_vocab_parallel,
                                        ctc_loss_data_parallel,
                                        ctc_nll_time_parallel,
                                        ctc_nll_vocab_parallel,
                                        greedy_decode_data_parallel,
                                        greedy_decode_vocab_parallel,
                                        group_rank,
                                        rnnt_beam_decode_data_parallel,
                                        rnnt_greedy_decode_data_parallel,
                                        rnnt_loss_data_parallel, shard_batch)
from end2end_tpu_torch.parallel.dryrun import dryrun_multichip, jax_free

D = 4
JOIN_S = 600  # the ranks' time limit
REDUCTIONS = ("none", "mean", "sum")


# --------------------------------------------------------------------------
# problems, drawn alike in the ranks and in this process
# --------------------------------------------------------------------------

def ctc_problem(seed, b, t, s, v, min_t_frac=0.5):
    """tests/conftest.py's `random_ctc_problem` draw."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, b, v)).astype(np.float64) * 2.0
    lp = logits - np.log(np.sum(np.exp(logits), axis=-1, keepdims=True))
    il = rng.integers(max(1, int(t * min_t_frac)), t + 1, size=b)
    tl = rng.integers(1, s + 1, size=b)
    tl = np.minimum(tl, np.maximum(il // 3, 1))
    labels = rng.integers(1, v, size=(b, s))
    return (lp.astype(np.float32), labels.astype(np.int32),
            il.astype(np.int32), tl.astype(np.int32))


@functools.cache
def problem(name):
    if name == "dp_loss":
        return ctc_problem(1, 16, 30, 8, 12)
    if name == "dp_grad":
        return ctc_problem(2, 8, 24, 6, 10)
    if name == "dp_greedy":
        return ctc_problem(3, 8, 20, 3, 9)
    if name in ("rnnt_loss", "rnnt_grad"):
        rng = np.random.default_rng(4 if name == "rnnt_loss" else 5)
        b, t, u, v = (8, 12, 4, 9) if name == "rnnt_loss" else (8, 10, 3, 7)
        logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
        tgt = rng.integers(1, v, (b, u)).astype(np.int32)
        if name == "rnnt_loss":
            il = rng.integers(t // 2, t + 1, (b,)).astype(np.int32)
            ul = rng.integers(1, u + 1, (b,)).astype(np.int32)
        else:
            il, ul = np.full(b, t, np.int32), np.full(b, u, np.int32)
        return logits, tgt, il, ul
    if name == "vp_loss":
        lp, tgt, _, tl = ctc_problem(7, 3, 40, 6, 64)
        return lp, tgt, np.array([40, 25, 33], np.int32), tl
    if name == "vp_blank":
        lp = ctc_problem(8, 2, 12, 3, 32)[0]
        return (lp, np.array([[5, 5, 5], [9, 9, 2]], np.int32),
                np.array([12, 3], np.int32), np.array([3, 3], np.int32))
    if name == "vp_greedy":
        lp, _, _, _ = ctc_problem(9, 5, 30, 3, 64)
        lp[4, 0, 3] = lp[4, 0, 40] = lp[4, 0].max() + 1.0  # cross-shard tie
        lp[9, 2, 8] = lp[9, 2, 9] = lp[9, 2].max() + 1.0
        il = np.random.default_rng(9).integers(15, 31, 5).astype(np.int32)
        return lp, il
    if name == "vp_prep":
        lp = ctc_problem(10, 3, 12, 3, 64)[0]
        lp[2, 1, 5] = lp[2, 1, 37]  # a cross-shard exact tie
        return lp
    if name == "vp_beam":
        lp = ctc_problem(11, 3, 14, 3, 16)[0]
        return lp, np.array([14, 9, 12], np.int32)
    if name == "tp_loss":
        return ctc_problem(12, 4, 64, 6, 10)
    if name == "tp_rep":
        lp = ctc_problem(13, 2, 32, 4, 6)[0]
        return (lp, np.array([[2, 2, 3, 3], [1, 1, 1, 4]], np.int32),
                np.array([32, 21], np.int32), np.array([4, 3], np.int32))
    if name == "tp_grad":
        lp, tgt, _, tl = ctc_problem(14, 3, 64, 5, 8)
        return lp, tgt, np.array([64, 43, 29], np.int32), tl
    if name == "tp_imp":
        lp = ctc_problem(15, 2, 16, 3, 5)[0]
        return (lp, np.array([[1, 2, 1], [2, 2, 2]], np.int32),
                np.array([16, 4], np.int32), np.array([3, 3], np.int32))
    raise KeyError(name)


@functools.cache
def decoder_arrays(v=13, seed=6, n=8, t=20, h_enc=12, emb=8, hid=12,
                   jdim=12):
    """tests/test_sharding.py's `_rnnt_decode_setup` draw, as numpy."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, t, h_enc)).astype(np.float32)
    gru = random_gru_params(rng, v, emb_dim=emb, hidden_dim=hid)

    def w(*s):
        return (rng.standard_normal(s) * 0.5 / np.sqrt(s[0])).astype(
            np.float32)

    joint = (w(h_enc, jdim), w(hid, jdim), 0.1 * w(jdim), w(jdim, v),
             0.1 * w(v))
    il = rng.integers(t // 2, t + 1, n).astype(np.int32)
    counts = rng.integers(0, 8, (v, v))
    return enc, gru, joint, il, counts, hid


def torch_decoder(v=13):
    enc, gru, joint, il, counts, hid = decoder_arrays(v)
    gp = {k: torch.from_numpy(x) for k, x in gru.items()}
    return (torch.from_numpy(enc), torch.from_numpy(il), partial(gru_step, gp),
            torch.zeros(hid),
            FactoredAdditiveJoint(*(torch.from_numpy(x) for x in joint)))


GREEDY_KW = (dict(max_symbols=8), dict(max_symbols=8, lookahead=4),
             dict(max_symbols=8, return_timestamps=True))
BEAM_KW = (dict(beam_width=4, max_symbols=8),
           dict(beam_width=4, max_symbols=8, lookahead=4),
           dict(beam_width=2, max_symbols=6, prune_k=3,
                return_timestamps=True))


def bigram_lm(v, seed):
    rng = np.random.default_rng(seed)
    return bigram_from_counts(rng.integers(0, 10, (v, v)))


def word_lm_arrays():
    rng = np.random.default_rng(16)
    words = [(1,), (2,), (1, 2), (2, 1)]
    wv = len(words)
    bigram = np.log(np.maximum(rng.random((wv, wv)).astype(np.float32),
                               1e-3))
    start = rng.standard_normal(wv).astype(np.float32)
    uni = rng.standard_normal(wv).astype(np.float32)
    return words, bigram, start, uni, rng.integers(0, 10, (16, 16))


def neural_lm_params():
    return random_gru_params(np.random.default_rng(17), 16, emb_dim=6,
                             hidden_dim=8)


def torch_lms():
    words, bigram, start, uni, counts = word_lm_arrays()
    word = WordNGramLM(words, bigram, start, space_id=3, unigram_logp=uni,
                       unk_logp=-13.0, device="cpu")
    guide = NGramLM(bigram_from_counts(counts), device="cpu")
    return word, guide


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _rows(x, rank, axis=0):
    n = x.shape[axis] // D
    return torch.as_tensor(x).narrow(axis, rank * n, n)


def _ctc_args(name):
    lp, tgt, il, tl = problem(name)
    return torch.from_numpy(lp), tgt, il, tl


def _run_dp(rank, out):
    lp, tgt, il, tl = _ctc_args("dp_loss")
    args = shard_batch(None, lp, tgt, il, tl)
    out["dp_loss"] = {r: ctc_loss_data_parallel(*args, reduction=r).detach()
                      for r in REDUCTIONS}
    lp, tgt, il, tl = _ctc_args("dp_grad")
    x, t, i, l = shard_batch(None, lp, tgt, il, tl)
    x = x.clone().requires_grad_()
    ctc_loss_data_parallel(x, t, i, l).backward()
    out["dp_grad"] = x.grad
    lp, tgt, il, tl = _ctc_args("dp_loss")
    try:
        shard_batch(None, lp[:, :10], tgt[:10], il[:10], tl[:10])
    except ValueError as e:
        out["dp_uneven"] = str(e)
    lp, _, il, _ = _ctc_args("dp_greedy")
    out["dp_greedy"] = greedy_decode_data_parallel(
        _rows(lp, rank, 1), _rows(il, rank))
    logits, tgt, il, ul = problem("rnnt_loss")
    a = [_rows(x, rank) for x in (logits, tgt, il, ul)]
    out["rnnt_loss"] = {r: rnnt_loss_data_parallel(*a, reduction=r).detach()
                        for r in REDUCTIONS}
    logits, tgt, il, ul = problem("rnnt_grad")
    x = _rows(logits, rank).clone().requires_grad_()
    rnnt_loss_data_parallel(x, *(_rows(y, rank) for y in (tgt, il, ul))
                            ).backward()
    out["rnnt_grad"] = x.grad
    enc, il, pred, h0, joint = torch_decoder()
    mine, il_r = _rows(enc, rank), _rows(il, rank)
    out["rnnt_greedy"] = [rnnt_greedy_decode_data_parallel(
        mine, il_r, pred, h0, joint, **kw) for kw in GREEDY_KW]
    out["rnnt_beam"] = [rnnt_beam_decode_data_parallel(
        mine, il_r, pred, h0, joint, **kw) for kw in BEAM_KW]
    enc9, il9, pred9, h09, joint9 = torch_decoder(9)
    lm = NGramLM(bigram_from_counts(decoder_arrays(9)[4]), device="cpu")
    out["rnnt_beam_lm"] = rnnt_beam_decode_data_parallel(
        _rows(enc9, rank), _rows(il9, rank), pred9, h09, joint9,
        beam_width=4, max_symbols=6, lm=lm, lm_alpha=0.5, lm_beta=0.1)
    out["rnnt_stream"] = []
    for dec in _stream_decoders(pred, h0, joint):
        dp = DataParallelStreamingRNNT(dec)
        init = (enc.shape[0],) + (() if isinstance(
            dec, StreamingRNNTGreedyDecoder) else (enc.shape[2],))
        st = dp.init(*init)
        for lo, hi in ((0, 7), (7, 14), (14, enc.shape[1])):
            cl = torch.clamp(il_r - lo, 0, hi - lo).to(torch.int32)
            st = dp.step(st, mine[:, lo:hi], cl)
        out["rnnt_stream"].append(dp.finish(st, return_timestamps=True))
    try:
        DataParallelStreamingRNNT(dec).init(6, enc.shape[2])
    except ValueError as e:
        out["stream_uneven"] = str(e)


def _stream_decoders(pred, h0, joint):
    return (StreamingRNNTGreedyDecoder(pred, h0, joint, max_symbols=8),
            StreamingRNNTBeamDecoder(pred, h0, joint, beam_width=4,
                                     max_symbols=8, lookahead=4))


def _weighted_grad(fn, lp, weights=None, finite_only=False):
    x = lp.clone().requires_grad_()
    nll = fn(x)
    w = torch.ones_like(nll) if weights is None else torch.tensor(weights)
    terms = nll * w
    if finite_only:
        terms = torch.where(torch.isfinite(nll), terms, 0.0)
    terms.sum().backward()
    return nll.detach(), x.grad


VP_WEIGHTS = [1.0, 0.5, 2.0]
TP_WEIGHTS = [0.5, 2.0, -1.0]


def _run_vp(rank, out):
    lp, tgt, il, tl = _ctc_args("vp_loss")
    out["vp_loss"] = _weighted_grad(
        lambda x: ctc_nll_vocab_parallel(x, tgt, il, tl), lp, VP_WEIGHTS)
    lp, tgt, il, tl = _ctc_args("vp_blank")
    for blank in (0, 13):
        out[f"vp_blank/{blank}"] = _weighted_grad(
            lambda x: ctc_nll_vocab_parallel(x, tgt, il, tl, blank=blank),
            lp, finite_only=True)
    try:
        ctc_nll_vocab_parallel(lp[:, :, :30], tgt, il, tl)
    except ValueError as e:
        out["vp_indivisible"] = str(e)
    lp, il = problem("vp_greedy")
    out["vp_greedy"] = greedy_decode_vocab_parallel(torch.from_numpy(lp), il)
    lp = torch.from_numpy(problem("vp_prep"))
    out["vp_prep"] = beam_topk_prep_vocab_parallel(lp, None, 10)
    lp, il = problem("vp_beam")
    lp = torch.from_numpy(lp)
    kw = dict(beam_width=6, max_symbols=16)
    out["vp_beam_full"] = beam_search_decode_vocab_parallel(lp, il, **kw)
    out["vp_beam_pruned"] = beam_search_decode_vocab_parallel(
        lp, il, prune_k=6, **kw)
    out["vp_beam_tmin"] = beam_search_decode_vocab_parallel(
        lp, il, token_min_logp=-2.5, implementation="xla", **kw)
    out["vp_beam_routes"] = [
        [beam_search_decode_vocab_parallel(
            lp, il, beam_width=4, prune_k=k, max_symbols=10,
            implementation=impl) for impl in ("pallas", "xla")]
        for k in (None, 6)]
    lm = NGramLM(bigram_lm(16, 18), device="cpu")
    out["vp_beam_lm"] = beam_search_decode_vocab_parallel(
        lp[:12, :2], None, beam_width=4, lm=lm, lm_alpha=0.7, lm_beta=0.2,
        max_symbols=16)
    nlm = NeuralLM.gru(neural_lm_params(), eos_id=2, device="cpu")
    out["vp_beam_neural"] = beam_search_decode_vocab_parallel(
        lp[:12], il.clip(max=12), beam_width=4, max_symbols=12, lm=nlm,
        lm_alpha=0.8, lm_beta=0.3)
    word, guide = torch_lms()
    out["vp_chunked"] = [beam_search_decode_vocab_parallel(
        lp, il, beam_width=4, prune_k=8, max_symbols=16, lm=word,
        lm_alpha=0.7, lm_beta=0.3, implementation="chunked", lm_chunk_t=5,
        guide_lm=g) for g in (None, guide)]
    try:
        beam_search_decode_vocab_parallel(lp, il, beam_width=4, lm=word,
                                          guide_lm=guide)
    except ValueError as e:
        out["vp_guide_raises"] = str(e)


def _run_tp(rank, out):
    for name in ("tp_loss", "tp_rep"):
        lp, tgt, il, tl = _ctc_args(name)
        out[name] = ctc_nll_time_parallel(lp, tgt, il, tl)
    lp, tgt, il, tl = _ctc_args("tp_grad")
    out["tp_grad"] = [_weighted_grad(
        lambda x: ctc_nll_time_parallel(x, tgt, il, tl), lp, w)
        for w in (None, TP_WEIGHTS)]
    lp, tgt, il, tl = _ctc_args("tp_imp")
    out["tp_imp"] = _weighted_grad(
        lambda x: ctc_nll_time_parallel(x, tgt, il, tl), lp,
        finite_only=True)
    try:
        ctc_nll_time_parallel(lp[:14], tgt, il, tl)
    except ValueError as e:
        out["tp_indivisible"] = str(e)


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=D, rank=rank)
    try:
        out = {"rank": group_rank()}
        _run_dp(rank, out)
        _run_vp(rank, out)
        _run_tp(rank, out)
        out["jax_free"] = jax_free()
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of D gloo ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    ctx = mp.spawn(_rank_main, args=(str(tmp),), nprocs=D, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {D} ranks ran past {JOIN_S} s")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(D)]


def gathered(ranks, key, axis=0):
    """The ranks' rows of a data-parallel result, in rank order."""
    parts = [r[key] for r in ranks]
    if isinstance(parts[0], (tuple, list)):
        return [torch.cat(p, axis) for p in zip(*parts)]
    return torch.cat(parts, axis)


def replicated(ranks, key):
    """A vocabulary- or time-parallel result: the ranks agree exactly."""
    first = ranks[0][key]
    for r in ranks[1:]:
        for a, b in zip(_leaves(first), _leaves(r[key])):
            assert torch.equal(a, b), key
    return first


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [y for item in x for y in _leaves(item)]


def assert_decodes(got, want, atol=1e-5, rtol=0.0, score_idx=2):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if i == score_idx:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
        else:
            np.testing.assert_array_equal(a, b)


def beam_sets(tokens, lens, scores):
    tokens, lens, scores = (np.asarray(x) for x in (tokens, lens, scores))
    return [{tuple(tokens[b, w, : int(lens[b, w])].tolist()):
             float(scores[b, w])
             for w in range(tokens.shape[1]) if np.isfinite(scores[b, w])}
            for b in range(tokens.shape[0])]


def assert_beam_sets(got, want, atol):
    for g, w in zip(beam_sets(*got[:3]), beam_sets(*want[:3])):
        assert set(g) == set(w), set(g) ^ set(w)
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=atol, rtol=0)


# --------------------------------------------------------------------------
# JAX's sharded functions, in this process only
# --------------------------------------------------------------------------

def _mesh(axis):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:D]), (axis,))


def jax_vp_beam(lp, il, **kw):
    """JAX's `beam_search_decode_vocab_parallel` on the 4-device mesh."""
    import jax.numpy as jnp

    from end2end_tpu.parallel import vocab_parallel as jvp

    return jvp.beam_search_decode_vocab_parallel(
        jnp.asarray(lp), il, mesh=_mesh("model"), **kw)


def jax_lms():
    from end2end_tpu.ops import lm as jlm

    words, bigram, start, uni, counts = word_lm_arrays()
    word = jlm.WordNGramLM(words, bigram, start, space_id=3,
                           unigram_logp=uni, unk_logp=-13.0)
    return word, jlm.NGramLM(jlm.bigram_from_counts(counts))


def jax_decoder(v=13):
    import jax.numpy as jnp

    from end2end_tpu.ops.neural_lm import gru_step as jgru
    from end2end_tpu.ops.rnnt_decode import FactoredAdditiveJoint as JJoint

    enc, gru, joint, il, counts, hid = decoder_arrays(v)
    gp = {k: jnp.asarray(x) for k, x in gru.items()}
    return (jnp.asarray(enc), jnp.asarray(il), partial(jgru, gp),
            jnp.zeros((hid,), jnp.float32),
            JJoint(*(jnp.asarray(x) for x in joint)))


# --------------------------------------------------------------------------
# data parallel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_dp_ctc_loss(ranks, reduction):
    import jax.numpy as jnp

    from end2end_tpu.parallel import sharding as js

    lp, tgt, il, tl = problem("dp_loss")
    if reduction == "none":
        got = torch.cat([r["dp_loss"]["none"] for r in ranks])
    else:
        got = replicated([{"x": r["dp_loss"][reduction]} for r in ranks],
                         "x")
    want = ctc_loss(torch.from_numpy(lp), tgt, il, tl, reduction=reduction)
    if reduction == "none":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    import jax

    mesh = js.make_mesh(D)
    jax_got = jax.jit(partial(js.ctc_loss_data_parallel, mesh=mesh,
                              reduction=reduction))(
        *js.shard_batch(mesh, jnp.asarray(lp), tgt, il, tl))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=2e-5)


def test_dp_ctc_gradient(ranks):
    import jax
    import jax.numpy as jnp

    from end2end_tpu.parallel import sharding as js

    lp, tgt, il, tl = problem("dp_grad")
    got = torch.cat([r["dp_grad"] for r in ranks], 1)
    x = torch.from_numpy(lp).requires_grad_()
    ctc_loss(x, tgt, il, tl).backward()
    assert torch.equal(got, x.grad)
    mesh = js.make_mesh(D)
    args = js.shard_batch(mesh, jnp.asarray(lp), tgt, il, tl)
    want = jax.jit(jax.grad(lambda y: js.ctc_loss_data_parallel(
        y, *args[1:], mesh=mesh)))(args[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_dp_uneven_batch_raises(ranks):
    for r in ranks:
        assert "divide evenly" in r["dp_uneven"]
        assert "divide evenly" in r["stream_uneven"]


def test_dp_greedy(ranks):
    import jax.numpy as jnp

    from end2end_tpu.parallel import sharding as js

    lp, _, il, _ = problem("dp_greedy")
    got = gathered(ranks, "dp_greedy")
    assert_decodes(got, greedy_decode(torch.from_numpy(lp), il), atol=0)
    import jax

    mesh = js.make_mesh(D)
    assert_decodes(got, jax.jit(partial(
        js.greedy_decode_data_parallel, mesh=mesh))(
            jnp.asarray(lp), jnp.asarray(il)), atol=1e-5)


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_dp_rnnt_loss(ranks, reduction):
    import jax.numpy as jnp

    from end2end_tpu.parallel import sharding as js

    logits, tgt, il, ul = problem("rnnt_loss")
    parts = [r["rnnt_loss"][reduction] for r in ranks]
    want = rnnt_loss(torch.from_numpy(logits), tgt, il, ul,
                     reduction=reduction)
    if reduction == "none":
        got = torch.cat(parts)
        assert torch.equal(got, want)
    else:
        got = parts[0]
        assert all(torch.equal(p, got) for p in parts)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    import jax

    jax_got = jax.jit(partial(js.rnnt_loss_data_parallel,
                              mesh=js.make_mesh(D), reduction=reduction))(
        *(jnp.asarray(x) for x in (logits, tgt, il, ul)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=1e-5)


def test_dp_rnnt_gradient(ranks):
    import jax
    import jax.numpy as jnp

    from end2end_tpu.parallel import sharding as js

    logits, tgt, il, ul = problem("rnnt_grad")
    got = torch.cat([r["rnnt_grad"] for r in ranks])
    x = torch.from_numpy(logits).requires_grad_()
    rnnt_loss(x, tgt, il, ul).backward()
    assert torch.equal(got, x.grad)
    mesh = js.make_mesh(D)
    want = jax.jit(jax.grad(lambda y: js.rnnt_loss_data_parallel(
        y, *(jnp.asarray(a) for a in (tgt, il, ul)), mesh=mesh)))(
            jnp.asarray(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", range(len(GREEDY_KW)))
def test_dp_rnnt_greedy(ranks, case):
    from end2end_tpu.parallel import sharding as js

    kw = GREEDY_KW[case]
    got = [torch.cat(p) for p in zip(*(r["rnnt_greedy"][case]
                                       for r in ranks))]
    enc, il, pred, h0, joint = torch_decoder()
    assert_decodes(got, rnnt_greedy_decode(enc, il, pred, h0, joint, **kw))
    assert_decodes(got, js.rnnt_greedy_decode_data_parallel(
        *jax_decoder(), js.make_mesh(D), **kw), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", range(len(BEAM_KW)))
def test_dp_rnnt_beam(ranks, case):
    from end2end_tpu.parallel import sharding as js

    kw = BEAM_KW[case]
    got = [torch.cat(p) for p in zip(*(r["rnnt_beam"][case]
                                       for r in ranks))]
    enc, il, pred, h0, joint = torch_decoder()
    assert_decodes(got, rnnt_beam_decode(enc, il, pred, h0, joint, **kw))
    assert_decodes(got, js.rnnt_beam_decode_data_parallel(
        *jax_decoder(), js.make_mesh(D), **kw), atol=1e-4, rtol=1e-5)


def test_dp_rnnt_beam_with_lm(ranks):
    from end2end_tpu.ops.lm import NGramLM as JaxNGramLM
    from end2end_tpu.ops.lm import bigram_from_counts as jax_bigram
    from end2end_tpu.parallel import sharding as js

    kw = dict(beam_width=4, max_symbols=6, lm_alpha=0.5, lm_beta=0.1)
    got = [torch.cat(p) for p in zip(*(r["rnnt_beam_lm"] for r in ranks))]
    counts = decoder_arrays(9)[4]
    lm = NGramLM(bigram_from_counts(counts), device="cpu")
    enc, il, pred, h0, joint = torch_decoder(9)
    assert_decodes(got, rnnt_beam_decode(enc, il, pred, h0, joint, lm=lm,
                                         **kw))
    assert_decodes(got, js.rnnt_beam_decode_data_parallel(
        *jax_decoder(9), js.make_mesh(D),
        lm=JaxNGramLM(jax_bigram(counts)), **kw), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_dp_streaming_wrapper(ranks, kind):
    """Each rank streams its rows' state through three chunks: the same
    as the unsharded stream, and as JAX's sharded one."""
    from end2end_tpu.ops import streaming_decode as jsd
    from end2end_tpu.parallel import sharding as js

    i = 0 if kind == "greedy" else 1
    got = [torch.cat(p) for p in zip(*(r["rnnt_stream"][i] for r in ranks))]
    enc, il, pred, h0, joint = torch_decoder()
    dec = _stream_decoders(pred, h0, joint)[i]
    init = (enc.shape[0],) if i == 0 else (enc.shape[0], enc.shape[2])
    st = dec.init(*init)
    for lo, hi in ((0, 7), (7, 14), (14, enc.shape[1])):
        st = dec.step(st, enc[:, lo:hi],
                      torch.clamp(il - lo, 0, hi - lo).to(torch.int32))
    assert_decodes(got, dec.finish(st, return_timestamps=True))
    jenc, jil, jpred, jh0, jjoint = jax_decoder()
    jdec = (jsd.StreamingRNNTGreedyDecoder(jpred, jh0, jjoint, max_symbols=8)
            if i == 0 else
            jsd.StreamingRNNTBeamDecoder(jpred, jh0, jjoint, beam_width=4,
                                         max_symbols=8, lookahead=4))
    dp = js.DataParallelStreamingRNNT(jdec, js.make_mesh(D))
    jst = dp.init(*init)
    for lo, hi in ((0, 7), (7, 14), (14, enc.shape[1])):
        cl = np.clip(np.asarray(jil) - lo, 0, hi - lo).astype(np.int32)
        jst = dp.step(jst, jenc[:, lo:hi], cl)
    assert_decodes(got, dp.finish(jst, return_timestamps=True), atol=1e-4,
                   rtol=1e-5)


# --------------------------------------------------------------------------
# vocabulary parallel
# --------------------------------------------------------------------------

def _own_columns_only(ranks, key, v):
    """Each rank's gradient is zero outside its columns; their sum."""
    total = 0
    for r, res in enumerate(ranks):
        g = res[key][1]
        own = torch.zeros(v, dtype=torch.bool)
        own[r * v // D:(r + 1) * v // D] = True
        assert not g[:, :, ~own].any(), (key, r)
        total = total + g
    return total


def _unsharded_grad(fn, lp, weights=None, finite_only=False):
    return _weighted_grad(fn, torch.from_numpy(lp), weights, finite_only)


def test_vp_ctc_loss_and_gradient(ranks):
    import jax
    import jax.numpy as jnp

    from end2end_tpu.parallel import vocab_parallel as jvp

    lp, tgt, il, tl = problem("vp_loss")
    nll = replicated([{"x": r["vp_loss"][0]} for r in ranks], "x")
    grad = _own_columns_only(ranks, "vp_loss", 64)
    want_nll, want_grad = _unsharded_grad(
        lambda x: ctc_nll(x, tgt, il, tl), lp, VP_WEIGHTS)
    assert torch.equal(nll, want_nll)
    assert torch.equal(grad, want_grad)
    mesh = _mesh("model")
    w = jnp.asarray(VP_WEIGHTS, jnp.float32)
    j_nll = jax.jit(lambda x: jvp.ctc_nll_vocab_parallel(
        x, tgt, il, tl, mesh=mesh))(jnp.asarray(lp))
    j_grad = jax.jit(jax.grad(lambda x: jnp.sum(jvp.ctc_nll_vocab_parallel(
        x, tgt, il, tl, mesh=mesh) * w)))(jnp.asarray(lp))
    np.testing.assert_allclose(nll.numpy(), np.asarray(j_nll), rtol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("blank", [0, 13])
def test_vp_impossible_sample_and_blank_ownership(ranks, blank):
    """The blank on the first shard or a middle one; sample 1 cannot align
    (a repeat needs 4 frames, it has 3): +inf and a zero gradient."""
    lp, tgt, il, tl = problem("vp_blank")
    key = f"vp_blank/{blank}"
    nll = replicated([{"x": r[key][0]} for r in ranks], "x")
    grad = _own_columns_only(ranks, key, 32)
    assert torch.isfinite(nll[0]) and torch.isinf(nll[1])
    assert not grad[:, 1].any()
    want_nll, want_grad = _unsharded_grad(
        lambda x: ctc_nll(x, tgt, il, tl, blank=blank), lp,
        finite_only=True)
    assert torch.equal(nll, want_nll) and torch.equal(grad, want_grad)
    if blank == 0:
        import jax.numpy as jnp

        from end2end_tpu.parallel import vocab_parallel as jvp

        import jax

        mesh = _mesh("model")
        j_nll = jax.jit(lambda x: jvp.ctc_nll_vocab_parallel(
            x, tgt, il, tl, mesh=mesh))(jnp.asarray(lp))
        np.testing.assert_allclose(nll.numpy(), np.asarray(j_nll),
                                   rtol=2e-5)


def test_vp_indivisible_vocab_raises(ranks):
    for r in ranks:
        assert "divide" in r["vp_indivisible"]


def test_vp_greedy_ties(ranks):
    import jax.numpy as jnp

    from end2end_tpu.parallel import vocab_parallel as jvp

    lp, il = problem("vp_greedy")
    got = replicated(ranks, "vp_greedy")
    assert_decodes(got, greedy_decode(torch.from_numpy(lp), il), atol=0)
    assert_decodes(got, jvp.greedy_decode_vocab_parallel(
        jnp.asarray(lp), il, mesh=_mesh("model")), atol=1e-5)


def test_vp_prep_is_the_global_topk(ranks):
    import jax
    import jax.numpy as jnp

    lp = problem("vp_prep")
    lpk, ck, lpb = replicated(ranks, "vp_prep")
    wv, wi = topk_plain(torch.from_numpy(lp), 10)
    assert torch.equal(lpk, wv) and torch.equal(ck, wi)
    assert torch.equal(lpb, torch.from_numpy(lp[:, :, 0]))
    jv, ji = jax.lax.top_k(jnp.asarray(lp), 10)
    np.testing.assert_array_equal(lpk.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ck.numpy(), np.asarray(ji))


def test_vp_beam_full_vocabulary(ranks):
    """At K = V the candidate-only decode is the exact prefix beam."""
    from end2end_tpu.ops.beam_search import beam_search_decode as jax_beam
    from end2end_tpu.parallel import vocab_parallel as jvp

    import jax.numpy as jnp

    lp, il = problem("vp_beam")
    got = replicated(ranks, "vp_beam_full")
    want = beam_search_decode(torch.from_numpy(lp), il, beam_width=6,
                              max_symbols=16, implementation="xla")
    assert_beam_sets(got, want, 1e-5)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert_beam_sets(got, jvp.beam_search_decode_vocab_parallel(
        jnp.asarray(lp), il, mesh=_mesh("model"), beam_width=6,
        max_symbols=16), 5e-4)
    assert_beam_sets(got, jax_beam(lp, il, beam_width=6, max_symbols=16,
                                   implementation="xla"), 5e-4)


def test_vp_beam_pruned_is_the_unsharded_candidate_decode(ranks):
    lp, il = problem("vp_beam")
    got = replicated(ranks, "vp_beam_pruned")
    lpt = torch.from_numpy(lp)
    lpk, ck = topk_plain(lpt, 6)
    want = beam_search_from_topk(lpk, ck, lpt[:, :, 0], il, 6, 0, 16)
    assert_decodes(got, want, atol=0)
    assert_beam_sets(got, jax_vp_beam(lp, il, beam_width=6, prune_k=6,
                                      max_symbols=16), 5e-4)


def test_vp_beam_token_min_logp(ranks):
    lp, il = problem("vp_beam")
    got = replicated(ranks, "vp_beam_tmin")
    want = beam_search_decode(torch.from_numpy(lp), il, beam_width=6,
                              max_symbols=16, implementation="xla",
                              token_min_logp=-2.5)
    assert_decodes(got, want, atol=1e-5)
    assert_beam_sets(got, jax_vp_beam(
        lp, il, beam_width=6, max_symbols=16, implementation="xla",
        token_min_logp=-2.5), 5e-4)


@pytest.mark.parametrize("case", [0, 1])
def test_vp_beam_kernel_route_equals_the_scan(ranks, case):
    """'pallas' (the beam step's semantics, its plain twin here) and
    'xla' (the candidate scan) decode the merged candidates alike."""
    kern, scan = replicated(ranks, "vp_beam_routes")[case]
    assert_decodes(kern, scan, atol=5e-4)


def test_vp_beam_with_bigram_lm(ranks):
    lp, _ = problem("vp_beam")
    got = replicated(ranks, "vp_beam_lm")
    lm = NGramLM(bigram_lm(16, 18), device="cpu")
    want = beam_search_decode(torch.from_numpy(lp[:12, :2]), None,
                              beam_width=4, lm=lm, lm_alpha=0.7, lm_beta=0.2,
                              max_symbols=16, implementation="xla")
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert_beam_sets(got, want, 1e-5)
    from end2end_tpu.ops.lm import NGramLM as JaxNGramLM

    assert_beam_sets(got, jax_vp_beam(
        lp[:12, :2], None, beam_width=4, lm=JaxNGramLM(bigram_lm(16, 18)),
        lm_alpha=0.7, lm_beta=0.2, max_symbols=16), 5e-4)


def test_vp_beam_with_neural_lm(ranks):
    from end2end_tpu.ops.neural_lm import NeuralLM as JaxNeuralLM
    from end2end_tpu.parallel import vocab_parallel as jvp

    import jax.numpy as jnp

    lp, il = problem("vp_beam")
    il = il.clip(max=12)
    got = replicated(ranks, "vp_beam_neural")
    nlm = NeuralLM.gru(neural_lm_params(), eos_id=2, device="cpu")
    kw = dict(beam_width=4, max_symbols=12, lm_alpha=0.8, lm_beta=0.3)
    want = beam_search_decode(torch.from_numpy(lp[:12]), il, lm=nlm,
                              implementation="xla", **kw)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert_beam_sets(got, want, 1e-5)
    jlm = JaxNeuralLM.gru(neural_lm_params(), eos_id=2)
    assert_beam_sets(got, jvp.beam_search_decode_vocab_parallel(
        jnp.asarray(lp[:12]), il, mesh=_mesh("model"), lm=jlm, **kw), 5e-4)


@pytest.mark.parametrize("guided", [False, True])
def test_vp_chunked_word_lm(ranks, guided):
    lp, il = problem("vp_beam")
    got = replicated(ranks, "vp_chunked")[int(guided)]
    word, guide = torch_lms()
    want = beam_search_chunked_lm(
        torch.from_numpy(lp), il, beam_width=4, prune_k=8, max_symbols=16,
        lm=word, lm_alpha=0.7, lm_beta=0.3, chunk_t=5,
        guide_lm=guide if guided else None)
    assert_decodes(got, want, atol=1e-6)
    jword, jguide = jax_lms()
    assert_decodes(got, jax_vp_beam(
        lp, il, beam_width=4, prune_k=8, max_symbols=16, lm=jword,
        lm_alpha=0.7, lm_beta=0.3, implementation="chunked", lm_chunk_t=5,
        guide_lm=jguide if guided else None), atol=5e-4)
    for r in ranks:
        assert "guide_lm" in r["vp_guide_raises"]


# --------------------------------------------------------------------------
# time parallel
# --------------------------------------------------------------------------

def _own_frames_only(grads, t):
    total = 0
    for r, g in enumerate(grads):
        own = torch.zeros(t, dtype=torch.bool)
        own[r * t // D:(r + 1) * t // D] = True
        assert not g[~own].any(), r
        total = total + g
    return total


@pytest.mark.parametrize("name", ["tp_loss", "tp_rep"])
def test_tp_loss_matches_sequential(ranks, name):
    """Repeated labels and lengths that end inside a chunk ("tp_rep")."""
    import jax.numpy as jnp

    from end2end_tpu.parallel import time_parallel as jtp

    lp, tgt, il, tl = problem(name)
    got = replicated(ranks, name)
    want = ctc_nll(torch.from_numpy(lp), tgt, il, tl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    import jax

    mesh = _mesh("time")
    j_got = jax.jit(lambda x: jtp.ctc_nll_time_parallel(
        x, tgt, il, tl, mesh=mesh))(jnp.asarray(lp))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_got), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_tp_gradient_matches_sequential(ranks, weighted):
    import jax
    import jax.numpy as jnp

    from end2end_tpu.parallel import time_parallel as jtp

    lp, tgt, il, tl = problem("tp_grad")
    res = [r["tp_grad"][int(weighted)] for r in ranks]
    grad = _own_frames_only([x[1] for x in res], lp.shape[0])
    w = TP_WEIGHTS if weighted else None
    _, want = _unsharded_grad(lambda x: ctc_nll(x, tgt, il, tl), lp, w)
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-4,
                               atol=2e-4)
    jw = jnp.asarray(w if weighted else [1.0] * 3, jnp.float32)
    mesh = _mesh("time")
    j_grad = jax.jit(jax.grad(lambda x: jnp.sum(jtp.ctc_nll_time_parallel(
        x, tgt, il, tl, mesh=mesh) * jw)))(jnp.asarray(lp))
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-4,
                               atol=2e-4)


def test_tp_impossible_sample_has_zero_gradient(ranks):
    lp = problem("tp_imp")[0]
    nll = replicated([{"x": r["tp_imp"][0]} for r in ranks], "x")
    grad = _own_frames_only([r["tp_imp"][1] for r in ranks], lp.shape[0])
    assert torch.isinf(nll[1]) and torch.isfinite(nll[0])
    assert not grad[:, 1].any() and torch.isfinite(grad).all()


def test_tp_indivisible_time_raises(ranks):
    for r in ranks:
        assert "divide" in r["tp_indivisible"]


# --------------------------------------------------------------------------
# the group, the dry run
# --------------------------------------------------------------------------

def test_ranks_know_their_place_and_never_import_jax(ranks):
    assert [r["rank"] for r in ranks] == [(i, D) for i in range(D)]
    assert all(r["jax_free"] for r in ranks)


def test_needs_a_process_group():
    lp, tgt, il, tl = problem("dp_grad")
    x = torch.from_numpy(lp)
    for call in (lambda: shard_batch(None, x, tgt, il, tl),
                 lambda: ctc_loss_data_parallel(x, tgt, il, tl),
                 lambda: greedy_decode_data_parallel(x, il),
                 lambda: ctc_nll_vocab_parallel(x, tgt, il, tl),
                 lambda: greedy_decode_vocab_parallel(x, il),
                 lambda: ctc_nll_time_parallel(x, tgt, il, tl)):
        with pytest.raises(RuntimeError, match="init_process_group"):
            call()


def test_dry_run_at_4_ranks(tmp_path, capsys):
    out = dryrun_multichip(D, device="cpu", tmpdir=tmp_path)
    assert out["line"].startswith(f"dryrun_multichip ok: ranks={D} "
                                  "device=cpu")
    assert out["line"] in capsys.readouterr().out
    assert all(r["jax_free"] and r["device"] == "cpu" for r in out["ranks"])
    (f1, f2), (k1, k2) = out["ranks"][0]["fused"]
    assert f2 < f1 and k2 < k1 and abs(k1 - f1) < 5e-2

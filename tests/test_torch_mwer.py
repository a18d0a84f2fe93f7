"""MWER fine-tuning in the torch port (CPU) against the JAX package's
`ops/mwer.py`: word hashes, edit distances, the loss and its gradient from
an N-best list, the self-decoding `mwer_loss`, and the tiny pipeline's
`loss + 0.5 * mwer` composite.

Tolerances: hashes, counts and edit distances equal; the loss and its
gradient with respect to the log-probs within 1e-5 (the same CTC
recurrences in float32, libm against XLA's exp and log1p); the composite
within 1e-4 relative and every encoder gradient within 1e-4 of its
tensor's max (tests/test_torch_train.py's rule), but the attention key
biases', zero in exact arithmetic, which must be rounding noise on both
sides: at most 1e-6 of the largest gradient (the MWER term's extra sums
make that noise ~4e-8 against 1e-8 in the CTC loss alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from end2end_tpu.ops import mwer as jmwer
from end2end_tpu.ops.beam_search import beam_search_decode as jax_beam
from end2end_tpu.utils import metrics as jmetrics
from end2end_tpu_torch import (ConformerCTCPipeline, PipelineConfig,
                               beam_search_decode, mwer_loss,
                               mwer_loss_from_nbest)
from end2end_tpu_torch.ops import mwer as tmwer
from end2end_tpu_torch.utils import metrics as tmetrics
from end2end_tpu_torch.utils.convert import conformer_state_dict_from_flax

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

LOSS_TOL = 1e-5
SLICE_RTOL = 1e-4
SLICE_GRAD_RTOL = 1e-4
KEY_BIAS_NOISE = 1e-6  # of the largest gradient, where exact is 0


def _lattice(rng, t, b, v, scale=2.0):
    x = rng.standard_normal((t, b, v)) * scale
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def test_word_id_hashes_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    space = 3
    tok = rng.integers(0, 12, (6, 4, 19)).astype(np.int32)
    tok[0, 0, :6] = [3, 3, 5, 3, 3, 7]  # leading and double separators
    tok[0, 1, :] = 3  # separators only
    tok[1, 0, :4] = [0, 0, 3, 0]  # id 0 is a token (+1 in the hash)
    lens = rng.integers(0, 20, (6, 4)).astype(np.int32)
    lens[0, :2] = 19
    want = [np.asarray(x) for x in jmwer.word_id_hashes(tok, lens, space)]
    got = [x.numpy() for x in tmwer.word_id_hashes(torch.from_numpy(tok),
                                                   lens, space)]
    assert got[0].dtype == got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] < 0).any()  # hashes with the high bit set
    assert got[1][0, 1] == 0
    small = tmwer.word_id_hashes(torch.from_numpy(tok[0]), lens[0], space,
                                 w_cap=3)
    np.testing.assert_array_equal(small[0].numpy(), np.asarray(
        jmwer.word_id_hashes(tok[0], lens[0], space, w_cap=3)[0]))


def test_batch_edit_distance_matches_jax_and_the_host_dp():
    rng = np.random.default_rng(1)
    n, la, lb = 40, 9, 7
    a = rng.integers(0, 4, (n, la)).astype(np.int32)
    b = rng.integers(0, 4, (n, lb)).astype(np.int32)
    a_len = rng.integers(0, la + 1, n).astype(np.int32)
    b_len = rng.integers(0, lb + 1, n).astype(np.int32)
    a_len[:3] = 0
    b_len[2:5] = 0
    got = tmetrics.batch_edit_distance(torch.from_numpy(a), a_len, b, b_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jmetrics.batch_edit_distance(a, a_len, b, b_len)))
    host = [tmetrics.edit_distance(a[i, : a_len[i]], b[i, : b_len[i]])
            for i in range(n)]
    assert got.tolist() == host
    empty = tmetrics.batch_edit_distance(a[:, :0], np.zeros(n), b, b_len)
    assert empty.tolist() == b_len.tolist()


def _nbest_problem(seed, err):
    """An N-best list over random lattices: variable lengths, an
    infeasible hypothesis (more labels than frames), a row whose slots
    are all dead, and with err='word' separators (id 3) in every kind of
    place."""
    rng = np.random.default_rng(seed)
    t, n, w, v, s = 14, 4, 3, 7, 9
    lp = _lattice(rng, t, n, v)
    il = np.array([14, 11, 6, 14], np.int32)
    hyp = rng.integers(1, v, (n, w, s)).astype(np.int32)
    hyp_len = rng.integers(0, 7, (n, w)).astype(np.int32)
    hyp_len[2, 0] = 8  # 8 labels in 6 frames: infeasible
    ref = rng.integers(1, v, (n, 8)).astype(np.int32)
    ref_len = np.array([8, 5, 3, 0], np.int32)
    if err == "word":
        hyp[0, 0, :5] = [3, 1, 3, 3, 2]
        ref[1, :3] = [2, 3, 4]
    hyp = np.where(np.arange(s) < hyp_len[..., None], hyp, -1).astype(
        np.int32)
    valid = np.ones((n, w), bool)
    valid[1, 2] = False
    valid[3] = False  # an all-dead row
    return lp, il, hyp, hyp_len, ref, ref_len, valid


@pytest.mark.parametrize("err", ["token", "word"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_mwer_from_nbest_value_and_gradient_match_jax(err, reduction, scale):
    lp, il, hyp, hyp_len, ref, ref_len, valid = _nbest_problem(
        {"token": 0, "word": 1}[err], err)
    kw = dict(err=err, space_id=3 if err == "word" else None, scale=scale,
              reduction=reduction)

    def jloss(x):
        out = jmwer.mwer_loss_from_nbest(x, il, hyp, hyp_len, ref, ref_len,
                                         hyp_valid=valid, **kw)
        return jnp.sum(out), out

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    loss, aux = mwer_loss_from_nbest(x, il, hyp, hyp_len, ref, ref_len,
                                     hyp_valid=valid, return_aux=True, **kw)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=LOSS_TOL, rtol=0)
    _, jaux = jmwer.mwer_loss_from_nbest(lp, il, hyp, hyp_len, ref, ref_len,
                                         hyp_valid=valid, return_aux=True,
                                         **kw)
    np.testing.assert_array_equal(aux["errors"].numpy(),
                                  np.asarray(jaux["errors"]))
    np.testing.assert_array_equal(aux["valid"].numpy(),
                                  np.asarray(jaux["valid"]))
    np.testing.assert_allclose(aux["posterior"].detach().numpy(),
                               np.asarray(jaux["posterior"]), atol=LOSS_TOL)
    np.testing.assert_allclose(aux["expected_error"].detach().numpy(),
                               np.asarray(jaux["expected_error"]),
                               atol=LOSS_TOL)
    assert not bool(aux["valid"][2, 0])  # the infeasible hypothesis
    assert aux["posterior"][3].abs().sum() == 0  # the all-dead row


def test_mwer_rejects_bad_arguments():
    lp, il, hyp, hyp_len, ref, ref_len, _ = _nbest_problem(0, "token")
    x = torch.from_numpy(lp)
    with pytest.raises(ValueError, match="reduction"):
        mwer_loss_from_nbest(x, il, hyp, hyp_len, ref, ref_len,
                             reduction="max")
    with pytest.raises(ValueError, match="space_id"):
        mwer_loss_from_nbest(x, il, hyp, hyp_len, ref, ref_len, err="word")
    with pytest.raises(ValueError, match="err"):
        mwer_loss_from_nbest(x, il, hyp, hyp_len, ref, ref_len, err="char")


@pytest.mark.parametrize("err", ["token", "word"])
def test_mwer_loss_end_to_end_matches_jax(err):
    """The self-decoding loss at prune_k = V, where the port's beam kernel
    semantics and JAX's scan (its 'auto' off the TPU) agree."""
    rng = np.random.default_rng(5)
    t, n, v = 20, 3, 6
    lp = _lattice(rng, t, n, v, scale=3.0)
    il = np.array([20, 15, 9], np.int32)
    tgt = rng.integers(1, v, (n, 6)).astype(np.int32)
    tl = np.array([6, 4, 2], np.int32)
    kw = dict(beam_width=4, prune_k=v, err=err,
              space_id=2 if err == "word" else None)
    want, want_grad = jax.value_and_grad(
        lambda x: jmwer.mwer_loss(x, tgt, il, tl, **kw))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    loss = mwer_loss(x, tgt, il, tl, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=LOSS_TOL, rtol=0)
    # batch-first logits through from_logits give the same loss
    logits = torch.from_numpy(3.0 * lp.transpose(1, 0, 2).copy())
    alt = mwer_loss(torch.log_softmax(logits, -1), tgt, il, tl,
                    batch_first=True, **kw)
    np.testing.assert_allclose(alt.item(), mwer_loss(
        logits, tgt, il, tl, batch_first=True, from_logits=True,
        **kw).item(), rtol=1e-6)


@pytest.fixture(scope="module")
def composite():
    """The tiny pipeline's `loss + 0.5 * mwer` in JAX (value and gradient
    through jax.value_and_grad) on the N-best that JAX decodes."""
    jpipe = graft._tiny_pipeline()
    rng = np.random.default_rng(9)
    wav = rng.standard_normal((3, 4000)).astype(np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)
    tgt = rng.integers(1, 16, (3, 3)).astype(np.int32)
    tl = np.array([3, 2, 1], np.int32)
    params = jax.device_get(jpipe.init(jax.random.key(0), wav, ns))
    logits, out_len = jpipe.encode(params, wav, ns)
    lp = jnp.moveaxis(jax.nn.log_softmax(logits, -1), 0, 1)
    tok, lens, sc = (np.array(a) for a in jax_beam(
        lp, out_len, beam_width=4, prune_k=16))
    nbest = (tok, lens, np.isfinite(sc))

    def objective(p):
        lg, ol = jpipe.encode(p, wav, ns)
        x = jnp.moveaxis(jax.nn.log_softmax(lg, -1), 0, 1)
        return jpipe.loss(p, wav, ns, tgt, tl, implementation="xla") + (
            0.5 * jmwer.mwer_loss_from_nbest(
                x, ol, nbest[0], nbest[1], tgt, tl, hyp_valid=nbest[2]))

    value, grads = jax.jit(jax.value_and_grad(objective))(params)
    return dict(params=params, batch=(wav, ns, tgt, tl), nbest=nbest,
                value=float(value), grads=jax.device_get(grads))


def test_pipeline_mwer_composite_matches_jax(composite):
    tpipe = ConformerCTCPipeline(PipelineConfig(
        vocab_size=16, d_model=64, num_layers=2, num_heads=2, n_mels=16),
        device="cpu")
    tpipe.load_flax_params(composite["params"])
    wav, ns, tgt, tl = composite["batch"]
    tok, lens, ok = composite["nbest"]
    logits, out_len = tpipe.encode(wav, ns)
    lp = torch.log_softmax(logits, -1).transpose(0, 1)
    loss = tpipe.loss(wav, ns, tgt, tl) + 0.5 * mwer_loss_from_nbest(
        lp, out_len, tok, lens, tgt, tl, hyp_valid=ok)
    loss.backward()
    np.testing.assert_allclose(loss.item(), composite["value"],
                               rtol=SLICE_RTOL)
    want = conformer_state_dict_from_flax(composite["grads"])
    grads = {k.removeprefix("encoder."): p.grad
             for k, p in tpipe.named_parameters()}
    assert set(want) == set(grads)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name.endswith("mhsa.key.bias"):
            # zero in exact arithmetic (softmax ignores a shift of all
            # keys): both sides must be rounding noise of the gradient
            noise = max(float(w.abs().max()), float(grads[name].abs().max()))
            assert noise <= KEY_BIAS_NOISE * top, (name, noise, top)
            continue
        scale = float(w.abs().max())
        err = float((grads[name] - w).abs().max())
        assert err <= SLICE_GRAD_RTOL * scale, (name, err, scale)
    # the same N-best through the port's own decoder (prune_k >= V)
    t_tok, t_len, t_sc = beam_search_decode(lp.detach(), out_len,
                                            beam_width=4, prune_k=16)
    assert torch.equal(t_len, torch.from_numpy(lens))
    for n in range(3):
        for w in range(4):
            k = int(lens[n, w])
            assert t_tok[n, w, :k].tolist() == tok[n, w, :k].tolist()

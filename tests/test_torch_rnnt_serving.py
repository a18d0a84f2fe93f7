"""Transducer serving extras: `rnnt_token_confidence` (greedy and beam
shapes), `rnnt_greedy_decode_with_confidence` and `rnnt_mwer_loss`, the
port's against the JAX package's on the same seeded inputs (CPU).

Tolerances: confidences 1e-5 (the same softmaxes in float32; JAX's
log-softmax is its accurate float32 one, the port's torch's); tokens,
lengths and times equal.  `rnnt_mwer_loss`: the value and the gradients
with respect to the encoder output and every predictor and joint
parameter within 1e-4 of `jax.grad`'s (float32 lattices of ~8 x 5 cells
scored by the plain DP in both).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import confidence as jconf
from end2end_tpu.ops.mwer import rnnt_mwer_loss as jax_rnnt_mwer_loss
from end2end_tpu.ops.neural_lm import gru_step as jax_gru_step
from end2end_tpu.ops.rnnt_decode import additive_joint as jax_joint
from end2end_tpu.ops.rnnt_decode import rnnt_beam_decode as jax_beam
from end2end_tpu_torch import (rnnt_beam_decode, rnnt_greedy_decode,
                               rnnt_greedy_decode_with_confidence,
                               rnnt_mwer_loss, rnnt_token_confidence)
from end2end_tpu_torch.ops import mwer as tmwer
from end2end_tpu_torch.ops.neural_lm import gru_step, random_gru_params
from end2end_tpu_torch.ops.rnnt_decode import additive_joint
from tests.test_torch_rnnt_beam import assert_decodes_equal, problem

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("method,exclude_blank", [
    ("tsallis", True), ("max_prob", False), ("shannon", True),
    ("renyi", False)])
def test_token_confidence_on_greedy_decodes(method, exclude_blank):
    enc, jf, tf = problem(3, n=3, t=12, v=7, scale=1.2, factored=True)
    il = np.array([12, 9, 0], np.int32)
    toks, lens, _, times = rnnt_greedy_decode(
        torch.from_numpy(enc), il, *tf, max_symbols=6,
        return_timestamps=True)
    kw = dict(method=method, exclude_blank=exclude_blank,
              aggregation="min" if exclude_blank else "mean")
    got = rnnt_token_confidence(torch.from_numpy(enc), toks, lens,
                                times.clamp(min=0), *tf, **kw)
    want = jconf.rnnt_token_confidence(
        enc, toks.numpy(), lens.numpy(), times.clamp(min=0).numpy(), *jf,
        **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert got[0].shape == toks.shape and float(got[1][2]) == 1.0
    assert (got[0][lens[:, None] <= torch.arange(6)] == 0).all()


def test_token_confidence_on_beam_decodes():
    enc, jf, tf = problem(9, n=2, t=10, v=6, scale=1.3)
    il = np.array([10, 8], np.int32)
    toks, lens, _, times = rnnt_beam_decode(
        torch.from_numpy(enc), il, *tf, beam_width=3, max_symbols=5,
        return_timestamps=True)
    got = rnnt_token_confidence(torch.from_numpy(enc), toks, lens,
                                times.clamp(min=0), *tf)
    want = jconf.rnnt_token_confidence(
        enc, toks.numpy(), lens.numpy(), times.clamp(min=0).numpy(), *jf)
    assert got[0].shape == (2, 3, 5) and got[1].shape == (2, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_greedy_decode_with_confidence_matches_jax():
    enc, jf, tf = problem(4, n=3, t=14, v=7, blank_bias=1.0, factored=True)
    il = np.array([14, 10, 3], np.int32)
    got = rnnt_greedy_decode_with_confidence(
        torch.from_numpy(enc), il, *tf, max_symbols=7)
    want = jconf.rnnt_greedy_decode_with_confidence(enc, il, *jf,
                                                    max_symbols=7)
    assert_decodes_equal(got[:4], want[:4])
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# --------------------------------------------------------------------------
# rnnt_mwer_loss
# --------------------------------------------------------------------------

N, T, V, H_ENC, HID = 2, 8, 5, 8, 5
JOINT_NAMES = ("w_enc", "w_pred", "b_joint", "w_out", "b_out")


def _mwer_problem(seed=31):
    rng = np.random.default_rng(seed)
    enc = (rng.normal(size=(N, T, H_ENC)) * 1.2).astype(np.float32)
    gru = random_gru_params(rng, V, emb_dim=4, hidden_dim=HID)
    ws = [rng.normal(size=s).astype(np.float32) * 0.5 for s in
          ((H_ENC, 7), (HID, 7), (7,), (7, V), (V,))]
    ref = rng.integers(1, V, size=(N, 4)).astype(np.int32)
    rl = np.array([4, 2], np.int32)
    return enc, gru, ws, ref, rl


KW = dict(beam_width=3, max_symbols=4, reduction="mean", scale=1.0)


@pytest.fixture(scope="module")
def mwer():
    """The loss and its gradients in both packages: (JAX's value and
    grads, the port's loss and its leaf tensors after backward)."""
    enc, gru, ws, ref, rl = _mwer_problem()
    il = np.full((N,), T, np.int32)

    def jloss(e, gp, w):
        return jax_rnnt_mwer_loss(e, il, ref, rl, partial(jax_gru_step, gp),
                                  jnp.zeros(HID), jax_joint(*w), **KW)

    with jax.default_matmul_precision("highest"):
        jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(enc), {k: jnp.asarray(a) for k, a in gru.items()},
            [jnp.asarray(w) for w in ws])
    te = torch.tensor(enc, requires_grad=True)
    tg = {k: torch.tensor(a, requires_grad=True) for k, a in gru.items()}
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    loss, aux = rnnt_mwer_loss(te, il, ref, rl, partial(gru_step, tg),
                               torch.zeros(HID), additive_joint(*tw),
                               return_aux=True, **KW)
    loss.backward()
    return jval, jgrads, loss, aux, te, tg, tw


def test_mwer_value_matches_jax(mwer):
    jval, _, loss, aux, *_ = mwer
    np.testing.assert_allclose(loss.item(), float(jval), atol=1e-4)
    errors = aux["errors"][aux["valid"]]
    assert loss.item() != 0.0 and float(errors.max() - errors.min()) > 0


@pytest.mark.parametrize("part", ["encoder_out", "predictor", "joint"])
def test_mwer_gradients_match_jax(mwer, part):
    _, jgrads, _, _, te, tg, tw = mwer
    if part == "encoder_out":
        pairs = [("enc", te.grad, jgrads[0])]
    elif part == "predictor":
        pairs = [(k, tg[k].grad, jgrads[1][k]) for k in tg]
    else:
        pairs = [(k, w.grad, jgrads[2][i])
                 for i, (k, w) in enumerate(zip(JOINT_NAMES, tw))]
    nonzero = 0
    for name, g, w in pairs:
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)
        nonzero += bool(np.abs(w).max() > 1e-3)
    assert nonzero


def test_mwer_equal_errors_give_zero_loss_and_gradient():
    """One hypothesis a sample (W=1): its regret against its own mean is 0,
    so are the loss and the gradient."""
    enc, gru, ws, ref, rl = _mwer_problem(7)
    te = torch.tensor(enc, requires_grad=True)
    tw = [torch.tensor(w, requires_grad=True) for w in ws]
    loss = rnnt_mwer_loss(
        te, np.full((N,), T, np.int32), ref, rl,
        partial(gru_step, {k: torch.from_numpy(a) for k, a in gru.items()}),
        torch.zeros(HID), additive_joint(*tw), beam_width=1, max_symbols=3,
        reduction="sum")
    loss.backward()
    assert loss.item() == 0.0
    assert float(te.grad.abs().max()) == 0.0
    assert all(float(w.grad.abs().max()) == 0.0 for w in tw)


def test_mwer_scores_the_decoded_nbest():
    """aux['scores'] are the ALSD N-best's exact sequence log-probs: at
    least each hypothesis's beam score (the beam keeps a subset of its
    alignments) and equal to JAX's decode's at the full width."""
    enc, gru, ws, ref, rl = _mwer_problem()
    il = np.full((N,), T, np.int32)
    pred = partial(gru_step, {k: torch.from_numpy(a) for k, a in gru.items()})
    joint = additive_joint(*map(torch.from_numpy, ws))
    _, aux = rnnt_mwer_loss(torch.from_numpy(enc), il, ref, rl, pred,
                            torch.zeros(HID), joint, return_aux=True, **KW)
    toks, lens, dec = rnnt_beam_decode(torch.from_numpy(enc), il, pred,
                                       torch.zeros(HID), joint,
                                       beam_width=3, max_symbols=4)
    jtoks = jax_beam(enc, il, partial(jax_gru_step, {
        k: jnp.asarray(a) for k, a in gru.items()}), jnp.zeros(HID),
        jax_joint(*map(jnp.asarray, ws)), beam_width=3, max_symbols=4)[0]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    valid = aux["valid"]
    assert (aux["scores"][valid] >= dec[valid] - 1e-4).all()


def test_mwer_from_nbest_in_float64_agrees_with_the_loss():
    """`rnnt_mwer_loss` after its decode, run in float64 on the decode's
    N-best (chip_smoke's witness of the card's float32 gradients), agrees
    with the float32 loss and its gradients to 1e-4."""
    enc, gru, ws, ref, rl = _mwer_problem()
    il = torch.full((N,), T)
    toks, lens, dec = rnnt_beam_decode(
        enc, il, partial(gru_step, {k: torch.from_numpy(a)
                                    for k, a in gru.items()}),
        torch.zeros(HID), additive_joint(*map(torch.from_numpy, ws)),
        beam_width=3, max_symbols=4)
    grads = {}
    for dt in (torch.float32, torch.float64):
        te = torch.tensor(enc, dtype=dt, requires_grad=True)
        tw = [torch.tensor(w, dtype=dt, requires_grad=True) for w in ws]
        pred = partial(gru_step, {k: torch.tensor(a, dtype=dt)
                                  for k, a in gru.items()})
        joint = additive_joint(*tw)
        h0 = torch.zeros(HID, dtype=dt)
        if dt == torch.float32:
            loss = rnnt_mwer_loss(te, il, ref, rl, pred, h0, joint, **KW)
        else:
            loss = tmwer._rnnt_mwer_from_nbest(
                te, il, toks, lens, torch.isfinite(dec) & (dec > -1e29),
                ref, rl, pred, h0, joint, 0, "token", None, 1.0, "mean",
                "auto", False)
            assert loss.dtype == torch.float64
        loss.backward()
        grads[dt] = [loss.detach(), te.grad, *(w.grad for w in tw)]
    for g32, g64 in zip(grads[torch.float32], grads[torch.float64]):
        np.testing.assert_allclose(g32.numpy(), g64.numpy(), atol=1e-4)

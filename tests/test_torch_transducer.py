"""The transducer slice as a whole: the JAX `ConformerTransducer` and the
torch port's, with the JAX model's `init` parameters carried over by
`transducer_state_dict_from_jax`, on the same seeded features and targets
(CPU, the tiny config of tests/test_transducer_model.py).

Tolerances: encoder outputs 1e-5 and predictor states 1e-6 (float32 GEMM
sums in other orders); the loss rtol 1e-5; each parameter's gradient
within 1e-4 of that tensor's largest gradient, as in
tests/test_torch_train.py, that scale floored at 1e-3: the attention key
bias's gradient is zero in exact arithmetic, and the two frameworks return
rounding noise of up to ~3e-8 there (the transducer loss is ~10x the CTC
test's); greedy tokens and lengths equal, scores within
1e-5 (the per-step logsumexp and the capped tail's frame sum in another
order); ALSD beams' tokens, lengths and times equal, scores rtol 1e-5,
atol 1e-4 (tests/test_torch_rnnt_beam.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.models.transducer import ConformerTransducer as JaxModel
from end2end_tpu.models.transducer import TransducerConfig as JaxConfig
from end2end_tpu.ops.neural_lm import random_gru_params as jax_gru_params
from end2end_tpu_torch import ConformerTransducer, TransducerConfig
from end2end_tpu_torch.ops.neural_lm import random_gru_params
from end2end_tpu_torch.ops.rnnt_decode import (FactoredAdditiveJoint,
                                               additive_joint,
                                               rnnt_greedy_decode)
from end2end_tpu_torch.utils.convert import transducer_state_dict_from_jax

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

KW = dict(vocab_size=8, n_mels=12, d_model=16, num_layers=1, num_heads=2,
          conv_kernel=7, enc_dim=16, emb_dim=6, pred_hidden=10, joint_dim=12)
TGT = np.array([[1, 2, 3, 2], [4, 5, 0, 0]], np.int32)
TL = np.array([4, 2], np.int32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jmodel = JaxModel(JaxConfig(**KW))
    feats = rng.standard_normal((2, 37, KW["n_mels"])).astype(np.float32)
    lens = np.array([37, 29], np.int32)
    params = jmodel.init(jax.random.key(0), feats, lens)
    tmodel = ConformerTransducer(TransducerConfig(**KW), device="cpu")
    tmodel.load_jax_params(jax.device_get(params))
    return jmodel, tmodel, params, feats, lens


def test_encoder_and_predictor_match_jax(setup):
    jmodel, tmodel, params, feats, lens = setup
    j_enc, j_len = jmodel.encode(params, feats, lens)
    t_enc, t_len = tmodel.encode(feats, lens)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(t_enc.detach().numpy(), np.asarray(j_enc),
                               atol=1e-5, rtol=0)
    j_hs = jmodel._pred_states(params["pred"], TGT)
    t_hs = tmodel._pred_states(TGT)
    assert t_hs.shape == (2, 5, KW["pred_hidden"])
    np.testing.assert_allclose(t_hs.detach().numpy(), np.asarray(j_hs),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_loss_matches_jax(setup, reduction):
    jmodel, tmodel, params, feats, lens = setup
    want = jax.jit(lambda p: jmodel.loss(p, feats, lens, TGT, TL,
                                         reduction=reduction))(params)
    got = tmodel.loss(feats, lens, TGT, TL, reduction=reduction)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)


def test_gradients_match_jax(setup):
    jmodel, tmodel, params, feats, lens = setup
    j_grads = jax.device_get(jax.jit(jax.grad(
        lambda p: jmodel.loss(p, feats, lens, TGT, TL)))(params))
    want = transducer_state_dict_from_jax(j_grads)
    tmodel.zero_grad()
    tmodel.loss(feats, lens, TGT, TL).backward()
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        # the GRU's output head (wo, bo) is not on the loss's path: JAX
        # returns zeros there, torch no gradient
        g = got[name].grad
        g = torch.zeros_like(w) if g is None else g
        scale = max(float(w.abs().max()), 1e-3)
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _decodes(setup, max_symbols, params):
    jmodel, _, _, feats, lens = setup
    tmodel = ConformerTransducer(TransducerConfig(**KW), device="cpu")
    tmodel.load_jax_params(jax.device_get(params))
    want = jmodel.decode(params, feats, lens, max_symbols=max_symbols,
                         return_timestamps=True)
    got = tmodel.decode(feats, lens, max_symbols=max_symbols,
                        return_timestamps=True)
    return [np.asarray(x) for x in want], [x.numpy() for x in got], tmodel


def _assert_same(want, got):
    for i in (0, 1, 3):  # tokens, lengths, times
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)


@pytest.mark.parametrize("cap,blank_shift", [(None, 2.2), (2, -3.0)])
def test_greedy_decode_matches_jax(setup, cap, blank_shift):
    """The blank logit shifted by `blank_shift`: up, no sample reaches the
    default cap; down with cap=2, every sample hits it, so the scores
    include the batched all-blank tail."""
    params = setup[2]
    joint = dict(params["joint"])
    joint["b_out"] = joint["b_out"] + blank_shift * (jnp.arange(8) == 0)
    want, got, tmodel = _decodes(setup, cap, dict(params, joint=joint))
    _assert_same(want, got)
    width = got[0].shape[1]
    assert (got[1] == width).all() if cap else (got[1] < width).all()
    assert got[1].min() > 0
    # padding invariance: more padded frames change nothing
    feats, lens = setup[3], setup[4]
    pad = np.concatenate([feats, np.zeros((2, 11, KW["n_mels"]),
                                          np.float32)], 1)
    again = [x.numpy() for x in tmodel.decode(pad, lens, max_symbols=width,
                                              return_timestamps=True)]
    _assert_same(got, again)


def test_additive_joint_decodes_as_the_factored_one(setup):
    """The plain protocol joint (frames projected at every step) and the
    model's factored one decode alike."""
    tmodel, feats, lens = setup[1], setup[3], setup[4]
    with torch.no_grad():
        enc, enc_len = tmodel.encode(feats, lens)
        pred, h0, joint = tmodel.decoder_fns()
        plain = additive_joint(joint.w_enc, joint.w_pred, joint.b_joint,
                               joint.w_out, joint.b_out)
        want = rnnt_greedy_decode(enc, enc_len, pred, h0, joint)
        got = rnnt_greedy_decode(enc, enc_len, pred, h0, plain)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=0)


def test_factored_joint_holds_float32_weights_as_jax():
    """Float64 weights (numpy and torch) are held as float32, as JAX's
    class holds them: the frame projection, the per-step half and the
    whole joint on float32 frames agree with JAX's within float32 sums."""
    from end2end_tpu.ops.rnnt_decode import FactoredAdditiveJoint as JaxJoint

    rng = np.random.default_rng(5)
    E, H, J, V = 6, 5, 7, 9
    ws = [rng.standard_normal(s) for s in ((E, J), (H, J), (J,), (J, V),
                                           (V,))]
    f = rng.standard_normal((3, 4, E)).astype(np.float32)
    h = rng.standard_normal((3, 4, H)).astype(np.float32)
    jj = JaxJoint(*ws)
    want = (jj.precompute_frames(f),)
    want += (jj.from_projected(want[0], h), jj(f, h))
    ft, ht = torch.from_numpy(f), torch.from_numpy(h)
    for given in (ws, [torch.from_numpy(w) for w in ws]):
        tj = FactoredAdditiveJoint(*given)
        assert all(w.dtype == torch.float32 for w in (
            tj.w_enc, tj.w_pred, tj.b_joint, tj.w_out, tj.b_out))
        got = (tj.precompute_frames(ft),)
        got += (tj.from_projected(got[0], ht), tj(ft, ht))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)


def test_random_gru_params_match_jax():
    want = jax_gru_params(np.random.default_rng(5), 11, emb_dim=4,
                          hidden_dim=6)
    got = random_gru_params(np.random.default_rng(5), 11, emb_dim=4,
                            hidden_dim=6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_predictor_and_joint_weights_from_the_seed(setup):
    """The same seed gives the JAX init's predictor and joint weights."""
    params = setup[2]
    model = ConformerTransducer(TransducerConfig(**KW), device="cpu", seed=0)
    sd = model.state_dict()
    for part in ("pred", "joint"):
        for k, v in params[part].items():
            np.testing.assert_array_equal(sd[f"{part}.{k}"].numpy(),
                                          np.asarray(v))


def _model_lm(lm_kind):
    """A dense bigram over the model's 8 symbols in both packages."""
    if lm_kind is None:
        return None, None
    from end2end_tpu.ops.lm import NGramLM as JaxNGramLM
    from end2end_tpu_torch.ops.lm import NGramLM

    x = np.random.default_rng(3).standard_normal((8, 8))
    tbl = (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)
    return JaxNGramLM(jnp.asarray(tbl)), NGramLM(tbl, device="cpu")


@pytest.mark.parametrize("lm_kind,lookahead", [(None, 1), (None, 4),
                                               ("bigram", 4)])
def test_beam_decode_matches_jax(setup, lm_kind, lookahead):
    """ALSD through the model; with an LM the lookahead is dropped, as
    JAX drops it."""
    jmodel, tmodel, params, feats, lens = setup
    jl, tl = _model_lm(lm_kind)
    kw = dict(beam_width=4, prune_k=5, max_symbols=6, return_timestamps=True,
              lm_alpha=0.5, lm_beta=0.2, lookahead=lookahead)
    want = jmodel.decode(params, feats, lens, lm=jl, **kw)
    got = tmodel.decode(feats, lens, lm=tl, **kw)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-4)


def test_decode_takes_jax_positional_order(setup):
    """decode(feats, lengths, beam_width, prune_k, max_symbols): the
    fourth argument is prune_k, as in JAX's decode less `params`."""
    jmodel, tmodel, params, feats, lens = setup
    got = tmodel.decode(feats, lens, 3, 1, 5)
    want = jmodel.decode(params, feats, lens, 3, 1, 5)
    assert got[0].shape == (2, 3, 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    greedy = tmodel.decode(feats, lens, 0, None, 5, True, None, 0.0, 0.0, 2)
    assert len(greedy) == 4 and greedy[0].shape == (2, 5)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConformerTransducer(TransducerConfig(**KW))
    assert ConformerTransducer(TransducerConfig(**KW),
                               device="cpu").device.type == "cpu"

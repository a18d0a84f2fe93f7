"""The Dense front end (`subsample=False`: one Linear from the features to
d_model, T' = T) of the torch port against the JAX package's: the
Conformer encoder and the `ConformerTransducer` built with it, the JAX
model's `init` parameters carried over by the converters, on the same
seeded features and targets (CPU, tests/test_torch_transducer.py's tiny
configuration with subsample=False).

Tolerances, tests/test_torch_transducer.py's: encoder outputs 1e-5
absolute (float32 GEMM sums in other orders), out lengths equal; the loss
rtol 1e-5; the long form (`transcribe_long_form_rnnt`) tokens and length
equal, its score rtol 1e-5, atol 5e-4 (tests/test_torch_streaming.py's);
each parameter's gradient within 1e-4 of that tensor's largest
gradient, that scale floored at 1e-3.  The converters are checked on both
flax trees (with and without `ConvSubsampling_0`): every port parameter
written once, in its shape.
"""

import jax
import numpy as np
import pytest
import torch

from end2end_tpu.models import streaming as jstream
from end2end_tpu.models.conformer import ConformerEncoder as JaxEncoder
from end2end_tpu.models.transducer import ConformerTransducer as JaxModel
from end2end_tpu.models.transducer import TransducerConfig as JaxConfig
from end2end_tpu_torch import ConformerTransducer, TransducerConfig
from end2end_tpu_torch.models import streaming as tstream
from end2end_tpu_torch.models.conformer import ConformerEncoder
from end2end_tpu_torch.utils.convert import (conformer_state_dict_from_flax,
                                             transducer_state_dict_from_jax)

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

KW = dict(vocab_size=8, n_mels=12, d_model=16, num_layers=1, num_heads=2,
          conv_kernel=7, enc_dim=16, emb_dim=6, pred_hidden=10, joint_dim=12,
          subsample=False)
TGT = np.array([[1, 2, 3, 2], [4, 5, 0, 0]], np.int32)
TL = np.array([4, 2], np.int32)
ENC = dict(vocab_size=9, d_model=16, num_layers=2, num_heads=2)


@pytest.mark.parametrize("subsample", [True, False])
def test_converter_reads_either_tree(rng, subsample):
    feats = rng.standard_normal((2, 13, 12)).astype(np.float32)
    lens = np.array([13, 9], np.int32)
    jenc = JaxEncoder(**ENC, subsample=subsample)
    params = jax.device_get(jenc.init(jax.random.key(1), feats, lens))
    assert ("ConvSubsampling_0" in params["params"]) == subsample
    sd = conformer_state_dict_from_flax(params)
    enc = ConformerEncoder(**ENC, n_mels=12, subsample=subsample,
                           device="cpu")
    want = enc.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
    enc.load_state_dict(sd)
    got, got_len = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    ref, ref_len = jenc.apply(params, feats, lens)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    if not subsample:
        assert got.shape[1] == feats.shape[1]
        np.testing.assert_array_equal(got_len.numpy(), lens)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jmodel = JaxModel(JaxConfig(**KW))
    feats = rng.standard_normal((2, 23, KW["n_mels"])).astype(np.float32)
    lens = np.array([23, 17], np.int32)
    params = jmodel.init(jax.random.key(0), feats, lens)
    tmodel = ConformerTransducer(TransducerConfig(**KW), device="cpu")
    tmodel.load_jax_params(jax.device_get(params))
    return jmodel, tmodel, params, feats, lens


def test_encode_matches_jax(setup):
    jmodel, tmodel, params, feats, lens = setup
    j_enc, j_len = jmodel.encode(params, feats, lens)
    t_enc, t_len = tmodel.encode(feats, lens)
    assert t_enc.shape == (2, 23, KW["enc_dim"])
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(t_enc.detach().numpy(), np.asarray(j_enc),
                               atol=1e-5, rtol=0)


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
    assert "encoder.input_proj.weight" in got
    for name, w in want.items():
        g = got[name].grad  # the GRU's output head is off the loss's path
        g = torch.zeros_like(w) if g is None else g
        scale = max(float(w.abs().max()), 1e-3)
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_trains_and_decodes(setup):
    """A few SGD steps lower the loss; the greedy decode runs on T' = T
    frames."""
    _, _, params, feats, lens = setup
    model = ConformerTransducer(TransducerConfig(**KW), device="cpu")
    model.load_jax_params(jax.device_get(params))
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = model.loss(feats, lens, TGT, TL)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    tokens, lengths, scores = model.decode(feats, lens, max_symbols=30)
    assert tokens.shape == (2, 30)
    assert torch.isfinite(scores).all()


@pytest.mark.parametrize("beam", [0, 3])
def test_long_form_rnnt_matches_jax(setup, beam):
    """Without subsampling a seam trims the overlap's own frames, half on
    each side, so the chunks' trimmed encoder outputs tile the input."""
    jmodel, tmodel, params, _, _ = setup
    feats = np.random.default_rng(1).standard_normal(
        (130, KW["n_mels"])).astype(np.float32)
    kw = dict(chunk_frames=48, overlap_frames=8, beam_width=beam,
              max_symbols=20)
    pieces = list(tstream._rnnt_encoded_chunks(tmodel, feats, 48, 8))
    assert [p.shape[1] for p in pieces] == [44, 40, 40, 6]
    got = tstream.transcribe_long_form_rnnt(tmodel, feats, **kw)
    want = jstream.transcribe_long_form_rnnt(jmodel, params, feats, **kw)
    assert got[1] == want[1] and got[1] > 0
    assert got[0][: got[1]].tolist() == np.asarray(want[0])[: want[1]].tolist()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=5e-4)

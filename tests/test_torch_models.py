"""Frontend and Conformer encoder of the torch port against the JAX package.

The same numpy waveforms and the same weights (flax params converted by
utils/convert.py) go through both.  Log-mel and logits must agree within
1e-4 absolute (float32 FFT and matmul sums in different orders), output
lengths exactly.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from end2end_tpu.models import frontend as jfront
from end2end_tpu.models.conformer import ConformerEncoder as JaxEncoder
from end2end_tpu.models.conformer import ConvSubsampling as JaxSubsampling
from end2end_tpu_torch.models import frontend as tfront
from end2end_tpu_torch.models.conformer import ConformerEncoder, ConvSubsampling
from end2end_tpu_torch.utils.convert import conformer_state_dict_from_flax

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

TINY = dict(vocab_size=16, d_model=64, num_layers=2, num_heads=2, n_mels=16)


@pytest.mark.parametrize("samples,n_mels", [(4000, 16), (3217, 80),
                                            (300, 16)])
def test_log_mel_matches_jax(rng, samples, n_mels):
    wav = rng.standard_normal((2, samples)).astype(np.float32)
    want = np.asarray(jfront.log_mel_spectrogram(wav, n_mels=n_mels))
    got = tfront.log_mel_spectrogram(torch.from_numpy(wav), n_mels=n_mels)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        tfront.mel_filterbank(n_mels, 400, 16000, 0.0, 8000.0),
        jfront.mel_filterbank(n_mels, 400, 16000, 0.0, 8000.0))
    ns = np.array([0, 399, 400, 401, 560, samples])
    np.testing.assert_array_equal(tfront.num_frames(ns).numpy(),
                                  np.asarray(jfront.num_frames(ns)))


def _tiny_pair():
    """A JAX tiny pipeline with its params, and the port's encoder holding
    the same weights (the __graft_entry__ tiny config)."""
    pipe = graft._tiny_pipeline()
    wav = np.zeros((3, 4000), np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)
    params = jax.device_get(pipe.init(jax.random.key(0), wav, ns))
    enc = ConformerEncoder(**TINY, device="cpu")
    enc.load_state_dict(conformer_state_dict_from_flax(params))
    return pipe, params, enc


def test_encoder_converted_weights_match_flax(rng):
    pipe, params, enc = _tiny_pair()
    wav = rng.standard_normal((3, 4000)).astype(np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)
    feats = np.array(pipe.features(wav))
    lens = np.array(pipe.feature_lengths(ns))
    want, want_len = pipe.encoder.apply(params, feats, lens)
    got, got_len = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    # padded frames are finite too: masked attention rows are uniform,
    # never NaN
    assert torch.isfinite(got).all()


def test_encoder_padding_is_inert(rng):
    # T=18 is not a multiple of 4; the subsampler's explicit padding keeps
    # the stride-2 alignment whatever the padded length
    jenc = JaxEncoder(vocab_size=8, d_model=32, num_layers=1, num_heads=2)
    feats = rng.standard_normal((1, 18, 16)).astype(np.float32)
    lens = np.array([18], np.int32)
    params = jax.device_get(jenc.init(jax.random.key(0), feats, lens))
    enc = ConformerEncoder(vocab_size=8, d_model=32, num_layers=1,
                           num_heads=2, n_mels=16, device="cpu")
    enc.load_state_dict(conformer_state_dict_from_flax(params))
    ref, ref_len = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(
        ref.detach().numpy(), np.asarray(jenc.apply(params, feats, lens)[0]),
        atol=1e-4, rtol=0)
    for pad_to in (30, 48):
        fp = np.concatenate([feats, 100.0 * rng.standard_normal(
            (1, pad_to - 18, 16)).astype(np.float32)], axis=1)
        got, got_len = enc(torch.from_numpy(fp), torch.from_numpy(lens))
        assert int(got_len[0]) == int(ref_len[0]) == 5
        np.testing.assert_allclose(got[0, :5].detach().numpy(),
                                   ref[0, :5].detach().numpy(),
                                   rtol=2e-4, atol=1e-5)


def test_encoder_traps_pinned():
    enc = ConformerEncoder(**TINY, device="cpu")
    eps = {m.eps for m in enc.modules() if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {1e-6}  # flax's LayerNorm epsilon, not torch's 1e-5
    lens = np.arange(0, 40)
    np.testing.assert_array_equal(
        ConvSubsampling.out_length(torch.from_numpy(lens)).numpy(),
        np.asarray(JaxSubsampling.out_length(lens)))


def test_encoder_seeded_init_is_deterministic():
    a, b, c = (ConformerEncoder(**TINY, device="cpu",
                                generator=torch.Generator().manual_seed(s))
               for s in (3, 3, 4))
    for (name, x), y in zip(a.state_dict().items(),
                            b.state_dict().values()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.out.weight, c.out.weight)
    # LeCun-normal scale: weight std ~ 1/sqrt(fan_in)
    w = a.blocks[0].ff1.fc1.weight
    assert abs(float(w.detach().std()) * 64 ** 0.5 - 1.0) < 0.1

"""The OCR recognizer of the torch port against the JAX package's: the
flax `OCRRecognizer`'s `init` parameters carried over by
`ocr_state_dict_from_flax`, the same seeded text-line images (H=16, W=64
and 66, an odd width after the first pool), B=3, V=12, d_model 32, one
block, on the CPU.

Tolerances: column features and logits 1e-4 absolute, as
tests/test_torch_models.py holds the encoder (float32 convolution and
matmul sums in other orders); out widths equal; padded images against
unpadded 2e-4 relative + 1e-5 absolute on the valid columns (the
encoder test's), other padding content bit-equal (it is zeroed first);
the CTC loss of the model's output rtol 1e-5 and each parameter's
gradient within 1e-4 of that tensor's largest gradient
(floored at 1e-3), as tests/test_torch_transducer.py holds the
transducer's; beam-10 at prune_k = V against JAX's scan: the same beam
sets, scores within 5e-4 (tests/test_torch_beam.py's; at prune_k >= V the
kernel's semantics are the scan's, ROADMAP.md queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.models.ocr import CRNNFeatures as JaxFeatures
from end2end_tpu.models.ocr import OCRRecognizer as JaxOCR
from end2end_tpu.ops.beam_search import beam_search_decode as jax_beam
from end2end_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from end2end_tpu_torch import beam_search_decode, ctc_loss
from end2end_tpu_torch.models.ocr import CRNNFeatures, OCRRecognizer
from end2end_tpu_torch.utils.convert import ocr_state_dict_from_flax

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

KW = dict(vocab_size=12, d_model=32, num_layers=1, num_heads=2)
H = 16
WIDTHS = {64: [64, 45, 30], 66: [66, 51, 33]}
TGT = np.array([[3, 3, 7, 1], [2, 11, 5, 0], [9, 4, 0, 0]], np.int32)
TL = np.array([4, 3, 2], np.int32)


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def pair(request):
    w = request.param
    rng = np.random.default_rng(w)
    images = rng.standard_normal((3, H, w)).astype(np.float32)
    widths = np.array(WIDTHS[w], np.int32)
    jmodel = JaxOCR(**KW)
    params = jax.device_get(jmodel.init(jax.random.key(0), images, widths))
    tmodel = OCRRecognizer(**KW, device="cpu")
    tmodel.load_jax_params(params)
    return jmodel, tmodel, params, images, widths


def _masked(images, widths):
    cols = np.arange(images.shape[2])[None, None, :] < widths[:, None, None]
    return np.where(cols, images, 0.0).astype(np.float32)


def test_features_match_jax(pair):
    _, tmodel, params, images, widths = pair
    x = _masked(images, widths)
    want = JaxFeatures(KW["d_model"]).apply(
        {"params": params["params"]["CRNNFeatures_0"]}, x[..., None], widths)
    got = tmodel.features(torch.from_numpy(x)[:, None],
                          torch.from_numpy(widths))
    assert got.shape == want.shape == (3, images.shape[2] // 4,
                                       KW["d_model"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        CRNNFeatures.out_width(torch.from_numpy(widths)).numpy(),
        np.asarray(JaxFeatures.out_width(widths)))


def test_logits_match_jax(pair):
    jmodel, tmodel, params, images, widths = pair
    want, want_w = jmodel.apply(params, images, widths)
    for imgs in (images, images[..., None]):  # (N, H, W) and (N, H, W, 1)
        got, got_w = tmodel(imgs, widths)
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)


def test_padding_content_changes_no_valid_column(pair):
    """The padded columns are zeroed before the first convolution, so what
    the padding holds never reaches the output."""
    _, tmodel, _, images, widths = pair
    rng = np.random.default_rng(1)
    ref, _ = tmodel(images, widths)
    noisy = images.copy()
    for b, w in enumerate(widths):
        noisy[b, :, w:] = 100.0 * rng.standard_normal(
            (H, images.shape[2] - w))
    got, _ = tmodel(noisy, widths)
    assert torch.equal(got, ref)


def _stage_odd(w):
    """A width whose first or second pool floors an odd column count."""
    return w % 2 == 1 or (w // 2) % 2 == 1


def test_padding_amount_as_jax(pair):
    """A wider bucket changes no valid column of a padded sample, nor of
    an unpadded one whose pools halve even widths.  An unpadded sample
    whose width or half width is odd is the JAX model's own exception,
    kept for parity (ROADMAP.md queue 3): in a wider bucket its last
    valid pooled column has a right neighbour pooled from its last
    valid column and a zeroed one, where the exact-width image had the
    convolution's zero padding.  The port equals JAX on the padded
    batch either way."""
    jmodel, tmodel, params, images, widths = pair
    ref, ref_w = tmodel(images, widths)
    pad = np.concatenate([images, np.zeros((3, H, 6), np.float32)], axis=2)
    got, got_w = tmodel(pad, widths)
    want, _ = jmodel.apply(params, pad, widths)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_w.numpy(), ref_w.numpy())
    for b, (w, ow) in enumerate(zip(widths, ref_w.tolist())):
        close = np.allclose(got[b, :ow].detach().numpy(),
                            ref[b, :ow].detach().numpy(),
                            rtol=2e-4, atol=1e-5)
        assert close == (w < images.shape[2] or not _stage_odd(w)), b


def _jax_loss(jmodel, images, widths):
    def loss(p):
        logits, ow = jmodel.apply(p, images, widths)
        lp = jnp.moveaxis(jax.nn.log_softmax(logits, -1), 0, 1)
        return jax_ctc_loss(lp, TGT, ow, TL, implementation="xla")
    return loss


def test_ctc_loss_and_gradients_match_jax(pair):
    jmodel, tmodel, params, images, widths = pair
    want_loss, j_grads = jax.value_and_grad(
        _jax_loss(jmodel, images, widths))(params)
    tmodel.zero_grad()
    logits, ow = tmodel(images, widths)
    lp = torch.log_softmax(logits, -1).transpose(0, 1)
    loss = ctc_loss(lp, TGT, ow, TL)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = ocr_state_dict_from_flax(jax.device_get(j_grads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-3)
        err = float((got[name].grad - w).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _beam_sets(tokens, lens, scores):
    tokens, lens, scores = (np.asarray(x) for x in (tokens, lens, scores))
    return [{tuple(tokens[b, w, : int(lens[b, w])].tolist()):
             float(scores[b, w])
             for w in range(tokens.shape[1]) if np.isfinite(scores[b, w])}
            for b in range(tokens.shape[0])]


def test_beam10_matches_jax_scan(pair):
    jmodel, tmodel, params, images, widths = pair
    with torch.no_grad():
        logits, ow = tmodel(images, widths)
        lp = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    got = beam_search_decode(lp, ow, beam_width=10, prune_k=KW["vocab_size"])
    want = jax_beam(lp.numpy(), ow.numpy(), beam_width=10,
                    implementation="xla")
    assert got[0].shape[1] == 10
    for g, w in zip(_beam_sets(*got), _beam_sets(*want)):
        assert set(g) == set(w), set(g) ^ set(w)
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=5e-4, rtol=0)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OCRRecognizer(**KW)

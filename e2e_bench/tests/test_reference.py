"""The plain reference against the port at a tiny size on the CPU: the
features, the CTC model's log-probs, both training losses and every
gradient, the prefix beam search, and the beam and Viterbi scores against
brute force."""

import itertools
import math

import numpy as np
import pytest
import torch

from e2e_bench import compare, programs, weights
from e2e_bench.reference import beam, conformer, ctc, frontend, transducer
from end2end_tpu_torch.models.frontend import log_mel_spectrogram

CFG = {"model": "ctc", "sample_rate": 16000, "n_fft": 400, "hop_length": 160,
       "n_mels": 80, "subsampling_conv_channels": 32, "d_model": 32,
       "num_layers": 2, "num_heads": 4, "ff_expansion_factor": 4,
       "conv_kernel_size": 31, "vocab_size": 9, "blank": 0}
RNNT = dict(CFG, model="transducer", enc_dim=24, pred_emb_dim=8,
            pred_hidden=16, joint_hidden=16)
P = conformer.Precision(False)


def _batch(seed, lengths, pieces=None, v=9):
    g = torch.Generator().manual_seed(seed)
    pad = max(lengths)
    wave = 0.1 * torch.randn(len(lengths), pad, generator=g)
    n = torch.tensor(lengths)
    wave *= torch.arange(pad)[None] < n[:, None]
    if pieces is None:
        return wave, n
    tl = torch.tensor(pieces)
    tgt = torch.randint(1, v, (len(lengths), max(pieces)), generator=g)
    tgt *= torch.arange(max(pieces))[None] < tl[:, None]
    return wave, n, tgt, tl


def _model(cfg, seed, shaping=None):
    spec = (ctc if cfg["model"] == "ctc" else transducer).spec(cfg)
    w = weights.draw(spec, seed, "cpu", shaping)
    model = programs.build(cfg, "cpu")
    weights.check_layout(model.state_dict(), spec)
    model.load_state_dict(w)
    return model, w


def test_features_match_the_port():
    wave, _ = _batch(0, [16000, 12345])
    ref = frontend.log_mel(wave, CFG, P)
    port = log_mel_spectrogram(wave, 16000, 400, 160, 80)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)


def test_ctc_log_probs_match_the_port_padded_and_alone():
    model, w = _model(CFG, 1)
    wave, n = _batch(1, [16000, 9000, 23456])
    with torch.no_grad():
        logits, t = model.encode(wave, n)
        port = torch.log_softmax(logits, -1)
        ref, t_ref = ctc.log_probs(w, CFG, wave, n, P)
        assert t.tolist() == t_ref.tolist()
        for i in range(3):
            alone, _ = ctc.log_probs(w, CFG, wave[i:i + 1, : n[i]], n[i:i + 1],
                                     P)
            torch.testing.assert_close(alone[0], port[i, : t[i]], rtol=1e-5,
                                       atol=2e-5)
            torch.testing.assert_close(ref[i, : t[i]], port[i, : t[i]],
                                       rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("cfg", [CFG, RNNT], ids=["ctc", "transducer"])
def test_training_loss_and_every_gradient_match_the_port(cfg):
    model, w = _model(cfg, 2)
    batch = _batch(2, [16000, 11000, 7000], [9, 6, 4])
    port = programs.loss(model, cfg, *batch)
    port.backward()
    params = {k: v.requires_grad_() for k, v in w.items()}
    ref = (ctc if cfg["model"] == "ctc" else transducer).loss(
        params, cfg, *batch, P)
    ref.backward()
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    grads = dict(model.named_parameters())
    norms = {k: float(p.grad.norm()) for k, p in params.items()
             if p.grad is not None}
    small = 1e-3 * float(np.median(list(norms.values())))
    for k, p in params.items():
        if p.grad is None:  # the GRU's output layer: no part of the loss
            assert grads[k].grad is None
            continue
        if norms[k] < small:  # nought but rounding, as a key's bias
            continue
        err = float((grads[k].grad - p.grad).abs().max())
        assert err <= 1e-4 * float(p.grad.abs().max()), k


@pytest.mark.parametrize("seed", range(4))
def test_beam_search_matches_the_port(seed):
    model, w = _model(CFG, seed, {"out_scale": 6.0})
    wave, n = _batch(seed + 10, [20000, 14000, 9000])
    tokens, lengths, scores = model.decode(wave, n, beam_width=4, prune_k=5)
    with torch.no_grad():
        lp, t = ctc.log_probs(w, CFG, wave, n, P)
    s_cap = min(int(t.max()), 512)
    for i in range(3):
        hyps = beam.prefix_beam_search(lp[i, : t[i]].double().numpy(), 4, 5,
                                       0, s_cap)
        assert list(hyps[0][0]) == tokens[i, : lengths[i]].tolist()
        assert hyps[0][1] == pytest.approx(float(scores[i]), abs=1e-4)


def test_a_near_tie_is_found_and_a_clear_lead_is_not():
    """Two symbols equally likely where the beam keeps one of them: the
    reference's own best turns on rounding, and the request is not judged;
    with one of them well ahead it is."""
    mix = {"beam_width": 1, "prune_k": 3}
    lp = np.log(np.full((5, 3), [0.8, 0.1, 0.1]))
    lp[2] = np.log([0.1, 0.45, 0.45])
    hyps = compare.beam_search(lp, mix, 0, 10)
    assert compare.on_a_tie(lp, hyps, mix, 0, 10)
    lp[2] = np.log([0.1, 0.7, 0.2])
    hyps = compare.beam_search(lp, mix, 0, 10)
    assert hyps[0][0] == (1,)
    assert not compare.on_a_tie(lp, hyps, mix, 0, 10)


def test_beam_search_at_full_width_is_exact_for_short_lattices():
    rng = np.random.default_rng(3)
    lp = np.log(rng.dirichlet(np.ones(3), size=4))
    exact = {}
    for path in itertools.product(range(3), repeat=4):
        y = tuple(ctc.collapse(path, 0))
        exact[y] = np.logaddexp(exact.get(y, -np.inf),
                                sum(lp[t, s] for t, s in enumerate(path)))
    hyps = dict(beam.prefix_beam_search(lp, 100, 3, 0, 10))
    for y, v in exact.items():
        assert hyps[y] == pytest.approx(v, abs=1e-9)


def test_viterbi_against_brute_force():
    rng = np.random.default_rng(4)
    lp = np.log(rng.dirichlet(np.ones(4), size=5))
    for y in [(), (1,), (2, 2), (1, 3, 1)]:
        paths = [p for p in itertools.product(range(4), repeat=5)
                 if tuple(ctc.collapse(p, 0)) == y]
        scores = [sum(lp[t, s] for t, s in enumerate(p)) for p in paths]
        assert ctc.viterbi(lp, y, 0) == pytest.approx(max(scores))
    assert ctc.viterbi(lp, (1, 1, 1, 1), 0) == -math.inf  # needs 7 frames


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265])
    r = conformer._tf32(x)
    assert r.tolist()[:3] == [1.0, 1.0, 1.0 + 4 * 2 ** -11]
    assert abs(float(r[3]) + 3.14159265) < 2 ** -10 * 4


def test_padding_reaches_the_last_frames_in_both():
    """With a bias in the convolution module's first Linear, a clip's last
    frames depend on its batch's padding; the reference computes as the
    port does, so a request is checked padded as it was served."""
    model, w = _model(CFG, 5)
    with torch.no_grad():
        for i in range(CFG["num_layers"]):
            b = w[f"encoder.blocks.{i}.conv.pw1.bias"]
            b.normal_(generator=torch.Generator().manual_seed(i))
        model.load_state_dict(w)
    wave, n = _batch(5, [16000, 9000])
    with torch.no_grad():
        logits, t = model.encode(wave, n)
        port = torch.log_softmax(logits, -1)
        ref, _ = ctc.log_probs(w, CFG, wave, n, P)
        alone, _ = ctc.log_probs(w, CFG, wave[1:, : n[1]], n[1:], P)
    torch.testing.assert_close(ref[1, : t[1]], port[1, : t[1]], rtol=1e-5,
                               atol=2e-5)
    assert float((alone[0] - port[1, : t[1]]).abs().max()) > 1e-3

"""The operation counts (`flops`) against PyTorch's own count of the
reference's products, and the bounds (`bounds`) against hand counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from e2e_bench import bounds, flops, weights
from e2e_bench.reference import conformer, ctc, frontend, transducer

CFG = {"model": "ctc", "sample_rate": 16000, "n_fft": 400, "hop_length": 160,
       "n_mels": 80, "subsampling_conv_channels": 24, "d_model": 24,
       "num_layers": 2, "num_heads": 4, "ff_expansion_factor": 4,
       "conv_kernel_size": 31, "vocab_size": 11, "blank": 0,
       "enc_dim": 16, "pred_emb_dim": 8, "pred_hidden": 12,
       "joint_hidden": 10}
P = conformer.Precision(False)


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("samples", [1200, 4321, 16000 * 2 + 77])
def test_ctc_forward_matches_the_reference_products(samples):
    w = weights.draw(ctc.spec(CFG), 0, "cpu")
    wave = torch.randn(1, samples)
    n = torch.tensor([samples])
    got = _counted(lambda: ctc.log_probs(w, CFG, wave, n, P))
    assert flops.ctc_forward(samples, CFG) == got


@pytest.mark.parametrize("samples,pieces", [(8000, 3), (16000 + 500, 7)])
def test_transducer_forward_matches_the_reference_products(samples, pieces):
    cfg = dict(CFG, model="transducer")
    w = weights.draw(transducer.spec(cfg), 0, "cpu")
    wave = torch.randn(1, samples)
    tgt = torch.randint(1, 11, (1, pieces))

    def forward():
        feats = frontend.log_mel(wave, cfg, P)
        frames = frontend.num_frames(torch.tensor([samples]), 400, 160)
        enc, _ = conformer.encode(w, "encoder.", feats, frames, cfg, P)
        pred = transducer.prefix_states(w, tgt, P)
        h = torch.tanh(P.mm(enc, w["joint.w_enc"])[:, :, None]
                       + P.mm(pred, w["joint.w_pred"])[:, None])
        P.mm(h, w["joint.w_out"])

    assert flops.transducer_forward(samples, pieces, cfg) == _counted(forward)


def test_frames():
    assert flops.frames(400, CFG) == (1, 1, 1)
    assert flops.frames(16000, CFG) == (98, 49, 25)
    assert flops.frames(16000 * 35, CFG) == (3498, 1749, 875)


def test_bounds_by_hand():
    # K1: 2 samples of 10 and 6 frames, 3 and 2 labels, padded S = 3
    cells = 10 * 7 + 6 * 5
    nbytes = (10 * 4 + 6 * 3) * 4 + 2 * 3 * 4 + (10 * 2 * 7 + 10 * 2) * 4 \
        + 16
    assert bounds.ctc_bound(10, 2, 3, [10, 6], [3, 2], False) == \
        pytest.approx(1e3 * max(nbytes / 3.35e12, 10 * cells / 67e12))
    # K3: 8 rows of 129, k 24
    assert bounds.topk_bound(8, 129, 24) == pytest.approx(
        1e3 * (8 * 129 * 4 + 8 * 24 * 8) / 3.35e12)
    # K8 + K9 on one (N=1, T=4, U+1=3) lattice
    plane, tape = 4 * 3 * 4, 6 * 3 * 4 + 6 * 4
    assert bounds.rnnt_bound(1, 4, 3, True) == pytest.approx(
        1e3 * (4 * plane + tape + 16) / 3.35e12)
    # the combine: the gradient written, the frames' log-probs and gamma
    # read; the exps are 10x under the bytes
    nbytes = 1000 * 129 * 4 * 2 + 1000 * 21 * 4 + 10 * 4
    assert bounds.ctc_grad_bound(1000, 1, 129, 10, [1000], [10]) == \
        pytest.approx(1e3 * nbytes / 3.35e12)

"""The port's FastConformer options and LSTM/ReLU transducer (the
Parakeet-RNNT shape) on the CPU, at d 64, 2 blocks, 4 heads, kernel 9, 16
subsampling channels, vocabulary 33 and an LSTM of 2 x 32: against the
benchmark's plain reference (`e2e_bench/reference/parakeet.py`,
`fastconformer.py`), the relative shift against direct indexing, NeMo's
subsampled lengths, the LSTM's one call against its step loop, eval-mode
padding, and the defaults against today's encoder."""

import math
import statistics

import pytest
import torch

from e2e_bench import weights
from e2e_bench.reference import parakeet
from e2e_bench.reference.conformer import Precision
from end2end_tpu_torch.models.conformer import (ConformerEncoder,
                                                ConvSubsampling, rel_shift)
from end2end_tpu_torch.models.transducer import (ConformerTransducer,
                                                 TransducerConfig)

CFG = {"model": "transducer", "n_mels": 80, "subsampling_factor": 8,
       "subsampling_conv_channels": 16, "d_model": 64, "num_layers": 2,
       "num_heads": 4, "ff_expansion_factor": 4, "conv_kernel_size": 9,
       "enc_dim": 64, "pred_emb_dim": 32, "pred_hidden": 32,
       "pred_rnn_layers": 2, "joint_hidden": 32, "vocab_size": 33,
       "blank": 0}
FAST = dict(subsampling="dw_striding", subsampling_factor=8,
            subsampling_conv_channels=16, self_attention="rel_pos",
            xscaling=True, conv_norm="batch_norm")
PARAKEET = TransducerConfig(
    vocab_size=33, n_mels=80, d_model=64, num_layers=2, num_heads=4,
    conv_kernel=9, enc_dim=64, emb_dim=32, pred_hidden=32, joint_dim=32,
    predictor="lstm", pred_layers=2, joint_activation="relu", **FAST)


def _model(dtype, seed=3):
    w = parakeet.init_forget_bias(
        weights.draw(parakeet.spec(CFG), seed, "cpu"), CFG)
    model = ConformerTransducer(PARAKEET, device="cpu").to(dtype)
    weights.check_layout(model.state_dict(), parakeet.spec(CFG))
    w = {k: v.to(dtype) if v.is_floating_point() and v.dim() else v
         for k, v in w.items()}
    model.load_state_dict(w)
    return model, w


def _batch(dtype, lengths=(97, 60, 33), pieces=(6, 4, 2), seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(len(lengths), max(lengths), 80, generator=g)
    tgt = torch.randint(1, 33, (len(lengths), max(pieces)), generator=g)
    tgt *= torch.arange(max(pieces))[None] < torch.tensor(pieces)[:, None]
    return (feats.to(dtype), torch.tensor(lengths), tgt,
            torch.tensor(pieces))


def _port_and_reference(dtype):
    model, w = _model(dtype)
    batch = _batch(dtype)
    loss = model.loss(*batch)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    params = {k: v.clone().requires_grad_() for k, v in w.items()
              if k in grads}
    ref = parakeet.loss_from_features(params, CFG, *batch, Precision(False))
    ref.backward()
    ref_grads = {k: p.grad for k, p in params.items()}
    # leaves whose gradient is nought but for rounding, as the benchmark's
    # check leaves them out: a key's bias under softmax, and the depthwise
    # convolution's bias, which the BatchNorm after it subtracts again
    med = statistics.median(g.norm().item() for g in ref_grads.values())
    small = {k for k, g in ref_grads.items() if g.norm() < 1e-6 * med}
    assert small == {f"encoder.blocks.{i}.{m}.bias" for i in range(2)
                     for m in ("mhsa.key", "conv.dw")}
    return loss, grads, ref, {k: g for k, g in ref_grads.items()
                              if k not in small}


def test_parakeet_loss_and_every_gradient_float64():
    loss, grads, ref, ref_grads = _port_and_reference(torch.float64)
    assert abs(loss.item() - ref.item()) <= 1e-9 * abs(ref.item())
    for k, g in ref_grads.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-9,
                                   atol=1e-9 * g.abs().max().item(),
                                   msg=k)


def test_parakeet_loss_and_every_gradient_float32():
    """float32 on both sides, roundings apart: the loss to 1e-6 and each
    leaf's gradient to 2e-5 of its largest element (read: 1.2e-8 and
    1.1e-6 at most; TF32's 10-bit products read ~1e-3)."""
    loss, grads, ref, ref_grads = _port_and_reference(torch.float32)
    assert abs(loss.item() - ref.item()) <= 1e-6 * abs(ref.item())
    for k, g in ref_grads.items():
        torch.testing.assert_close(grads[k], g.float(), rtol=0,
                                   atol=2e-5 * g.abs().max().item(),
                                   msg=k)


@pytest.mark.parametrize("t", [1, 2, 5, 9])
def test_rel_shift_reads_the_offset_i_minus_j(t):
    x = torch.randn(2, 3, t, 2 * t - 1)
    i = torch.arange(t)
    row = (t - 1) - (i[:, None] - i[None, :])
    assert torch.equal(rel_shift(x), x.gather(3, row.expand(2, 3, t, t)))


def test_dw_striding_lengths_are_nemos():
    sub = ConvSubsampling(64, 80, 16, "dw_striding", 8)
    for t in range(1, 41):
        want = t
        for _ in range(3):  # NeMo's calc_length: padding 1, kernel 3, s 2
            want = math.floor((want + 2 - 3) / 2) + 1
        out = sub(torch.randn(1, t, 80), torch.tensor([t]))
        assert out.shape[1] == want == int(ConvSubsampling.out_length(t, 8))


def test_lstm_prefix_states_match_the_step_loop():
    model, _ = _model(torch.float32)
    _, _, tgt, _ = _batch(torch.float32)
    states = model._pred_states(tgt)
    step, h, joint = model.decoder_fns()
    h = h.expand(tgt.shape[0], -1)
    out, width = [h], PARAKEET.pred_hidden
    for col in tgt.T:
        out.append(step(out[-1], col))
    off = joint.pred_offset
    loop = torch.stack(out, 1)[..., off:off + width]
    torch.testing.assert_close(states, loop, rtol=1e-5, atol=1e-6)


def test_eval_mode_padding_is_inert():
    enc = ConformerEncoder(40, d_model=64, num_layers=2, num_heads=4,
                           conv_kernel=9, device="cpu", **FAST)
    feats, lens, _, _ = _batch(torch.float32)
    enc(feats, lens)  # training mode: the running statistics move
    enc.eval()
    with torch.no_grad():
        out, out_len = enc(feats, lens)
        for i, n in enumerate(lens.tolist()):
            alone, alone_len = enc(feats[i:i + 1, :n], lens[i:i + 1])
            assert out_len[i] == alone_len[0]
            torch.testing.assert_close(out[i, :out_len[i]],
                                       alone[0, :alone_len[0]],
                                       rtol=1e-5, atol=1e-5)


ENCODER_KEYS = [
    "subsample.conv0.weight", "subsample.conv0.bias",
    "subsample.conv1.weight", "subsample.conv1.bias",
    "subsample.dense.weight", "subsample.dense.bias",
    *(f"blocks.0.{k}" for k in (
        "ff1.ln.weight", "ff1.ln.bias", "ff1.fc1.weight", "ff1.fc1.bias",
        "ff1.fc2.weight", "ff1.fc2.bias", "mhsa.ln.weight", "mhsa.ln.bias",
        "mhsa.query.weight", "mhsa.query.bias", "mhsa.key.weight",
        "mhsa.key.bias", "mhsa.value.weight", "mhsa.value.bias",
        "mhsa.out.weight", "mhsa.out.bias", "conv.ln0.weight",
        "conv.ln0.bias", "conv.pw1.weight", "conv.pw1.bias",
        "conv.dw.weight", "conv.dw.bias", "conv.ln1.weight",
        "conv.ln1.bias", "conv.pw2.weight", "conv.pw2.bias",
        "ff2.ln.weight", "ff2.ln.bias", "ff2.fc1.weight", "ff2.fc1.bias",
        "ff2.fc2.weight", "ff2.fc2.bias", "ln.weight", "ln.bias")),
    "out.weight", "out.bias"]


def test_the_defaults_are_todays_encoder():
    """The default options build the encoder the port had before them:
    the same keys, and, option by option given explicitly, the same bits;
    the output of a seeded encoder is the one recorded before them."""
    kw = dict(vocab_size=11, d_model=32, num_heads=4, conv_kernel=7,
              n_mels=16, device="cpu")
    one = ConformerEncoder(num_layers=1, **kw)
    assert list(one.state_dict()) == ENCODER_KEYS
    enc = ConformerEncoder(num_layers=2, **kw,
                           generator=torch.Generator().manual_seed(3))
    same = ConformerEncoder(
        num_layers=2, **kw, generator=torch.Generator().manual_seed(3),
        subsampling="striding", subsampling_factor=4,
        subsampling_conv_channels=32, self_attention="abs_pos",
        xscaling=False, conv_norm="layer_norm")
    g = torch.Generator().manual_seed(5)
    x, lens = torch.randn(3, 37, 16, generator=g), torch.tensor([37, 20, 9])
    out, out_len = enc(x, lens)
    again, again_len = same(x, lens)
    assert torch.equal(out, again) and torch.equal(out_len, again_len)
    assert out_len.tolist() == [10, 5, 3]
    assert math.isclose(out.double().sum().item(), -3.9453981476835907,
                        rel_tol=1e-5)

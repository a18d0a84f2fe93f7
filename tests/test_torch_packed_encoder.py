"""The encoder's one forward on its two row layouts: the valid rows alone
(`Packing`) against every row (`EveryRow`), in float64 on the CPU.

`ConformerEncoder.forward` takes the valid rows only on CUDA;
`forward_packed` chooses them on any device and `forward_padded` every
row, so the CPU holds the one against the other here.  Every parameter,
biases and `pw1.bias` included, is drawn non-zero, and BatchNorm runs in
training mode, where its statistics cover the padded rows.  Valid output
frames and, after a loss over the valid frames, every parameter gradient
and BatchNorm's running statistics agree to 1e-10 of each tensor's
largest magnitude: float64 sums in other orders only.
"""

import copy
import itertools

import pytest
import torch

from end2end_tpu_torch.models.conformer import (ConformerEncoder, EveryRow,
                                                Packing)

torch.set_num_threads(1)

TOL = 1e-10
T, N_MELS = 40, 12
# a full-length row, a row of one frame, mixed lengths
LENGTHS = [40, 1, 27, 13, 33]


def _encoder(self_attention, conv_norm, subsampling):
    g = torch.Generator().manual_seed(7)
    kw = {} if subsampling is None else {
        "subsampling": subsampling, "subsampling_conv_channels": 6}
    enc = ConformerEncoder(
        vocab_size=9, d_model=16, num_layers=2, num_heads=2, conv_kernel=5,
        n_mels=N_MELS, subsample=subsampling is not None, device="cpu",
        generator=g, self_attention=self_attention, conv_norm=conv_norm,
        **kw).double()
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g,
                                     dtype=torch.float64))
        for name, b in enc.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=g)
    return enc.train()


def _inputs(lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(len(lengths), max(lengths), N_MELS, generator=g,
                        dtype=torch.float64)
    return feats, torch.tensor(lengths)


def _run(enc, method, feats, lengths, weights=None):
    """Logits, out lengths, and after a weighted sum over the valid frames
    its gradient of every parameter."""
    logits, out_len = getattr(enc, method)(feats, lengths)
    valid = (torch.arange(logits.shape[1])[None, :]
             < out_len[:, None])[..., None]
    if weights is None:
        weights = torch.randn(logits.shape, generator=torch.Generator()
                              .manual_seed(1), dtype=torch.float64)
    (logits * weights * valid).sum().backward()
    return logits.detach(), out_len, valid, {
        k: p.grad for k, p in enc.named_parameters()}


def _close(got, want):
    return (got - want).abs().max() <= TOL * max(1.0, want.abs().max())


@pytest.mark.parametrize(
    "self_attention,conv_norm,subsampling",
    list(itertools.product(("abs_pos", "rel_pos"),
                           ("layer_norm", "batch_norm"),
                           ("striding", "dw_striding", None))))
def test_packed_matches_padded(self_attention, conv_norm, subsampling):
    enc = _encoder(self_attention, conv_norm, subsampling)
    padded, packed = copy.deepcopy(enc), copy.deepcopy(enc)
    feats, lengths = _inputs(LENGTHS)
    want, want_len, valid, want_grads = _run(padded, "forward_padded",
                                             feats, lengths)
    got, got_len, _, got_grads = _run(packed, "forward_packed", feats,
                                      lengths)
    assert torch.equal(got_len, want_len)
    assert _close(got * valid, want * valid)
    assert torch.equal(got * ~valid, torch.zeros_like(got))
    assert want_grads.keys() == got_grads.keys()
    for k, g in want_grads.items():
        assert got_grads[k] is not None, k
        assert _close(got_grads[k], g), k
    if conv_norm == "layer_norm":  # the padded rows' fill reaches pw1.bias
        assert want_grads["blocks.0.conv.pw1.bias"].abs().max() > 0
    for (k, b), (_, b0) in zip(packed.named_buffers(),
                               padded.named_buffers()):
        assert _close(b.double(), b0.double()), k
    rows = int(want_len.sum())
    padded_rows = len(LENGTHS) * want.shape[1]
    assert rows < padded_rows
    assert packed.packing == {"forwards": 1, "packed": 1, "rows": rows,
                              "padded_rows": padded_rows}
    assert padded.packing == {"forwards": 1, "packed": 0,
                              "rows": padded_rows,
                              "padded_rows": padded_rows}


@pytest.mark.parametrize("case", ["no padding", "cpu forward"])
def test_padded_path_where_packing_has_nothing_to_skip(case):
    """A batch with no padded frame runs on every row, whichever layout
    is asked for; and `forward` takes the valid rows on CUDA alone: on the
    CPU the counter of packed forwards does not move."""
    enc = _encoder("rel_pos", "batch_norm", "dw_striding")
    ref = copy.deepcopy(enc)
    lengths = [T, T, T] if case == "no padding" else LENGTHS
    method = "forward_packed" if case == "no padding" else "forward"
    feats, lengths = _inputs(lengths)
    got, out_len, _, got_grads = _run(enc, method, feats, lengths)
    want, _, _, want_grads = _run(ref, "forward_padded", feats, lengths)
    assert torch.equal(got, want)
    for k, g in want_grads.items():
        assert torch.equal(got_grads[k], g), k
    padded_rows = got.shape[0] * got.shape[1]
    assert enc.packing == {"forwards": 1, "packed": 0, "rows": padded_rows,
                           "padded_rows": padded_rows}


@pytest.mark.parametrize("fill", [None, 0, "tensor"])
def test_the_layouts_agree_on_the_rows_they_both_hold(fill):
    """The same (R, C) rows scattered by either layout hold the same values
    at the valid frames; at the padded ones `fill` in both, or without it
    zeros where the rows were not computed and the rows' own values where
    they were.  Gathers, frames and masks agree, and so do the gradients
    of the rows and of a tensor `fill`."""
    lengths = torch.tensor(LENGTHS)
    n, t = len(LENGTHS), max(LENGTHS)
    total = int(lengths.sum())
    packed, every = Packing(lengths, total, t), EveryRow(lengths, t)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(n * t, 3, generator=g, dtype=torch.float64)
    valid = packed.mask.reshape(-1)
    assert torch.equal(packed.mask, every.mask)
    assert torch.equal(packed.t, every.t[valid])
    assert torch.equal(packed.gather(x.view(n, t, 3)),
                       every.gather(x.view(n, t, 3))[valid])
    outs, grads = [], []
    for layout, rows in ((packed, x[valid]), (every, x)):
        rows = rows.clone().requires_grad_(True)
        f = (torch.randn(3, generator=torch.Generator().manual_seed(3),
                         dtype=torch.float64, requires_grad=True)
             if fill == "tensor" else fill)
        out = layout.scatter(rows, f)
        assert out.shape == (n, t, 3)
        (out * torch.arange(out.numel()).view_as(out)).sum().backward()
        outs.append(out.detach())
        grads.append((rows.grad, f.grad if fill == "tensor" else None))
    mask = packed.mask[..., None]
    assert torch.equal(outs[0] * mask, outs[1] * mask)
    assert torch.equal(grads[0][0], grads[1][0][valid])
    if fill is None:
        assert not outs[0][~packed.mask].any()
        assert torch.equal(outs[1], x.view(n, t, 3))
    else:
        assert torch.equal(outs[0], outs[1])
        assert not grads[1][0][~valid].any()
    if fill == "tensor":
        assert torch.equal(grads[0][1], grads[1][1])

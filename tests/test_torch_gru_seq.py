"""The transducer predictor's GRU over a whole sequence (ops/neural_lm.py's
`_GRUSequence`, `gru_seq_forward_plain`, `gru_seq_backward_plain`,
`gru_prefix_states`; ops/gru_cuda.py's plan and checks), on the CPU.

The plain twins state the card kernels' arithmetic: their Function's
states and every gradient (the embedding, the three weights and biases,
h_0) must equal autograd through the `gru_step` loop to 1e-10 of each
tensor's largest entry in float64, and to 2e-5 in float32 (a product of
E + H terms computed as two sums, the x side and the h side, and
backward products summed in another order, over up to 40 steps: a few
float32 ulps of the tensor's scale, observed up to ~2e-6).  On the CPU
`gru_prefix_states` is the loop itself, so the transducer's states and
loss gradients there are bit-equal to the loop's.  The kernels themselves
run in tests/test_torch_cuda.py and chip_smoke.py's phase 37, both through
`card_errors` here.
"""

from functools import partial

import numpy as np
import pytest
import torch

from end2end_tpu_torch import ConformerTransducer, TransducerConfig
from end2end_tpu_torch.ops import gru_cuda
from end2end_tpu_torch.ops import neural_lm as tnl
from end2end_tpu_torch.ops.rnnt_decode import _prefix_states
from end2end_tpu_torch.ops.rnnt_loss import rnnt_loss

KEYS = ("emb", "wz", "wr", "wh", "bz", "br", "bh")
TOL = {torch.float64: 1e-10, torch.float32: 2e-5}
H100_SMEM = 232448  # shared bytes a block, opted in


def gru_case(seed, v, e, h, n, u, dtype=torch.float32, device="cpu"):
    """Random GRU parameters (biases too), a random h_0 and (N, U) tokens,
    ragged: row 0 full, the others padded with 0 or -1 (the last
    embedding row, as `gru_step`'s indexing reads it) past a random
    length; and a cotangent of the states.  Leaves on `device`."""
    rng = np.random.default_rng(seed)
    p = tnl.random_gru_params(rng, v, emb_dim=e, hidden_dim=h)
    for k in ("bz", "br", "bh"):
        p[k] = 0.3 * rng.standard_normal(h).astype(np.float32)

    def leaf(x, grad):
        return torch.tensor(x, dtype=dtype, device=device,
                            requires_grad=grad)

    params = {k: leaf(p[k], True) for k in KEYS}
    h0 = leaf(0.5 * rng.standard_normal(h), True)
    toks = rng.integers(0, v, (n, u))
    lens = rng.integers(0, u + 1, n)
    lens[0] = u
    fill = np.where(np.arange(n) % 2 == 0, 0, -1)[:, None]
    toks = np.where(np.arange(u)[None] < lens[:, None], toks, fill)
    cot = leaf(rng.standard_normal((n, u + 1, h)), False)
    return params, h0, torch.from_numpy(toks).long().to(device), cot


def grads_of(states, cot, params, h0):
    (states * cot).sum().backward()
    out = {k: params[k].grad.clone() for k in KEYS}
    out["h0"] = h0.grad.clone()
    for x in (*params.values(), h0):
        x.grad = None
    return out


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# The kernels on the card (`card_errors`), as (N, U, E, H, V): the
# transducer cell's widths at its 36 s, 14 s and 4 s buckets (400 s a
# batch at 4.5 pieces a second: N = 11, 28, 100), then the card test
# model's H = 10 (unaligned rows: the scalar staging) at (5, 40) and
# (100, 18).  Each error a share of the reference tensor's largest entry:
# the kernels sum each product of H terms in their own order (lanes, then
# a butterfly) where cuBLAS picks its own, and the differences ride the
# recurrence over U steps and, backwards, into the gradients' sums over
# N U rows (and `index_add_`'s atomics sum the embedding rows in any
# order).  The limits are ~10x the most seen on the H100: 2.2e-7 for the
# states, the tape, dgx and h_0's rows, 1.1e-6 for the gradients.
CARD_SHAPES = ((11, 158, 640, 640, 1025), (28, 63, 640, 640, 1025),
               (100, 18, 640, 640, 1025), (5, 40, 6, 10, 8),
               (100, 18, 6, 10, 8))
CARD_TOL = {"states": 3e-6, "tape": 3e-6, "dgx": 3e-6, "dh0": 3e-6,
            "seq_states": 3e-6, **{k: 1e-5 for k in (*KEYS, "h0")}}


def card_errors(n, u, e, h, v, device):
    """On the card: the forward kernel's states and tape and the backward
    kernel's dgx and h_0 rows against the plain twins' on the same
    inputs (the backward on the twins' tape); then `gru_prefix_states`'
    states and every gradient against autograd through the `gru_step`
    loop.  Returns the errors by name (`CARD_TOL`'s keys) and the
    launches the `gru_prefix_states` call made."""
    params, h0, toks, cot = gru_case(n * 1000 + u, v, e, h, n, u,
                                     device=device)
    hidden = [params[k].detach()[e:] for k in ("wz", "wr", "wh")]
    gx = torch.from_numpy(np.random.default_rng(u).standard_normal(
        (n, u, 3 * h)).astype(np.float32)).to(device)
    with torch.no_grad():
        got = gru_cuda.gru_forward(gx, *hidden, h0.detach())
        want = tnl.gru_seq_forward_plain(gx, *hidden, h0.detach())
        got_b = gru_cuda.gru_backward(cot, *want, *hidden)
        want_b = tnl.gru_seq_backward_plain(cot, *want, *hidden)
    errs = {k: rel(a, b) for k, a, b in zip(
        ("states", "tape", "dgx", "dh0"), (*got, *got_b), (*want, *want_b))}
    before = dict(gru_cuda.launches)
    seq = tnl.gru_prefix_states(params, h0, toks)
    got = grads_of(seq, cot, params, h0)
    torch.cuda.synchronize()
    ran = {k: gru_cuda.launches[k] - c for k, c in before.items()}
    loop = _prefix_states(partial(tnl.gru_step, params), h0, toks)
    errs["seq_states"] = rel(seq.detach(), loop.detach())
    for k, g in grads_of(loop, cot, params, h0).items():
        errs[k] = rel(got[k], g)
    return errs, ran


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("h,u", [(10, 1), (10, 40), (64, 1), (64, 40)])
def test_plain_twins_match_autograd_through_the_loop(dtype, h, u):
    params, h0, toks, cot = gru_case(h * 100 + u, 13, 6, h, 5, u, dtype)
    loop = _prefix_states(partial(tnl.gru_step, params), h0, toks)
    want = grads_of(loop, cot, params, h0)
    seq = tnl._gru_sequence(params, h0, toks)
    got = grads_of(seq, cot, params, h0)
    assert seq.shape == loop.shape == (5, u + 1, h)
    assert rel(seq.detach(), loop.detach()) < TOL[dtype]
    for k, g in want.items():
        assert rel(got[k], g) < TOL[dtype], k


def test_plain_backward_is_the_hand_derived_recurrence():
    """`gru_seq_backward_plain`'s pre-activation gradients against autograd
    through `gru_seq_forward_plain` wrt gx, and its h_0 rows wrt an
    expanded h_0, in float64."""
    rng = np.random.default_rng(7)
    n, u, h = 4, 9, 10
    gx = torch.tensor(rng.standard_normal((n, u, 3 * h)), requires_grad=True)
    w = [torch.tensor(rng.standard_normal((h, h)) / np.sqrt(h))
         for _ in range(3)]
    h0 = torch.tensor(rng.standard_normal(h), requires_grad=True)
    cot = torch.tensor(rng.standard_normal((n, u + 1, h)))
    states, tape = tnl.gru_seq_forward_plain(gx, *w, h0)
    (states * cot).sum().backward()
    dgx, dh0 = tnl.gru_seq_backward_plain(cot, states.detach(),
                                          tape.detach(), *w)
    assert rel(dgx, gx.grad) < 1e-12
    assert rel(dh0.sum(0), h0.grad) < 1e-12
    z, r, c, q = tape.detach().split(h, 2)
    assert torch.equal(q, r * states.detach()[:, :-1])


@pytest.mark.parametrize("u", [0, 1, 7])
def test_prefix_states_on_the_cpu_are_the_loop(u):
    params, h0, toks, cot = gru_case(3 + u, 11, 6, 10, 4, u, torch.float32)
    want = _prefix_states(partial(tnl.gru_step, params), h0, toks)
    got = tnl.gru_prefix_states(params, h0, toks)
    assert torch.equal(got, want)
    if u:
        assert all(torch.equal(a, b) for a, b in zip(
            grads_of(got, cot, params, h0).values(),
            grads_of(want, cot, params, h0).values()))


def test_transducer_loss_gradients_on_the_cpu_are_unchanged():
    """`ConformerTransducer.loss` on the CPU: its loss and every gradient
    bit-equal to the same model's loss through the loop, written out."""
    model = ConformerTransducer(TransducerConfig(
        vocab_size=8, n_mels=12, d_model=16, num_layers=1, num_heads=2,
        conv_kernel=7, enc_dim=16, emb_dim=6, pred_hidden=10, joint_dim=12),
        device="cpu")
    feats = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 37, 12)).astype(
            np.float32))
    lens = torch.tensor([37, 29])
    tgt, tl = torch.tensor([[1, 2, 3], [4, 5, 0]]), torch.tensor([3, 2])

    def grads(loss):
        model.zero_grad()
        loss.backward()
        return loss.detach(), {k: p.grad.clone()
                               for k, p in model.named_parameters()
                               if p.grad is not None}

    got = grads(model.loss(feats, lens, tgt, tl))
    enc, enc_len = model.encode(feats, lens)
    states = _prefix_states(partial(tnl.gru_step, model.pred),
                            torch.zeros(10), tgt)
    want = grads(rnnt_loss(model.joint_logits(enc, states), tgt, enc_len,
                           tl, blank=0, reduction="mean", from_logits=True))
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    assert {k for k in got[1] if k.startswith("pred.")} == {
        f"pred.{k}" for k in KEYS}
    for k, g in want[1].items():
        assert torch.equal(got[1][k], g), k


@pytest.mark.parametrize("n,h", [(1, 1), (2, 10), (11, 640), (28, 640),
                                 (100, 640), (200, 640), (100, 10),
                                 (64, 1024), (5, 1300)])
def test_plan_fits_the_card(n, h):
    """Every block resident (one an SM of 132), the slices cover H, whole
    row pairs, both kernels' shared memory under the H100's 227 KB a
    block, and two row groups wherever twice the units fit (not at
    H = 1300, which takes 10 units a block on one group)."""
    p = gru_cuda.gru_plan(n, h, 132, H100_SMEM)
    assert p.units in gru_cuda.UNIT_PLANS and 2 * p.units <= 32
    assert p.slices == -(-h // p.units) and p.slices * p.groups <= 132
    assert p.rows_tile >= 2 and p.rows_tile % 2 == 0
    assert p.smem_fwd == 4 * (3 * p.units + p.rows_tile) * h
    assert p.smem_bwd == 4 * (3 * p.units + 2 * p.rows_tile) * h
    assert p.smem_bwd <= H100_SMEM
    assert p.groups == (1 if h == 1300 else 2)


@pytest.mark.parametrize("h", [2200, 4096])
def test_plan_raises_past_shared_memory(h):
    with pytest.raises(ValueError, match="gru_cuda"):
        gru_cuda.gru_plan(4, h, 132, H100_SMEM)


def test_kernels_refuse_cpu_tensors():
    """The kernel wrappers raise on what they do not take, before any
    build: nothing falls back to the plain twins."""
    h = 4
    w = torch.zeros(h, h)
    with pytest.raises(ValueError, match="CUDA float32"):
        gru_cuda.gru_forward(torch.zeros(2, 3, 3 * h), w, w, w,
                             torch.zeros(h))
    with pytest.raises(ValueError, match="CUDA float32"):
        gru_cuda.gru_backward(torch.zeros(2, 4, h), torch.zeros(2, 4, h),
                              torch.zeros(2, 3, 4 * h), w, w, w)
    assert gru_cuda.launches == {"gru_forward": 0, "gru_backward": 0}

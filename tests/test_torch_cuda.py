"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test needs an NVIDIA GPU and nvcc, and skips without
them (the CPU tests cover the plain versions against the JAX package).  On
the GPU machine, which has no JAX for tests/conftest.py to import:
`python -m pytest --noconftest tests/test_torch_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from end2end_tpu_torch.ops import (beam_search_cuda, ctc_loss_cuda,
                                   ctc_loss_plain, rnnt_joint_cuda,
                                   rnnt_joint_plain, rnnt_loss_cuda,
                                   rnnt_loss_plain, topk_cuda)
from end2end_tpu_torch.ops.ctc_common import build_ctc_tables
from end2end_tpu_torch.ops import lm as tlm
from end2end_tpu_torch.ops.beam_search import beam_search_decode
from end2end_tpu_torch.ops.ctc_loss import ctc_nll
from end2end_tpu_torch.ops.rnnt_joint import rnnt_nll_fused_pallas
from end2end_tpu_torch.ops.rnnt_loss import rnnt_loss, rnnt_nll
from end2end_tpu_torch.tools import ctc_alpha_breakdown

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def two_barrier_k1(tmp_path_factory):
    """The two-barrier K1 that K1 replaced, built from
    tools/ctc_alpha_reference.cu: K1's bit-identity oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return ctc_alpha_breakdown.build_reference(
        tmp_path_factory.mktemp("two_barrier_k1"))[0]


def _topk_rows(rng, v):
    """Rows of one V: normal values, all equal, few distinct values (ties
    across lanes), runs of -inf, -inf ties with finite values, and
    mixed +-inf."""
    x = rng.standard_normal((9, v)).astype(np.float32)
    x[1] = 0.5
    x[2] = rng.integers(0, 3, v)
    x[3, : v // 2] = -np.inf
    x[4, ::2] = -np.inf
    x[5] = -np.inf
    x[6, v // 3:] = -np.inf
    x[7] = np.where(np.arange(v) % 33 == 7, 1.0, 0.0)  # ties 33 apart
    x[8, -1] = np.inf
    return x


@pytest.mark.parametrize("v", [1, 2, 16, 31, 32, 33, 64, 1000, 1024, 4096])
def test_topk_kernel_matches_plain_at_each_width(dev, v):
    """K3 against the stable sort at every width the kernel can branch on,
    k = 1, a middle k and k = V: values and indices bit-equal."""
    x = torch.from_numpy(_topk_rows(np.random.default_rng(v), v)).to(dev)
    for k in sorted({1, min(24, v), v}):
        vals, idx = topk_cuda.topk_cuda(x, k)
        pv, pi = topk_cuda.topk_plain(x, k)
        assert torch.equal(vals, pv) and torch.equal(idx, pi), k


@pytest.mark.parametrize("T,B,V,k", [(7, 3, 5, 5), (20, 4, 1024, 24),
                                     (3, 2, 33, 1)])
def test_topk_kernel_matches_plain(dev, T, B, V, k):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((T, B, V)).astype(np.float32))
    x[0, 0, ::3] = float("-inf")
    x[1] = torch.from_numpy(rng.integers(0, 3, (B, V)).astype(np.float32))
    x = x.to(dev)
    before = topk_cuda.launches
    vals, idx = topk_cuda.topk(x, k)
    assert topk_cuda.launches == before + 1
    pv, pi = topk_cuda.topk_plain(x, k)
    assert torch.equal(vals, pv) and torch.equal(idx, pi)


@pytest.mark.parametrize("W,K", [(4, 6), (8, 3), (32, 8)])
def test_beam_kernel_matches_plain(dev, W, K):
    rng = np.random.default_rng(1)
    T, B, V = 40, 5, 12
    x = rng.standard_normal((T, B, V)) * 2.0
    lp = torch.from_numpy(
        (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32))
    il = torch.tensor([40, 31, 12, 1, 40], dtype=torch.int32)
    ks = min(K + 8, V)
    lpk, ck = topk_cuda.topk_plain(lp, ks)
    args = (lpk, ck, lp[:, :, 0].contiguous(), il)
    want = beam_search_cuda.beam_step_plain(*args, W, K, 10, 0)
    before = beam_search_cuda.launches
    got = beam_search_cuda.beam_step(*(a.to(dev) for a in args), W, K, 10,
                                     0)
    assert beam_search_cuda.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])  # backpointer codes
    assert torch.equal(got[2].cpu(), want[2])  # last tokens
    torch.testing.assert_close(got[1].cpu(), want[1], atol=1e-4, rtol=0)
    dec = beam_search_decode(lp.to(dev), il.to(dev), beam_width=W, prune_k=K,
                             max_symbols=10)
    ref = beam_search_decode(lp, il, beam_width=W, prune_k=K, max_symbols=10)
    assert torch.equal(dec[0].cpu(), ref[0])


_COUNTERS = ("launches", "launches_lm", "launches_cls", "launches_resume")


@pytest.mark.parametrize("mode", ["lm", "cls", "resume", "resume_lm",
                                  "resume_cls"])
@pytest.mark.parametrize("W,K", [(4, 6), (8, 3), (32, 8)])
def test_beam_lm_modes_match_plain(dev, mode, W, K):
    """K5 (symbol-keyed increments), K6 (class-keyed), K7 (resume) against
    the plain twin run on the card: codes and the 10-field state
    bit-identical, scores equal."""
    rng = np.random.default_rng(3)
    T, B, V = 40, 5, 12
    x = rng.standard_normal((T, B, V)) * 2.0
    lp = torch.from_numpy(
        (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32))
    lpk, ck = topk_cuda.topk_plain(lp.to(dev), min(K + 8, V))
    args = (lpk, ck, lp[:, :, 0].contiguous().to(dev),
            torch.tensor([40, 31, 12, 1, 40], dtype=torch.int32, device=dev))
    kw = {}
    if mode.endswith("lm"):
        kw["inc"] = torch.from_numpy(
            rng.standard_normal((V + 1, V)).astype(np.float32)).to(dev)
    if mode.endswith("cls"):
        kw["inc"] = torch.from_numpy(
            rng.standard_normal((5, V)).astype(np.float32)).to(dev)
        kw["cls_map"] = torch.from_numpy(
            rng.integers(0, 4, V).astype(np.int32)).to(dev)
    if mode.startswith("resume"):  # a state carried in from 15 frames
        lead = beam_search_cuda.beam_step_plain(
            lpk[:15], ck[:15], args[2][:15], args[3], W, K, 10, 0, **kw)
        kw["state_in"] = lead[3]
        args = (lpk[15:], ck[15:], args[2][15:], args[3] - 15)
    want = beam_search_cuda.beam_step_plain(*args, W, K, 10, 0, **kw)
    before = {c: getattr(beam_search_cuda, c) for c in _COUNTERS}
    got = beam_search_cuda.beam_step(*args, W, K, 10, 0, **kw)
    after = {c: getattr(beam_search_cuda, c) for c in _COUNTERS}
    assert after == {
        "launches": before["launches"] + 1,
        "launches_lm": before["launches_lm"] + (mode.endswith("lm")),
        "launches_cls": before["launches_cls"] + (mode.endswith("cls")),
        "launches_resume": (before["launches_resume"]
                            + mode.startswith("resume"))}
    assert torch.equal(got[0], want[0])  # backpointer codes
    for g, w in zip(got[3], want[3]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_lm_decodes_on_the_card_match_the_cpu(dev):
    """The fused and the chunked (guided) decodes, kernels on the card vs
    the plain path on the CPU: same tokens, scores within 1e-4."""
    rng = np.random.default_rng(4)
    T, B, V = 60, 4, 9
    x = rng.standard_normal((T, B, V)) * 2.0
    lp = torch.from_numpy(
        (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32))
    big = tlm.bigram_from_counts(rng.integers(0, 20, (V, V)))
    words = [(1, 2), (3,), (2, 2, 4), (5, 6)]
    wb = np.log(rng.random((4, 4)) + 0.05).astype(np.float32)
    for device in ("cpu", dev):
        lm = tlm.NGramLM(big, device=device)
        word = tlm.WordNGramLM(words, wb, np.zeros(4), 7, device=device)
        guide = tlm.QuantizedBigramGuide.from_bigram(lm, n_classes=3)
        out = [beam_search_decode(lp.to(device), beam_width=8, prune_k=5,
                                  lm=lm, lm_alpha=0.6, lm_beta=0.3)]
        for g in (None, lm, guide):
            out.append(beam_search_decode(
                lp.to(device), beam_width=8, prune_k=5, lm=word,
                lm_alpha=0.6, lm_beta=0.3, implementation="chunked",
                lm_chunk_t=16, guide_lm=g))
        if device == "cpu":
            ref = out
    for got, want in zip(out, ref):
        assert torch.equal(got[0].cpu(), want[0])
        torch.testing.assert_close(got[2].cpu(), want[2], atol=1e-4, rtol=0)


def test_models_and_lms_default_to_the_card(dev):
    from end2end_tpu_torch import ConformerCTCPipeline, PipelineConfig

    pipe = ConformerCTCPipeline(PipelineConfig(
        vocab_size=16, d_model=64, num_layers=2, num_heads=2, n_mels=16))
    lm = tlm.NGramLM(np.zeros((16, 16), np.float32))
    assert pipe.device.type == lm.device.type == "cuda"
    assert tlm.QuantizedBigramGuide.from_bigram(lm, 4).device == lm.device


def _edge_batch():
    """Repeated labels, zero target, infeasible, il < T, il == 0, -inf
    log-probs, odd B and T, in one batch (blank passed separately)."""
    rng = np.random.default_rng(2)
    T, B, V = 41, 7, 9
    x = rng.standard_normal((T, B, V)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lp[::4, 5, 3] = -np.inf
    tgt = np.array([[1, 2, 3, 4, 5], [2, 2, 2, 2, 0], [5, 0, 0, 0, 0],
                    [1, 1, 1, 1, 1], [3, 4, 3, 4, 3], [3, 3, 1, 2, 2],
                    [7, 8, 0, 0, 0]], np.int32)
    il = np.array([41, 9, 30, 5, 41, 23, 0], np.int32)  # 3: infeasible
    tl = np.array([5, 4, 0, 5, 5, 5, 2], np.int32)
    return lp, tgt, il, tl


def _loss_grad(lp, tgt, il, tl, dev, blank, implementation, every):
    x = torch.tensor(lp, device=dev, requires_grad=True)
    args = [torch.tensor(a, device=dev) for a in (tgt, il, tl)]
    nll = ctc_nll(x, *args, blank=blank, implementation=implementation,
                  checkpoint_every=every)
    nll.sum().backward()
    return nll.detach(), x.grad


@pytest.mark.parametrize("blank", [0, 6])
def test_ctc_kernels_match_plain(dev, blank):
    lp, tgt, il, tl = _edge_batch()
    tgt = np.where(tgt == blank, 1, tgt) if blank else tgt
    want = _loss_grad(lp, tgt, il, tl, dev, blank, "xla", 0)
    before = dict(ctc_loss_cuda.launches)
    got = {}
    for every in (0, 4, 64):
        got[every] = _loss_grad(lp, tgt, il, tl, dev, blank, "auto", every)
    assert ctc_loss_cuda.launches == {k: v + 3 for k, v in before.items()}
    loss, grad = got[0]
    assert torch.equal(torch.isinf(loss), torch.isinf(want[0]))
    assert torch.isinf(loss[[3, 6]]).all()
    torch.testing.assert_close(loss, want[0], atol=1e-4, rtol=2e-6)
    torch.testing.assert_close(grad, want[1], atol=1e-5, rtol=0)
    assert torch.isfinite(grad).all() and not grad[:, 6].any()
    # The kernels' outputs, and the gradient (the combine kernel sums in
    # one fixed order), are bit-identical across the tape and checkpoint
    # modes.
    outs = {every: _kernel_outputs(lp, tgt, il, tl, dev, blank, every)
            for every in (0, 4, 64)}
    for every in (4, 64):
        assert torch.equal(got[every][0], loss)
        assert torch.equal(got[every][1], grad)
        assert torch.equal(outs[every][0], outs[0][0])
        assert torch.equal(outs[every][1], outs[0][1])


def test_ctc_gradient_is_deterministic(dev):
    """Two gradient runs through K1, K2 and the combine are bit-equal, with
    duplicate labels in every target (the combine's fixed-order sums) and
    within 1e-5 of the plain combine (`scatter_add_`) on the same gamma."""
    rng = np.random.default_rng(3)
    T, B, S, V = 300, 16, 60, 40
    x = rng.standard_normal((T, B, V))
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    tgt = rng.integers(1, 6, (B, S)).astype(np.int32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    tl = np.minimum(rng.integers(1, S + 1, B), il // 3).astype(np.int32)
    runs = [_loss_grad(lp, tgt, il, tl, dev, 0, "pallas", 0)[1]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    args = [torch.tensor(a, device=dev) for a in (lp, tgt, il, tl)]
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(*args)
    gamma = ctc_loss_cuda.beta_cuda(*args, a, an, z, ne)
    g = torch.ones(B, device=dev)
    before = ctc_loss_cuda.launches["ctc_grad"]
    got = ctc_loss_cuda.grad_cuda(*args, gamma, g)
    assert ctc_loss_cuda.launches["ctc_grad"] == before + 1
    ext = build_ctc_tables(args[1], args[3], 0, V).ext_labels
    want = ctc_loss_plain.nll_grad(args[0], gamma, ext, args[2].long(), g)
    assert torch.equal(got, runs[0])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _kernel_outputs(lp, tgt, il, tl, dev, blank, every):
    """(z_hat, gamma) of K1 then K2."""
    args = [torch.tensor(a, device=dev) for a in (lp, tgt, il, tl)]
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(*args, blank, every)
    return z, ctc_loss_cuda.beta_cuda(*args, a, an, z, ne, blank, every)


def _k1_case(rng, t, b, s, v, dev):
    """Lengths with il = 0, il = 1, il = T and one in between, full and
    empty targets, repeated labels."""
    x = rng.standard_normal((t, b, v)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lp[::3, 0, 1] = -np.inf
    il = np.array([t, 0, 1, max(t // 2, 1)])[:b]
    tl = np.array([s, s, min(s, 1), s // 2])[:b]
    tgt = rng.integers(1, 4, (b, s))
    return [torch.from_numpy(lp).to(dev)] + [
        torch.from_numpy(a.astype(np.int32)).to(dev) for a in (tgt, il, tl)]


@pytest.mark.parametrize("s", [0, 16, 511, 512])
@pytest.mark.parametrize("t", [1, 37])
def test_alpha_kernel_bit_equal_to_the_two_barrier_kernel(
        dev, two_barrier_k1, s, t):
    """K1 at L = 1, 33, 1023 and 1025 states, with il = 0, il = 1 and
    T = 1, at every states-per-thread choice that fits (threads owning
    several states), rings of 2, 4 and 8 frames and tapes staged 1, 3 and
    16 frames, in the tape and checkpoint modes: every output bit-equal to
    the two-barrier K1's; and K2's gamma in checkpoint mode equal to its
    tape-mode value."""
    args = _k1_case(np.random.default_rng(s + t), t, 4, s, 7, dev)
    plans = [{}, {"ring": 2, "tape": 1}, {"ring": 4, "tape": 3},
             {"ring": 8, "tape": 16}]
    plans += [{"states": r} for r in ctc_loss_cuda.STATES
              if -(-(2 * s + 1) // r) <= 1024]
    for every in (0, 4, 64):
        want = ctc_alpha_breakdown.runner(two_barrier_k1, False, args,
                                          every)()
        for plan in plans:
            got = ctc_loss_cuda.alpha_cuda(*args, 0, every, **plan)
            assert ctc_alpha_breakdown.equal_outputs(got, want), (
                every, plan)
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(*args)
    gamma = ctc_loss_cuda.beta_cuda(*args, a, an, z, ne)
    for every in (4, 64):
        z, ne, a, an = ctc_loss_cuda.alpha_cuda(*args, 0, every)
        assert torch.equal(ctc_loss_cuda.beta_cuda(*args, a, an, z, ne, 0,
                                                   every), gamma)


def test_alpha_kernel_signed_zero_row_max(dev, two_barrier_k1):
    """A row whose max is +0 and -0 at once (the first frame's two
    states emit log-probs +0.0 and -0.0, in both orders): K1's exact warp
    max and the two-barrier K1's fmaxf pick the same zero, so the shift,
    and the sign of every zero in the tape, agree bit for bit."""
    lp = torch.full((3, 2, 3), -1.0)
    lp[0, 0, 0], lp[0, 0, 1] = 0.0, -0.0
    lp[0, 1, 0], lp[0, 1, 1] = -0.0, 0.0
    args = [lp.to(dev)] + [torch.tensor(a, dtype=torch.int32, device=dev)
                           for a in ([[1], [1]], [3, 3], [1, 1])]
    want = ctc_alpha_breakdown.runner(two_barrier_k1, False, args)()
    for states in (1, 2, 3, 4):
        got = ctc_loss_cuda.alpha_cuda(*args, states=states)
        assert ctc_alpha_breakdown.equal_outputs(got, want), states


def test_ctc_kernels_reject_what_they_cannot_run(dev):
    lp, tgt, il, tl = _edge_batch()
    x = torch.tensor(lp, device=dev, dtype=torch.float64)
    args = [torch.tensor(a, device=dev) for a in (tgt, il, tl)]
    with pytest.raises(ValueError, match="float32"):
        ctc_loss_cuda.ctc_nll_cuda(x, *args)
    with pytest.raises(ValueError, match="pallas"):
        ctc_nll(x, *args, implementation="pallas")
    big = torch.zeros((x.shape[1], 6000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ctc_loss_cuda.ctc_nll_cuda(x.float(), big, *args[1:])


def _rnnt_case(seed, n, t, u, v, blank, dev):
    """Random logits on the card, variable lengths, sample 1's target
    empty (when n > 1)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.standard_normal((n, t, u + 1, v)).astype(np.float32)).to(dev)
    lo, hi = (1, v) if blank == 0 else (0, v - 1)
    tgt = rng.integers(lo, hi, (n, u)).astype(np.int32)
    il = rng.integers(max(t // 2, 1), t + 1, n).astype(np.int32)
    ul = rng.integers(0, u + 1, n).astype(np.int32)
    il[0], ul[0] = t, u
    if n > 1:
        ul[1] = 0
    return x, *(torch.from_numpy(a).to(dev) for a in (tgt, il, ul))


def _rnnt_loss_grad(x, tgt, il, ul, blank, implementation):
    x = x.detach().clone().requires_grad_(True)
    nll = rnnt_nll(x, tgt, il, ul, blank=blank,
                   implementation=implementation)
    nll.sum().backward()
    return nll.detach(), x.grad


@pytest.mark.parametrize("n,t,u,v,blank", [
    (4, 7, 3, 9, 0), (3, 5, 12, 6, 0), (5, 40, 9, 17, 16),
    (2, 3, 1100, 5, 0)])  # U+1 > 1024 threads: several lanes per thread
def test_rnnt_kernels_match_plain(dev, n, t, u, v, blank):
    """K8/K9 vs the plain scans on the card: NLL within 1e-4 + 2e-6 rel,
    K9's posteriors on the same residuals within 1e-6, the logits
    gradient within 1e-5, and both within 1e-4 of the float64 scan."""
    x, tgt, il, ul = _rnnt_case(0, n, t, u, v, blank, dev)
    before = dict(rnnt_loss_cuda.launches)
    k_nll, k_grad = _rnnt_loss_grad(x, tgt, il, ul, blank, "auto")
    assert rnnt_loss_cuda.launches == {k: c + 1 for k, c in before.items()}
    p_nll, p_grad = _rnnt_loss_grad(x, tgt, il, ul, blank, "xla")
    d_nll, d_grad = _rnnt_loss_grad(x.double(), tgt, il, ul, blank, "auto")
    torch.testing.assert_close(k_nll, p_nll, atol=1e-4, rtol=2e-6)
    torch.testing.assert_close(k_grad, p_grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(k_nll.double(), d_nll, atol=1e-4, rtol=1e-6)
    torch.testing.assert_close(k_grad.double(), d_grad, atol=1e-4, rtol=0)
    y = torch.nn.functional.pad(tgt.long(), (0, 1))
    b_pl, l_pl = rnnt_loss_plain.planes(torch.log_softmax(x, -1), y,
                                        ul.long(), blank)
    tape, rcum = rnnt_loss_cuda.alpha(b_pl, l_pl)
    p_tape, p_rcum = rnnt_loss_plain.alpha(b_pl, l_pl)
    assert torch.equal(rcum, p_rcum)
    torch.testing.assert_close(tape, p_tape, atol=1e-6, rtol=0)
    rest = (il.long(), ul.long(), *rnnt_loss_plain.log_z(
        b_pl, tape, rcum, il.long(), ul.long()))
    got = rnnt_loss_cuda.posteriors(b_pl, l_pl, tape, rcum, *rest)
    want = rnnt_loss_plain.posteriors(b_pl, l_pl, tape, rcum, *rest)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_rnnt_loss_reaches_the_kernels(dev):
    """rnnt_loss on CUDA float32 launches K8 once forward and K9 once
    backward, from logits, log-probs and planes; float64 does not."""
    x, tgt, il, ul = _rnnt_case(1, 3, 9, 4, 7, 0, dev)
    for kw in ({}, {"from_logits": False}):
        inp = x if kw == {} else torch.log_softmax(x, -1)
        before = dict(rnnt_loss_cuda.launches)
        xi = inp.detach().clone().requires_grad_(True)
        rnnt_loss(xi, tgt, il, ul, **kw).backward()
        assert rnnt_loss_cuda.launches == {k: c + 1
                                           for k, c in before.items()}
    before = dict(rnnt_loss_cuda.launches)
    rnnt_loss(x.double(), tgt, il, ul)
    assert rnnt_loss_cuda.launches == before
    with pytest.raises(ValueError, match="pallas"):
        rnnt_loss(x.double(), tgt, il, ul, implementation="pallas")
    with pytest.raises(ValueError, match="float32"):
        rnnt_loss_cuda.alpha(x[..., 0].double(), x[..., 1].double())


def test_transducer_defaults_to_the_card(dev):
    from end2end_tpu_torch import ConformerTransducer, TransducerConfig

    model = ConformerTransducer(TransducerConfig(
        vocab_size=8, n_mels=12, d_model=16, num_layers=1, num_heads=2,
        conv_kernel=7, enc_dim=16, emb_dim=6, pred_hidden=10, joint_dim=12))
    assert model.device.type == "cuda"
    feats = torch.randn(2, 37, 12, device=dev)
    lens = torch.tensor([37, 29], device=dev)
    before = dict(rnnt_loss_cuda.launches)
    model.loss(feats, lens, [[1, 2, 3], [4, 5, 0]], [3, 2]).backward()
    assert rnnt_loss_cuda.launches == {k: c + 1 for k, c in before.items()}
    tokens, lengths, scores = model.decode(feats, lens, max_symbols=8)
    assert tokens.shape == (2, 8) and torch.isfinite(scores).all()


def _joint_case(seed, r, j, v, blank, dev, y_hi=None):
    """An activation h (R, J), the joint's W, b, labels y (R,) in [0, y_hi)
    (y_hi = V by default; above it some labels are no column), the
    forward's statistics and random plane cotangents, on the card."""
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.standard_normal((r, j)))
    w = rng.standard_normal((j, v)) / np.sqrt(j)
    b = 0.1 * rng.standard_normal(v)
    y = rng.integers(0, y_hi or v, r).astype(np.int32)
    g = rng.random((2, r))
    h, w, b, y, gb, gl = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (h, w, b, y, g[0], g[1]))
    h, w, b, gb, gl = (x.float() for x in (h, w, b, gb, gl))
    m, logs = rnnt_joint_plain.joint_fwd(h, w, b, y, blank)[2:]
    return (h, w, b, y, blank), (m, logs, gb, gl)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


# (R, J, V, blank, y_hi): JAX's test problem (n=2, t=7, u=3), V=13 with
# blank=5, V=1100 with blank in the fifth tile and R not a multiple of 64,
# J not a multiple of 8 (the kernels' scalar h loads), J = 128, and J in
# 128-row slabs: two whole (256), two and a half (320), and a ragged 200;
# then R = 20,000 (K12 splits the rows over many blocks, the last row
# block ragged) at J = 128 and at J = 6 with the blank in the last column.
# K11's edges: R = 20,037 (not a multiple of its 128 rows) with V = 300
# (not a multiple of 128) and the blank in the last column at J = 8 and
# 128; labels past V (y_hi > V: no column) at J = 128 and 256; J = 640,
# the widest with K11's h tile resident (five slabs), and J = 776, where
# h streams with W (seven slabs, the last ragged).  y_hi None: labels in
# [0, V).
@pytest.mark.parametrize("r,j,v,blank,y_hi", [
    (56, 8, 11, 0, None), (56, 8, 13, 5, None), (1000, 16, 1100, 600, None),
    (300, 6, 257, 256, None), (130, 100, 40, 3, None),
    (200, 128, 300, 0, None), (300, 200, 300, 7, None),
    (1000, 256, 1100, 600, None), (130, 320, 257, 256, None),
    (20000, 128, 300, 0, None), (20000, 6, 257, 256, None),
    (20037, 128, 300, 299, None), (20037, 8, 300, 299, None),
    (20037, 128, 1100, 600, 1400), (1000, 256, 1100, 600, 1400),
    (130, 640, 257, 256, None), (300, 776, 257, 256, None)])
def test_joint_kernels_match_plain(dev, r, j, v, blank, y_hi):
    """K10, K11, K12 vs their plain twins on the card: the forward within
    1e-4; dh, dW and db within 1e-3 of each tensor's max (a last-bit
    difference of the float32 d can round it to a neighbouring bf16)."""
    args, stats = _joint_case(0, r, j, v, blank, dev, y_hi)
    before = dict(rnnt_joint_cuda.launches)
    got = rnnt_joint_cuda.joint_fwd(*args)
    want = rnnt_joint_plain.joint_fwd(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
    dh = rnnt_joint_cuda.joint_dh(*args, *stats)
    dw, db = rnnt_joint_cuda.joint_dw(*args, *stats)
    assert rnnt_joint_cuda.launches == {
        k: c + (not k.endswith("_tp")) for k, c in before.items()}
    assert _rel_err(dh, rnnt_joint_plain.joint_dh(*args, *stats)) < 1e-3
    p_dw, p_db = rnnt_joint_plain.joint_dw(*args, *stats)
    assert _rel_err(dw, p_dw) < 1e-3 and _rel_err(db, p_db) < 1e-3
    assert dh.shape == (r, j) and dw.shape == (j, v) and db.shape == (v,)


def _shard(args, rank, d=4):
    """Rank `rank`'s (h, w, b, y, blank) of d vocabulary shards."""
    h, w, b, y, blank = args
    vl = w.shape[1] // d
    lo = rank * vl
    yr = torch.where((y >= lo) & (y < lo + vl), y - lo, -1).int()
    return (h, w[:, lo:lo + vl].contiguous(), b[lo:lo + vl].contiguous(),
            yr.contiguous(), blank - lo if lo <= blank < lo + vl else -1)


@pytest.mark.parametrize("r,j,v,blank", [(56, 8, 16, 9),
                                          (1000, 16, 1100, 600),
                                          (20000, 16, 512, 300),
                                          (20037, 128, 1200, 1199)])
def test_joint_tp_kernels_match_plain(dev, r, j, v, blank):
    """K10tp, K11tp, K12tp vs their TP twins on the card, shard by shard
    (D=4; the blank on a middle shard, -1 on the others), to the tolerances
    of test_joint_kernels_match_plain; the shards combined equal K10-K12
    unsharded (planes, m and log s within 1e-5; the summed partial dh and
    the concatenated dW, db within 1e-3 of each tensor's max).  At V=512
    each shard is one 128-column tile, and K12tp splits R = 20,000 over
    many blocks.  At V=1200, J=128, the blank in the last column: three
    shards own no blank, each shard's 300 columns end in a ragged tile,
    and R = 20,037 ends in a ragged 128-row block of K11tp."""
    args, stats = _joint_case(4, r, j, v, blank, dev)
    fwd, dh, dw, db = [], 0.0, [], []
    for rank in range(4):
        shard = _shard(args, rank)
        before = dict(rnnt_joint_cuda.launches)
        got = rnnt_joint_cuda.joint_fwd_tp(*shard)
        for g, p in zip(got, rnnt_joint_plain.joint_fwd_tp(*shard)):
            torch.testing.assert_close(g, p, atol=1e-4, rtol=0)
        fwd.append(got)
        s_dh = rnnt_joint_cuda.joint_dh_tp(*shard, *stats)
        s_dw, s_db = rnnt_joint_cuda.joint_dw_tp(*shard, *stats)
        assert rnnt_joint_cuda.launches == {
            k: c + k.endswith("_tp") for k, c in before.items()}
        assert _rel_err(s_dh, rnnt_joint_plain.joint_dh_tp(*shard,
                                                          *stats)) < 1e-3
        p_dw, p_db = rnnt_joint_plain.joint_dw_tp(*shard, *stats)
        assert _rel_err(s_dw, p_dw) < 1e-3 and _rel_err(s_db, p_db) < 1e-3
        dh, dw, db = dh + s_dh, dw + [s_dw], db + [s_db]
    xb, xy, m_l, logs_l = (torch.stack(c) for c in zip(*fwd))
    m = m_l.amax(0)
    logs = torch.log(torch.exp(logs_l + (m_l - m)).sum(0))
    xb, xy = xb.sum(0), xy.sum(0)
    want = rnnt_joint_cuda.joint_fwd(*args)
    for g, p in zip(((xb - m) - logs, (xy - m) - logs, m, logs), want):
        torch.testing.assert_close(g, p, atol=1e-5, rtol=0)
    assert _rel_err(dh, rnnt_joint_cuda.joint_dh(*args, *stats)) < 1e-3
    u_dw, u_db = rnnt_joint_cuda.joint_dw(*args, *stats)
    assert _rel_err(torch.cat(dw, 1), u_dw) < 1e-3
    assert _rel_err(torch.cat(db), u_db) < 1e-3


@pytest.mark.parametrize("r,j,v,blank", [(20000, 128, 300, 0),
                                          (1000, 256, 1100, 600),
                                          (20000, 16, 512, 300)])
def test_joint_dw_is_deterministic(dev, r, j, v, blank):
    """K12 and K12tp (on each of 4 shards) twice on the same inputs: dW
    and db bit-equal (the row splits are summed in a fixed order)."""
    args, stats = _joint_case(6, r, j, v, blank, dev)
    for fn, inputs in [(rnnt_joint_cuda.joint_dw, args)] + [
            (rnnt_joint_cuda.joint_dw_tp, _shard(args, k)) for k in range(4)]:
        first, second = fn(*inputs, *stats), fn(*inputs, *stats)
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("r,j,v,blank", [(20037, 128, 1100, 600),
                                          (1000, 256, 1100, 600),
                                          (20037, 8, 512, 511)])
def test_joint_dh_is_deterministic(dev, r, j, v, blank):
    """K11 and K11tp (on each of 4 shards) twice on the same inputs: dh
    bit-equal (the sum over V stays in one block's registers, in tile
    order)."""
    args, stats = _joint_case(8, r, j, v, blank, dev)
    for fn, inputs in [(rnnt_joint_cuda.joint_dh, args)] + [
            (rnnt_joint_cuda.joint_dh_tp, _shard(args, k)) for k in range(4)]:
        assert torch.equal(fn(*inputs, *stats), fn(*inputs, *stats))


@pytest.mark.parametrize("top", [1099, 600])
def test_joint_fwd_late_max(dev, top):
    """K10 vs its plain twin where the row max comes late: a bias of scale
    30 and one column 20 above its largest (in the last, ragged tile, or in
    a middle one), so the running max of every row jumps after many tiles
    and the running sums are rescaled (the bench row's zero bias never
    does).  R = 20,037 ends in a ragged 128-row block; within 1e-4."""
    args, _ = _joint_case(10, 20037, 128, 1100, 600, dev)
    h, w, _, y, blank = args
    b = 30.0 * torch.from_numpy(
        np.random.default_rng(11).standard_normal(1100)).float().to(dev)
    second = float(b.max())
    b[top] = second + 20.0
    got = rnnt_joint_cuda.joint_fwd(h, w, b, y, blank)
    want = rnnt_joint_plain.joint_fwd(h, w, b, y, blank)
    assert bool((got[2] > second + 10.0).all())  # every row's max at `top`
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, atol=1e-4, rtol=0)


@pytest.mark.parametrize("r,j,v,blank", [(20037, 128, 1100, 600),
                                          (1000, 256, 1100, 600),
                                          (300, 776, 257, 256),
                                          (20037, 8, 512, 511)])
def test_joint_fwd_is_deterministic(dev, r, j, v, blank):
    """K10 and K10tp (on each of 4 shards) twice on the same inputs: every
    output bit-equal (each row's sums stay in its four threads' registers,
    in tile order, and combine in a fixed order)."""
    args, _ = _joint_case(12, r, j, v, blank, dev)
    for fn, inputs in [(rnnt_joint_cuda.joint_fwd, args)] + [
            (rnnt_joint_cuda.joint_fwd_tp, _shard(args, k)) for k in range(4)]:
        for a, c in zip(fn(*inputs), fn(*inputs)):
            assert torch.equal(a, c)


@pytest.mark.parametrize("j", [8, 128, 256, 640, 776])
def test_joint_fwd_plan(dev, j):
    """K10's resources on this card: no spilled bytes, at least one block
    per SM, at least two stages, h resident up to J = 640 and streamed
    with W above, and a grid of 256-row blocks up to J = 128, 128-row
    blocks above."""
    plan = rnnt_joint_cuda.fwd_plan(259200, j, dev)
    assert plan["spill_bytes"] == 0
    assert plan["blocks_per_sm"] >= 1 and plan["stages"] >= 2
    assert plan["h_streams"] == (j > 640)
    assert plan["blocks"] == (1013 if j <= 128 else 2025)


@pytest.mark.parametrize("j", [6, 8, 16, 32, 64, 128, 200, 256, 320, 640,
                               776, 1024])
def test_joint_dh_plan(dev, j):
    """K11's resources on this card: no spilled bytes, at least one block
    per SM, at least two stages, h resident up to J = 640 and streamed
    with W above, and a grid of 128-row blocks (x 128-column J slabs above
    J = 128)."""
    plan = rnnt_joint_cuda.dh_plan(259200, j, dev)
    assert plan["spill_bytes"] == 0
    assert plan["blocks_per_sm"] >= 1 and plan["stages"] >= 2
    assert plan["h_streams"] == (j > 640)
    assert plan["blocks"] == 2025 * (-(-j // 128) if j > 128 else 1)


@pytest.mark.parametrize("r,j,v", [(20000, 128, 300), (20000, 6, 257),
                                   (20000, 16, 128), (1000, 256, 1100),
                                   (259200, 128, 32768), (259200, 128, 8192)])
def test_joint_dw_plan_fills_the_card(dev, r, j, v):
    """K12's planner on this card: at least one block per SM resident and a
    grid of at least one full wave (S > 1 wherever the V tiles alone
    leave SMs idle)."""
    plan = rnnt_joint_cuda.dw_plan(r, j, v, dev)
    assert plan["blocks_per_sm"] >= 1
    assert plan["blocks"] >= plan["sms"] * plan["blocks_per_sm"]
    tiles = plan["blocks"] // plan["splits"]
    assert plan["splits"] > 1 or tiles >= plan["sms"] * plan["blocks_per_sm"]


@pytest.mark.parametrize("j", [16, 256])
def test_fused_pallas_reaches_the_kernels(dev, j):
    """rnnt_nll_fused_pallas on CUDA float32 launches K10 once forward and
    K11 and K12 once backward (K8 and K9 for the DP), and agrees with the
    same function on the CPU (its plain twins), J in one slab and in two."""
    rng = np.random.default_rng(5)
    n, t, u, v = 3, 9, 4, 70
    arrays = (rng.standard_normal((n, t, j)),
              rng.standard_normal((n, u + 1, j)),
              rng.standard_normal((j, v)) / np.sqrt(j),
              0.1 * rng.standard_normal(v))
    tgt = rng.integers(1, v, (n, u)).astype(np.int32)
    il, ul = np.array([9, 6, 9], np.int32), np.array([4, 2, 0], np.int32)
    out = {}
    for device in ("cpu", dev):
        xs = [torch.tensor(a, dtype=torch.float32, device=device,
                           requires_grad=True) for a in arrays]
        before = (dict(rnnt_joint_cuda.launches),
                  dict(rnnt_loss_cuda.launches))
        nll = rnnt_nll_fused_pallas(*xs, tgt, il, ul)
        nll.sum().backward()
        after = (dict(rnnt_joint_cuda.launches), dict(rnnt_loss_cuda.launches))
        step = int(device != "cpu")
        assert after == tuple({k: c + step * (not k.endswith("_tp"))
                               for k, c in d.items()} for d in before)
        out[str(device)] = [nll.detach().cpu()] + [x.grad.cpu() for x in xs]
    got, want = out[str(dev)], out["cpu"]
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert _rel_err(g, w) < 1e-3


def test_joint_kernels_reject_what_they_cannot_run(dev):
    args, stats = _joint_case(1, 40, 8, 20, 0, dev)
    h, w, b, y, blank = args
    with pytest.raises(ValueError, match="CUDA tensors"):
        rnnt_joint_cuda.joint_fwd(h.cpu(), w.cpu(), b.cpu(), y.cpu(), blank)
    with pytest.raises(ValueError, match="float32"):
        rnnt_joint_cuda.joint_fwd(h.double(), w, b, y, blank)
    with pytest.raises(ValueError, match="float32"):
        rnnt_joint_cuda.joint_dh(*args, stats[0].double(), *stats[1:])
    empty = torch.zeros((40, 0), device=dev)
    with pytest.raises(ValueError, match="J=0"):
        rnnt_joint_cuda.joint_fwd(empty, torch.zeros((0, 20), device=dev),
                                  b, y, blank)
    with pytest.raises(ValueError, match="blank=-1"):
        rnnt_joint_cuda.joint_fwd(h, w, b, y, -1)  # only a shard takes -1
    with pytest.raises(ValueError, match="contiguous"):
        rnnt_joint_cuda.joint_fwd(h.T.contiguous().T, w, b, y, blank)
    with pytest.raises(ValueError, match="blank"):
        rnnt_joint_cuda.joint_fwd(h, w, b, y, 20)

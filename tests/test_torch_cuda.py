"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test needs an NVIDIA GPU and nvcc, and skips without
them (the CPU tests cover the plain versions against the JAX package).  On
the GPU machine, which has no JAX for tests/conftest.py to import:
`python -m pytest --noconftest tests/test_torch_cuda.py -q`.
"""

import numpy as np
import pytest
import torch

from end2end_tpu_torch.ops import beam_search_cuda, ctc_loss_cuda, topk_cuda
from end2end_tpu_torch.ops.beam_search import beam_search_decode
from end2end_tpu_torch.ops.ctc_loss import ctc_nll

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


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
    # The kernels' outputs are bit-identical across the tape and checkpoint
    # modes; the gradient only to rounding, since the torch combine after
    # K2 (scatter_add_) adds duplicate labels with CUDA atomics.
    outs = {every: _kernel_outputs(lp, tgt, il, tl, dev, blank, every)
            for every in (0, 4, 64)}
    for every in (4, 64):
        assert torch.equal(got[every][0], loss)
        torch.testing.assert_close(got[every][1], grad, atol=1e-6, rtol=0)
        assert torch.equal(outs[every][0], outs[0][0])
        assert torch.equal(outs[every][1], outs[0][1])


def _kernel_outputs(lp, tgt, il, tl, dev, blank, every):
    """(z_hat, gamma) of K1 then K2."""
    args = [torch.tensor(a, device=dev) for a in (lp, tgt, il, tl)]
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(*args, blank, every)
    return z, ctc_loss_cuda.beta_cuda(*args, a, an, z, ne, blank, every)


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

"""The torch port's `beam_search_decode` against the JAX package's C++ host
decoder (`csrc/e2e_native.cpp` through `end2end_tpu.utils.native`), an
implementation of the reference's prefix beam search independent of both
packages (CPU).

No LM and with a dense bigram (the native decoder's KenLM-in-C++ role):
the beam sets must be equal and the scores within 1e-4 (no LM) or 1e-3
(with the LM: float32 sums in other orders, as the JAX package's own
native tests allow).  On `tests/test_prune_divergence.py`'s adversarial
lattices, where a beam's last symbol is pushed just below the top-K line,
the scan (which reads the repeat from the full row, as the native decoder
does) must give the native decoder's beams, and the kernel path (which
reads it from a K + 8 window) must stay within that test's bounds.
"""

import numpy as np
import pytest
import torch

from end2end_tpu.utils import native
from end2end_tpu_torch.ops.beam_search import beam_search_decode
from end2end_tpu_torch.ops.lm import NGramLM, bigram_from_counts

from .test_prune_divergence import _adversarial_lattice, _metrics

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the native C++ decoder did not build")

torch.set_num_threads(1)


def lsm(x):
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _sets(tokens, lens, scores):
    tokens, lens, scores = (np.asarray(x) for x in (tokens, lens, scores))
    return [{tuple(tokens[b, w, :int(lens[b, w])].tolist()):
             float(scores[b, w])
             for w in range(tokens.shape[1]) if np.isfinite(scores[b, w])}
            for b in range(tokens.shape[0])]


def _assert_same_beams(got, want, tol):
    for b, (g, w) in enumerate(zip(_sets(*got), _sets(*want))):
        assert set(g) == set(w), (b, set(g) ^ set(w))
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("W,prune_k", [(4, None), (8, None), (8, 7)])
def test_no_lm_matches_native(rng, impl, W, prune_k):
    B, T, V = 4, 30, 12
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    want = native.beam_search_cpu(lp, il, beam_width=W, prune_k=prune_k)
    got = beam_search_decode(torch.from_numpy(lp), torch.from_numpy(il),
                             beam_width=W, prune_k=prune_k,
                             implementation=impl)
    _assert_same_beams([x.numpy() for x in got], want, 1e-4)


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_dense_bigram_matches_native(rng, impl):
    """The in-kernel bigram (K5's plain twin under 'auto') and the scan's
    per-frame fusion against the native decoder's, start and
    end-of-sequence rows included."""
    B, T, V, W = 3, 16, 7, 6
    table = bigram_from_counts(rng.integers(0, 10, (V, V)))
    start = rng.standard_normal(V).astype(np.float32)
    eos = 0.5 * rng.standard_normal(V).astype(np.float32)
    lm = NGramLM(table, start_logp=start, eos_logp=eos, device="cpu")
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    want = native.beam_search_cpu(lp, il, beam_width=W,
                                  lm_table=lm._table.numpy(),
                                  lm_eos=lm._eos.numpy(), lm_alpha=0.8,
                                  lm_beta=0.3)
    got = beam_search_decode(torch.from_numpy(lp), torch.from_numpy(il),
                             beam_width=W, lm=lm, lm_alpha=0.8, lm_beta=0.3,
                             implementation=impl)
    _assert_same_beams([x.numpy() for x in got], want, 1e-3)


@pytest.mark.parametrize("W,K", [(4, 4), (8, 8), (8, 16), (16, 8)])
def test_adversarial_prune_grid_against_native(W, K):
    rng = np.random.default_rng(7)
    B, T, V = 8, 40, 24
    lp = _adversarial_lattice(rng, B, T, V, K)
    il = np.full(B, T, np.int32)
    nat = native.beam_search_cpu(lp, il, beam_width=W, prune_k=K)
    scan = beam_search_decode(torch.from_numpy(lp), beam_width=W, prune_k=K,
                              implementation="xla")
    _assert_same_beams([x.numpy() for x in scan], nat, 1e-4)
    kern = [x.numpy() for x in beam_search_decode(
        torch.from_numpy(lp), beam_width=W, prune_k=K)]
    top1, gap, jac = _metrics(*kern, *nat, W, B)
    assert top1 >= B - 1 and gap <= 0.3 and jac >= 0.9, (top1, gap, jac)
    exact = native.beam_search_cpu(lp, il, beam_width=W)
    top1_e, _, jac_e = _metrics(*kern, *exact, W, B)
    assert top1_e >= B - 3 and jac_e >= 0.4, (top1_e, jac_e)

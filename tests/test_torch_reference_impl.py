"""The port's copies of the float64 NumPy oracles
(`end2end_tpu_torch/utils/reference_impl.py`, `.../rnnt_reference.py`)
against the JAX package's: bit for bit on seeded problems, including the
infeasible, zero-length and nonzero-blank cases of
tests/test_reference_impl.py and tests/test_rnnt.py (CPU)."""

import numpy as np
import pytest

from end2end_tpu.utils import reference_impl as jref
from end2end_tpu.utils import rnnt_reference as jrnnt
from end2end_tpu_torch.utils import reference_impl as tref
from end2end_tpu_torch.utils import rnnt_reference as trnnt
from tests.conftest import random_ctc_problem


def assert_bits(got, want):
    """Equal arrays (or nested tuples/lists of them), inf included."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_bits(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert got == want or (got != got and want != want)


@pytest.mark.parametrize("B,T,S,V", [(4, 50, 20, 29), (3, 17, 5, 7),
                                     (2, 8, 3, 4)])
def test_ctc_loss_ref_bit_equal(rng, B, T, S, V):
    lp, tgt, il, tl = random_ctc_problem(rng, B, T, S, V, dtype=np.float64)
    assert_bits(tref.ctc_loss_ref(lp, tgt, il, tl),
                jref.ctc_loss_ref(lp, tgt, il, tl))


def test_ctc_loss_ref_repeated_and_nonzero_blank(rng):
    lp, _, il, tl = random_ctc_problem(rng, 2, 12, 4, 5, dtype=np.float64)
    tgt = np.array([[2, 2, 2, 2], [1, 1, 3, 3]], np.int32)
    tl = np.array([4, 4], np.int32)
    il = np.array([12, 10], np.int32)
    assert_bits(tref.ctc_loss_ref(lp, tgt, il, tl),
                jref.ctc_loss_ref(lp, tgt, il, tl))
    lp, tgt, il, tl = random_ctc_problem(rng, 3, 15, 5, 8, dtype=np.float64)
    tgt = np.where(tgt == 3, 1, tgt)
    assert_bits(tref.ctc_loss_ref(lp, tgt, il, tl, blank=3),
                jref.ctc_loss_ref(lp, tgt, il, tl, blank=3))


def test_ctc_loss_ref_infeasible_and_zero_length(rng):
    lp = np.log(np.full((4, 1, 5), 0.2))
    args = (lp, np.array([[1, 1, 1]], np.int32), np.array([4]),
            np.array([3]))
    got = tref.ctc_loss_ref(*args)
    assert np.isinf(got[0][0]) and np.all(np.isfinite(got[1]))
    assert_bits(got, jref.ctc_loss_ref(*args))
    lp, tgt, il, _ = random_ctc_problem(rng, 2, 10, 3, 6, dtype=np.float64)
    tl = np.array([0, 2], np.int32)
    assert_bits(tref.ctc_loss_ref(lp, tgt, il, tl),
                jref.ctc_loss_ref(lp, tgt, il, tl))


def test_greedy_decode_ref_equal(rng):
    lp, _, il, _ = random_ctc_problem(rng, 6, 40, 5, 9)
    for blank in (0, 4):
        assert (tref.greedy_decode_ref(lp, il, blank)
                == jref.greedy_decode_ref(lp, il, blank))


class _DictBigram:
    """A seeded bigram over V tokens with bos = V, eos = V + 1."""

    def __init__(self, rng, v):
        self.bos, self.eos = v, v + 1
        self.tab = rng.standard_normal((v + 1, v + 2))

    def score(self, context, w):
        return float(self.tab[context[-1], w])


@pytest.mark.parametrize("W,prune_k,blank", [(4, None, 0), (8, 3, 0),
                                             (4, None, 2)])
def test_beam_search_decode_ref_equal(rng, W, prune_k, blank):
    lp, _, _, _ = random_ctc_problem(rng, 3, 12, 4, 6, dtype=np.float64)
    il = np.array([12, 9, 5], np.int32)
    assert (tref.beam_search_decode_ref(lp, il, W, blank, prune_k)
            == jref.beam_search_decode_ref(lp, il, W, blank, prune_k))


def test_beam_search_decode_ref_with_lm_equal(rng):
    lp, _, _, _ = random_ctc_problem(rng, 2, 10, 4, 5, dtype=np.float64)
    il = np.array([10, 7], np.int32)
    lm = _DictBigram(np.random.default_rng(3), 5)
    kw = dict(beam_width=6, lm=lm, lm_alpha=0.7, lm_beta=0.2)
    assert (tref.beam_search_decode_ref(lp, il, **kw)
            == jref.beam_search_decode_ref(lp, il, **kw))


def _rnnt_problem(rng, n, t, u, v, blank=0):
    logits = rng.standard_normal((n, t, u + 1, v)) * 1.5
    labels = [c for c in range(v) if c != blank]
    y = rng.choice(labels, size=(n, u)).astype(np.int32)
    il = rng.integers(1, t + 1, n).astype(np.int32)
    ul = rng.integers(0, u + 1, n).astype(np.int32)
    il[0], ul[0] = t, u
    return logits, y, il, ul


@pytest.mark.parametrize("n,t,u,v,blank", [(3, 9, 5, 7, 0), (2, 4, 6, 5, 4),
                                           (2, 6, 0, 4, 0)])
def test_rnnt_refs_bit_equal(rng, n, t, u, v, blank):
    """U > T, an empty target (u = 0) and blank = V - 1 among the cases."""
    logits, y, il, ul = _rnnt_problem(rng, n, t, u, v, blank)
    assert_bits(trnnt.rnnt_logits_grad_ref(logits, y, il, ul, blank),
                jrnnt.rnnt_logits_grad_ref(logits, y, il, ul, blank))
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    assert_bits(trnnt.rnnt_loss_ref(lp, y, il, ul, blank),
                jrnnt.rnnt_loss_ref(lp, y, il, ul, blank))


def test_rnnt_loss_paths_bit_equal(rng):
    logits, y, _, _ = _rnnt_problem(rng, 1, 4, 3, 5)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    got = trnnt.rnnt_loss_paths(lp[0], y[0])
    assert got == jrnnt.rnnt_loss_paths(lp[0], y[0])
    np.testing.assert_allclose(
        got, trnnt.rnnt_loss_ref(lp, y, [4], [3])[0][0], rtol=1e-12)


def test_oracles_import_only_numpy():
    import ast
    import pathlib

    for mod in (tref, trnnt):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        names = {a.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names}
        names |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert names <= {"numpy", "itertools", "__future__"}, names

"""Top-k of the torch port (ops/topk_cuda.py) against the JAX package.

The same numpy inputs go through `topk_plain` (what a CPU tensor runs),
the Pallas kernel in interpret mode and `jax.lax.top_k`.  Values must be
bit-equal; indices equal wherever the value is finite (the Pallas kernel
repeats one index among exact -inf ties, by its contract).
"""

import jax
import numpy as np
import pytest
import torch

from end2end_tpu.ops.topk_pallas import topk_pallas
from end2end_tpu_torch.ops import topk_cuda
from end2end_tpu_torch.ops.topk_cuda import topk, topk_plain

torch.set_num_threads(1)


def _check(x, k):
    vals, idx = (t.numpy() for t in topk_plain(torch.from_numpy(x), k))
    assert idx.dtype == np.int32
    for ref_v, ref_i in (topk_pallas(x, k, interpret=True),
                         jax.lax.top_k(x, k)):
        ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
        np.testing.assert_array_equal(vals, ref_v)
        fin = np.isfinite(vals)
        np.testing.assert_array_equal(idx[fin], ref_i[fin])


@pytest.mark.parametrize("T,B,V,k", [(3, 2, 5, 5), (4, 3, 40, 8),
                                     (2, 2, 300, 24), (5, 1, 16, 1)])
def test_topk_plain_matches_jax(rng, T, B, V, k):
    _check(rng.standard_normal((T, B, V)).astype(np.float32), k)


def test_topk_plain_ties_take_smaller_index(rng):
    x = rng.integers(0, 4, (6, 3, 50)).astype(np.float32)  # many ties
    _check(x, 20)
    _check(x, 50)


def test_topk_plain_neg_inf_rows(rng):
    x = rng.standard_normal((4, 3, 30)).astype(np.float32)
    x[0, 0, :] = -np.inf  # an all -inf row
    x[1, :, ::2] = -np.inf  # half the vocabulary masked
    x[2, 1, 5:] = -np.inf  # fewer finite entries than k
    _check(x, 12)
    # among -inf ties the indices are distinct and ascending
    vals, idx = topk_plain(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(idx[0, 0].numpy(), np.arange(12))


def test_topk_dispatch_on_cpu_runs_plain(rng):
    x = torch.from_numpy(rng.standard_normal((3, 2, 20)).astype(np.float32))
    before = topk_cuda.launches
    for a, b in zip(topk(x, 7), topk_plain(x, 7)):
        assert torch.equal(a, b)
    assert topk_cuda.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        topk_cuda.topk_cuda(x, 7)


def _rows(rng, v):
    """The card tests' rows (tests/test_torch_cuda.py::_topk_rows): normal
    values, all equal, few distinct values (ties across lanes), runs of
    -inf, an all -inf row, and a +inf."""
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
def test_topk_plain_matches_lax_top_k_at_each_width(rng, v):
    """The oracle of the card's K3 tests, pinned to jax.lax.top_k at every
    width those tests use, k = 1, a middle k and k = V: values bit-equal,
    indices equal where finite, and -inf ties by distinct ascending
    index."""
    x = _rows(rng, v)
    for k in sorted({1, min(24, v), v}):
        vals, idx = (t.numpy() for t in topk_plain(torch.from_numpy(x), k))
        ref_v, ref_i = (np.asarray(a) for a in jax.lax.top_k(x, k))
        np.testing.assert_array_equal(vals, ref_v)
        fin = np.isfinite(vals)
        np.testing.assert_array_equal(idx[fin], ref_i[fin])
        for row_v, row_i in zip(vals, idx):
            ninf = row_i[row_v == -np.inf]
            assert (np.diff(ninf) > 0).all()
        assert (idx[5] == np.arange(k)).all()  # the all -inf row

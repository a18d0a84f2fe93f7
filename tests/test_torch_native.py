"""The port's C++ host runtime (`end2end_tpu_torch/utils/native.py`, built
from its own copy `end2end_tpu_torch/csrc/host/e2e_native.cpp`) against the
JAX package's loader of the same source (`end2end_tpu.utils.native`): the
five functions bit for bit on tests/test_native.py's cases, CPU tensors as
well as numpy arrays; and the port's ARPA loaders with `prefer_native`
True and False (CPU; skips without g++)."""

import filecmp
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from end2end_tpu.ops.lm import NGramLM as JaxNGramLM
from end2end_tpu.utils import native as jnative
from end2end_tpu_torch.ops.lm import NGramLM, bigram_from_counts
from end2end_tpu_torch.utils import arpa, native

from .test_native import ARPA

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is missing: no host runtime")

ROOT = Path(__file__).resolve().parent.parent

ORDER_ARPA = (
    "\\data\\\nngram 1=6\nngram 2=4\nngram 3=3\nngram 4=1\n\n\\1-grams:\n"
    "-1.9 <unk>\n-0.3 <s> -0.2\n-0.9 </s>\n"
    "-0.5 a -0.25\n-0.5 b -0.2\n-0.9 c\n\n"
    "\\2-grams:\n-0.4 <s> a -0.1\n-0.4 a b -0.1\n-0.5 b b\n-0.9 b c -0.05\n\n"
    "\\3-grams:\n-0.05 a b c -0.01\n-0.1 b b a\n-0.2 a b </s>\n\n"
    "\\4-grams:\n-0.15 <s> a b c\n\n\\end\\\n"
)


def lsm(x):
    return x - np.log(np.sum(np.exp(x), axis=-1, keepdims=True))


def assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=True)


def test_source_is_the_jax_packages_copy():
    from end2end_tpu_torch.utils import cuda_build

    assert filecmp.cmp(ROOT / "csrc" / "e2e_native.cpp", native.SOURCE,
                       shallow=False)
    assert native.available() and jnative.available()
    # csrc/host/ keeps the host runtime out of the nvcc build's csrc/*.cu
    assert all(src.suffix == ".cu" and src.parent == cuda_build.CSRC
               for src in cuda_build._sources())


def test_greedy_bit_equal(rng):
    B, T, V = 6, 50, 29
    lp = lsm(rng.standard_normal((T, B, V))).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    want = jnative.greedy_decode_cpu(lp, il)
    assert_bits(native.greedy_decode_cpu(lp, il), want)
    assert_bits(native.greedy_decode_cpu(torch.from_numpy(lp),
                                         torch.from_numpy(il)), want)
    assert_bits(native.greedy_decode_cpu(lp, il, blank=3),
                jnative.greedy_decode_cpu(lp, il, blank=3))


@pytest.mark.parametrize("W,threads,prune_k", [(4, 1, None), (8, 4, None),
                                               (8, 2, 3)])
def test_beam_bit_equal(rng, W, threads, prune_k):
    B, T, V = 4, 15, 6
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = np.array([15, 11, 8, 15], np.int32)
    kw = dict(beam_width=W, n_threads=threads, prune_k=prune_k)
    want = jnative.beam_search_cpu(lp, il, **kw)
    assert_bits(native.beam_search_cpu(lp, il, **kw), want)
    assert_bits(native.beam_search_cpu(torch.from_numpy(lp),
                                       torch.from_numpy(il), **kw), want)


def test_beam_with_dense_bigram_bit_equal(rng):
    B, T, V, W = 3, 12, 6, 6
    table = bigram_from_counts(rng.integers(0, 10, (V, V)))
    start = rng.standard_normal(V).astype(np.float32)
    eos = rng.standard_normal(V).astype(np.float32) * 0.5
    lm = NGramLM(table, start_logp=start, eos_logp=eos, device="cpu")
    jlm = JaxNGramLM(np.asarray(table), start_logp=start, eos_logp=eos)
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    kw = dict(beam_width=W, lm_alpha=0.8, lm_beta=0.3)
    want = jnative.beam_search_cpu(lp, il, lm_table=np.asarray(jlm._table),
                                   lm_eos=np.asarray(jlm._eos), **kw)
    # the port's NGramLM table is JAX's layout
    assert_bits(native.beam_search_cpu(lp, il, lm_table=lm._table,
                                       lm_eos=lm._eos, **kw), want)
    with pytest.raises(ValueError, match="lm_table"):
        native.beam_search_cpu(lp, il, lm_table=lm._table[:-1], **kw)


def _write(tmp_path, text):
    path = tmp_path / "lm.arpa"
    path.write_text(text)
    return str(path)


def test_parse_arpa_native_bit_equal(tmp_path):
    path = _write(tmp_path, ARPA)
    vocab = ["a", "b", "c", "d"]
    assert_bits(native.parse_arpa_native(path, vocab),
                jnative.parse_arpa_native(path, vocab))
    with pytest.raises(FileNotFoundError):
        native.parse_arpa_native(str(tmp_path / "missing.arpa"), vocab)


def test_parse_arpa_order_native_equal(tmp_path):
    path = _write(tmp_path, ORDER_ARPA)
    vocab = ["a", "b", "c"]
    got = native.parse_arpa_order_native(path, vocab)
    assert got == jnative.parse_arpa_order_native(path, vocab)
    assert got[0] == 4


def test_load_arpa_prefer_native_true_and_false(tmp_path):
    path = _write(tmp_path, ARPA)
    vocab = ["a", "b", "c", "d"]
    nat = arpa.load_arpa(path, vocab, prefer_native=True)
    py = arpa.load_arpa(path, vocab, prefer_native=False)
    assert_bits(nat, native.parse_arpa_native(path, vocab))
    assert_bits(py, arpa.parse_arpa_python(path, vocab))
    for a, b in zip(nat, py):  # tests/test_native.py's tolerance
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    lm = arpa.ngram_lm_from_arpa(path, vocab, device="cpu")
    np.testing.assert_array_equal(lm._table[:-1].numpy(), nat[1])


def test_parse_arpa_order_prefer_native_true_and_false(tmp_path):
    path = _write(tmp_path, ORDER_ARPA)
    vocab = ["a", "b", "c"]
    o_nat, ng_nat = arpa.parse_arpa_order(path, vocab, prefer_native=True)
    o_py, ng_py = arpa.parse_arpa_order(path, vocab, prefer_native=False)
    assert (o_nat, ng_nat) == native.parse_arpa_order_native(path, vocab)
    assert o_nat == o_py == 4
    np.testing.assert_allclose(ng_nat["unk"], ng_py["unk"], rtol=1e-6)
    for k in range(1, 5):
        a, b = sorted(ng_py[k]), sorted(ng_nat[k])
        assert [x[0] for x in a] == [x[0] for x in b], k
        for (_, la, ba), (_, lb, bb) in zip(a, b):
            np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(ba, bb, rtol=1e-5, atol=1e-6)


def test_build_is_named_by_source_and_flags(tmp_path):
    path = native.build(tmp_path)
    assert Path(path).parent == tmp_path
    assert Path(path).name.startswith("libe2e_native_")
    assert native.build(tmp_path) == path  # found, not rebuilt


def test_bigram_lines_with_backoffs_are_read(tmp_path):
    """In a file of order 3 and above a bigram line carries a backoff
    weight.  The port's Python parser reads it, as both native parsers do;
    the JAX package's Python parser skips it (pinned: its bigram and start
    tables back off where the file has the bigram)."""
    from end2end_tpu.utils.arpa import parse_arpa_python as jax_python

    path = _write(tmp_path, ORDER_ARPA)
    vocab = ["a", "b", "c"]
    py = arpa.load_arpa(path, vocab, prefer_native=False)
    nat = arpa.load_arpa(path, vocab, prefer_native=True)
    for a, b in zip(nat, py):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    ln10 = np.log(10.0)
    np.testing.assert_allclose(py[1][0, 1], -0.4 * ln10, rtol=1e-6)  # a b
    np.testing.assert_allclose(py[2][0], -0.4 * ln10, rtol=1e-6)  # <s> a
    jax_py = jax_python(path, vocab)
    np.testing.assert_allclose(jax_py[1][0, 1], (-0.25 - 0.5) * ln10,
                               rtol=1e-6)  # bo(a) + p(b)
    assert_bits(jnative.parse_arpa_native(path, vocab),
                native.parse_arpa_native(path, vocab))

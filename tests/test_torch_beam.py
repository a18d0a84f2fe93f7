"""Prefix beam search of the torch port (ops/beam_search.py, the plain
versions a CPU tensor runs) against the JAX package.

References: the Pallas beam kernel in interpret mode (`beam_search_pallas`,
the semantics the port keeps at every prune_k) and, at prune_k = V, the XLA
scan (`implementation='xla'`).  Beam sets (prefix -> score) must be equal
with scores within 5e-4, the tolerance of the JAX package's own
kernel-vs-scan tests.  The port's own scan (configurations outside the
kernel's envelope, and 'xla') against JAX's: the same ranked tokens,
lengths and frames, scores within 1e-5 (float32) or 1e-9 (float64).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from end2end_tpu.ops.beam_search import BeamSearchCTCDecoder as JaxDecoder
from end2end_tpu.ops.beam_search import beam_search_decode as jax_beam
from end2end_tpu.ops.beam_search_pallas import beam_search_pallas
from end2end_tpu_torch.ops import beam_search_cuda
from end2end_tpu_torch.ops.beam_search import (
    BeamSearchCTCDecoder,
    beam_search_decode,
)
from end2end_tpu_torch.tools import beam_step_breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import patched
from end2end_tpu_torch.utils import cuda_build

torch.set_num_threads(1)

ATOL = 5e-4


def lsm(x):
    x = np.asarray(x, np.float64)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _beam_sets(tokens, lens, scores):
    tokens, lens, scores = (np.asarray(x) for x in (tokens, lens, scores))
    return [{tuple(tokens[b, w, : int(lens[b, w])].tolist()):
             float(scores[b, w])
             for w in range(tokens.shape[1]) if np.isfinite(scores[b, w])}
            for b in range(tokens.shape[0])]


def _port(lp, il=None, **kw):
    il = None if il is None else torch.from_numpy(il)
    out = beam_search_decode(torch.from_numpy(lp), il, **kw)
    return tuple(x.numpy() for x in out)


def _assert_same_sets(got, want):
    for b, (g, w) in enumerate(zip(_beam_sets(*got[:3]),
                                   _beam_sets(*want[:3]))):
        assert set(g) == set(w), (b, set(g) ^ set(w))
        for pref in g:
            np.testing.assert_allclose(g[pref], w[pref], atol=ATOL, rtol=0)


def _peaked(rng, T, B, V):
    lp = np.full((T, B, V), np.log(0.003 / (V - 1)))
    ids = np.where(rng.random((T, B)) < 0.5, 0, rng.integers(1, V, (T, B)))
    for t in range(T):
        lp[t, np.arange(B), ids[t]] = np.log(0.997)
    return lsm(lp).astype(np.float32)


@pytest.mark.parametrize("B,T,V,W", [(2, 12, 6, 4), (3, 40, 8, 8),
                                     (2, 25, 40, 8)])
def test_beam_full_vocab_matches_kernel_and_scan(rng, B, T, V, W):
    lp = lsm(rng.standard_normal((T, B, V)) * 1.5).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    il[0] = T
    got = _port(lp, il, beam_width=W)
    _assert_same_sets(got, beam_search_pallas(lp, il, beam_width=W,
                                              interpret=True))
    _assert_same_sets(got, jax_beam(lp, il, beam_width=W,
                                    implementation="xla"))


def test_beam_repeats_and_cap():
    path = [1, 1, 0, 1, 1, 2, 2, 0, 2]
    lp = np.full((9, 1, 4), -12.0)
    for t, c in enumerate(path):
        lp[t, 0, c] = -0.01
    lp = lsm(lp).astype(np.float32)
    tok, lens, _ = _port(lp, beam_width=4)
    assert tok[0, 0, : lens[0, 0]].tolist() == [1, 1, 2, 2]
    _assert_same_sets(_port(lp, beam_width=4),
                      jax_beam(lp, beam_width=4, implementation="xla"))
    got = _port(lp, beam_width=4, max_symbols=2)
    assert got[1].max() <= 2 and got[0].shape == (1, 4, 2)
    _assert_same_sets(got, beam_search_pallas(lp, beam_width=4,
                                              max_symbols=2, interpret=True))


@pytest.mark.parametrize("K", [1, 8])
def test_beam_pruned_matches_kernel_and_top1_scan(rng, K):
    B, T, V, W = 3, 30, 20, 8
    lp = _peaked(rng, T, B, V)
    il = np.array([30, 25, 20], np.int32)
    got = _port(lp, il, beam_width=W, prune_k=K)
    _assert_same_sets(got, beam_search_pallas(lp, il, beam_width=W,
                                              prune_k=K, interpret=True))
    xt, xl, _ = (np.asarray(x) for x in jax_beam(
        lp, il, beam_width=W, prune_k=K, implementation="xla"))
    for b in range(B):
        assert (got[0][b, 0, : got[1][b, 0]].tolist()
                == xt[b, 0, : xl[b, 0]].tolist())


def test_beam_timestamps_match_kernel(rng):
    B, T, V, W = 2, 20, 7, 4
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([20, 14], np.int32)
    got = _port(lp, il, beam_width=W, return_timestamps=True)
    want = [np.asarray(x) for x in beam_search_pallas(
        lp, il, beam_width=W, return_timestamps=True, interpret=True)]
    assert len(got) == 4
    for b in range(B):
        for w in range(W):
            if np.isfinite(got[2][b, w]):
                n = got[1][b, w]
                assert got[0][b, w, :n].tolist() == want[0][b, w, :n].tolist()
                assert got[3][b, w, :n].tolist() == want[3][b, w, :n].tolist()
                assert (np.diff(got[3][b, w, :n]) > 0).all()


def test_beam_dead_beams_and_token_min_logp(rng):
    # W > finite candidates early on: dead beams must score -inf, as in JAX
    lp = lsm(rng.standard_normal((3, 2, 3))).astype(np.float32)
    got = _port(lp, beam_width=8)
    want = [np.asarray(x) for x in beam_search_pallas(lp, beam_width=8,
                                                      interpret=True)]
    np.testing.assert_array_equal(np.isfinite(got[2]), np.isfinite(want[2]))
    _assert_same_sets(got, want)
    lp = lsm(rng.standard_normal((15, 2, 12)) * 2.0).astype(np.float32)
    _assert_same_sets(
        _port(lp, beam_width=4, prune_k=6, token_min_logp=-2.5),
        beam_search_pallas(lp, beam_width=4, prune_k=6, token_min_logp=-2.5,
                           interpret=True))


def test_beam_decoder_class_matches_jax(rng):
    B, T, V = 3, 16, 5
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([16, 11, 6], np.int32)
    labels = "_abcd"
    texts, scores = BeamSearchCTCDecoder(beam_width=4, labels=labels).decode(
        torch.from_numpy(lp), il)
    want_t, want_s = JaxDecoder(beam_width=4, labels=labels,
                                implementation="xla").decode(lp, il)
    assert texts == want_t
    np.testing.assert_allclose(scores, want_s, atol=ATOL)
    beams = BeamSearchCTCDecoder(beam_width=4).decode_beams(
        torch.from_numpy(lp), il, return_timestamps=True)
    beams_bf = BeamSearchCTCDecoder(beam_width=4, batch_first=True)
    assert beams_bf.decode_beams(np.swapaxes(lp, 0, 1), il,
                                 return_timestamps=True) == beams


def test_beam_envelope_and_unported_options(rng):
    lp = torch.from_numpy(lsm(rng.standard_normal((5, 1, 6))).astype(
        np.float32))
    # outside the kernel's envelope 'pallas' raises ('auto' runs the scan)
    for x, kw in ((torch.zeros(4, 1, 200), {"beam_width": 33}),
                  (torch.zeros(4, 1, 200), {"prune_k": 129}),
                  (lp.double(), {})):
        with pytest.raises(ValueError, match="'pallas' unsupported"):
            beam_search_decode(x, implementation="pallas", **kw)
        assert beam_search_decode(x, **kw)[0].shape[0] == 1
    # approx_topk is accepted and the top-k stays exact (JAX's approximate
    # top-k is exact off the TPU); an object without the LM protocol raises
    for a, b in zip(beam_search_decode(lp, approx_topk=True),
                    beam_search_decode(lp)):
        assert torch.equal(a, b)
    with pytest.raises(AttributeError):
        beam_search_decode(lp, lm=object())
    with pytest.raises(ValueError, match="implementation"):
        beam_search_decode(lp, implementation="scan")
    with pytest.raises(ValueError, match="CUDA"):
        beam_search_cuda.beam_step_cuda(
            torch.zeros(5, 1, 6), torch.zeros(5, 1, 6, dtype=torch.int32),
            torch.zeros(5, 1), torch.full((1,), 5, dtype=torch.int32),
            4, 6, 5, 0)
    # max_symbols defaults to min(T, 512)
    long = torch.full((600, 1, 3), -1.0986123)
    assert beam_search_decode(long, beam_width=2)[0].shape == (1, 2, 512)
    # a half-precision lattice is decoded in float32
    full = beam_search_decode(lp, beam_width=4)
    half = beam_search_decode(lp.to(torch.bfloat16), beam_width=4)
    assert half[2].dtype == torch.float32 and full[0].shape == half[0].shape


def test_prefix_hash_wraps_like_int32(rng):
    h = rng.integers(-2**31, 2**31, 1000).astype(np.int32)
    c = rng.integers(0, 5000, 1000).astype(np.int32)
    with np.errstate(over="ignore"):
        for m in (beam_search_cuda._M1, beam_search_cuda._M2):
            want = h * np.uint32(m).astype(np.int32) + (c + 1)
            got = beam_search_cuda._wrap32(
                torch.from_numpy(h).long() * m + torch.from_numpy(c).long()
                + 1)
            np.testing.assert_array_equal(got.numpy(), want)


def _port_np(lp, il, **kw):
    out = beam_search_decode(torch.from_numpy(lp), torch.from_numpy(il),
                             **kw)
    return tuple(x.numpy() for x in out)


def _assert_scan_equal(got, want, tol):
    """The same ranked tokens, lengths (and frames), the same beam sets,
    scores within tol."""
    want = tuple(np.asarray(x) for x in want)
    _assert_same_sets(got, want)
    for a, b in zip(_beam_sets(*got[:3]), _beam_sets(*want[:3])):
        for pref in a:
            np.testing.assert_allclose(a[pref], b[pref], atol=tol, rtol=0)
    assert got[2].dtype == want[2].dtype
    np.testing.assert_array_equal(np.isfinite(got[2]), np.isfinite(want[2]))
    for x, y in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["V=200, default prune_k",
                                  "W=40, prune_k=16", "token_min_logp",
                                  "'xla' inside the envelope"])
def test_scan_matches_jax_scan(rng, case, caplog):
    """Configurations outside the kernel's envelope run the prefix-beam
    scan under 'auto' (and say so in the log), 'xla' runs it everywhere:
    each against JAX's scan on the same lattice."""
    B, T = 3, 18
    kw = {"return_timestamps": True}
    V = 200 if case.startswith("V=200") else 30
    if case.startswith("W=40"):
        kw.update(beam_width=40, prune_k=16)
    if case == "token_min_logp":
        kw.update(beam_width=6, prune_k=12, token_min_logp=-3.0,
                  implementation="xla")
    if case.startswith("'xla'"):
        kw.update(beam_width=8, prune_k=10, implementation="xla")
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([18, 13, 7], np.int32)
    with caplog.at_level(logging.INFO):
        got = _port_np(lp, il, **kw)
    scan_logged = "prefix-beam scan" in caplog.text
    assert scan_logged == (case in ("V=200, default prune_k",
                                    "W=40, prune_k=16"))
    jkw = dict(kw, implementation="xla")
    _assert_scan_equal(got, jax_beam(lp, il, **jkw), 1e-5)


def test_scan_float64_matches_jax_scan(rng):
    """A float64 lattice stays float64 through the scan, as in JAX."""
    B, T, V = 3, 16, 12
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0)
    il = np.array([16, 10, 5], np.int32)
    got = _port_np(lp, il, beam_width=6, return_timestamps=True)
    assert got[2].dtype == np.float64
    with jax.enable_x64(True):
        want = jax_beam(lp, il, beam_width=6, return_timestamps=True,
                        implementation="xla")
        _assert_scan_equal(got, want, 1e-9)


def test_scan_decoder_class_matches_jax(rng):
    """BeamSearchCTCDecoder takes the same routes: W = 40 runs the scan."""
    B, T, V = 3, 16, 6
    lp = lsm(rng.standard_normal((T, B, V)) * 2.0).astype(np.float32)
    il = np.array([16, 11, 6], np.int32)
    labels = "_abcde"
    for impl in ("auto", "xla"):
        dec = BeamSearchCTCDecoder(beam_width=40, labels=labels,
                                   implementation=impl)
        texts, scores = dec.decode(torch.from_numpy(lp), il)
        want_t, want_s = JaxDecoder(beam_width=40, labels=labels,
                                    implementation="xla").decode(lp, il)
        assert texts == want_t
        np.testing.assert_allclose(scores, want_s, atol=1e-5, rtol=0)
        beams = dec.decode_beams(torch.from_numpy(lp), il,
                                 return_timestamps=True)
        want = JaxDecoder(beam_width=40, labels=labels,
                          implementation="xla").decode_beams(
            lp, il, return_timestamps=True)
        assert [[(b[0], b[2]) for b in x] for x in beams] == [
            [(b[0], b[2]) for b in x] for x in want]


def test_plain_beam_step_dead_picks_repick_the_smallest_code():
    """The rule the kernel's extra reduction keeps: once no candidate
    above log-zero is left, every later round picks the smallest code
    among the picks (which left the pool at log-zero) and the candidates
    at exactly log-zero.  One frame from the empty prefix, W = 6: live are
    the extension by token 1 (code 6), the stay of beam 0 (code 0) and the
    extension by token 2 (code 8); the blank's extension (code 7) and
    beams 1-5 (codes 1-5, 9-17) are at log-zero; so code 0 again."""
    lp = torch.log(torch.tensor([[[0.3, 0.6, 0.1]]]))
    lpk, ck = torch.sort(lp, dim=-1, descending=True, stable=True)
    bp, score, last, state = beam_search_cuda.beam_step_plain(
        lpk, ck.to(torch.int32), lp[:, :, 0], torch.tensor([1]), 6, 3, 4, 0)
    assert bp[0, :, 0].tolist() == [6, 0, 8, 0, 0, 0]
    assert last[:, 0].tolist() == [1, -1, 2, -1, -1, -1]
    assert (score[3:, 0] == -1e30).all() and (state[0][3:, 0] == -1e30).all()


def _key(x):
    u = np.float32(0.0 if x == 0 else x).view(np.uint32).item()
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _sorted_lanes(x):
    """The warp's bitonic sort of one value a lane, largest in lane 0, as
    csrc/beam_step.cu's `warp_sort_desc` exchanges them."""
    x, k = list(x), 2
    while k <= 32:
        j = k >> 1
        while j:
            x = [max(x[i], x[i ^ j]) if ((i & j) == 0) == ((i & k) == 0)
                 else min(x[i], x[i ^ j]) for i in range(32)]
            j >>= 1
        k <<= 1
    return x


def _top_w_by_keys(cand, W):
    """csrc/beam_step.cu's top-W in Python.  Each candidate is a composite
    (order-preserving key above the complement of its code); the stay of
    beam w sits on lane w, the extensions spread over the lanes (how does
    not change the picks; here code c on lane c % 32).  The lanes'
    heads are sorted across the warp; tau is the W-th.  With W live heads
    and no lane holding two candidates >= tau the sorted heads are the
    picks; else, if at most 32 candidates are >= tau, their sort is.
    Otherwise W rounds of a max over the lanes' heads, then one reduction
    over the composites with their keys clamped to log-zero's."""
    k0 = _key(-1e30)
    comps = [(_key(v) << 32) | (~c & 0xFFFFFFFF) for c, v in enumerate(cand)]
    own = [[comps[lane]] if lane < W else [] for lane in range(32)]
    for c in range(W, len(cand)):
        own[c % 32].append(comps[c])
    heads = _sorted_lanes([max(o, default=0) for o in own])
    tau = heads[W - 1]
    if tau >> 32 > k0:
        above = [[c for c in o if c >= tau] for o in own]
        if max(len(a) for a in above) <= 1:
            return [~c & 0xFFFFFFFF for c in heads[:W]]
        flat = [c for a in above for c in a]
        if len(flat) <= 32:
            picks = _sorted_lanes(flat + [0] * (32 - len(flat)))[:W]
            return [~c & 0xFFFFFFFF for c in picks]
    own = [sorted(o, reverse=True) for o in own]
    clamp = lambda c: (k0 << 32) | (c & 0xFFFFFFFF) if c >> 32 > k0 else c
    codes = []
    while len(codes) < W:
        best = max(o[0] if o else 0 for o in own)
        if best >> 32 <= k0:  # the rest: one code, at log-zero
            d = max(clamp(c) for c in comps)
            return codes + [~d & 0xFFFFFFFF] * (W - len(codes))
        next(o for o in own if o and o[0] == best).pop(0)
        codes.append(~best & 0xFFFFFFFF)
    return codes


def test_key_selection_matches_argmax_rounds(rng):
    """The kernel's selection reproduces the plain twin's W rounds of
    argmax (first index among equal maxima, a pick leaving as log-zero)
    on candidates with ties, +-0.0, log-zero, -inf, values below log-zero
    and fewer live candidates than W."""
    for it in range(400):
        W = int(rng.integers(1, 33))
        x = rng.standard_normal(W + int(rng.integers(0, 150)))
        kind = it % 5
        if kind == 1:
            x = np.round(x)
        if kind >= 2:
            x[rng.random(x.size) < rng.random()] = -1e30
        if kind == 3:
            x[rng.random(x.size) < 0.3] = -np.inf
        if kind == 4:
            x[rng.random(x.size) < 0.3] = -2e30
        zero = rng.random(x.size) < 0.2
        x[zero] = np.where(rng.random(zero.sum()) < 0.5, -0.0, 0.0)
        cand = torch.from_numpy(x.astype(np.float32))
        want = []
        for _ in range(W):
            c = int(cand.argmax())
            want.append(c)
            cand[c] = -1e30
        assert _top_w_by_keys(x.astype(np.float32).tolist(), W) == want


@pytest.mark.parametrize("name", list(beam_step_breakdown.PARENT))
def test_beam_breakdown_parent_patches_apply(name):
    """Each of the breakdown tool's patches finds its text exactly once in
    tools/beam_step_reference.cu, so the variants it times exist."""
    src = beam_step_breakdown.REFERENCE.read_text()
    assert patched(src, beam_step_breakdown.PARENT[name]) != src


@pytest.mark.parametrize("name", list(beam_step_breakdown.NEW) + ["probe"])
def test_beam_breakdown_kernel_patches_apply(name):
    """The same for the kernel's variants and its clock probe in
    csrc/beam_step.cu."""
    src = (cuda_build.CSRC / "beam_step.cu").read_text()
    patches = (beam_step_breakdown.PROBE if name == "probe"
               else beam_step_breakdown.NEW[name])
    assert patched(src, patches) != src


def test_beam_breakdown_problems():
    """The tool's problems: the serving slice's lengths, bench.py's
    beam-16 row, the chunks resumed from the empty prefix; K5's table
    has V + 1 rows, K6's 64 and a class map."""
    shapes = {}
    for name in beam_step_breakdown.PROBLEMS:
        args, kw = beam_step_breakdown.problem(name, "cpu")
        shapes[name] = (tuple(args[0].shape), args[4:6], sorted(kw))
        assert args[1].dtype == torch.int32 and args[3].dtype == torch.int32
    assert shapes["main K4"] == ((750, 8, 24), (8, 16), [])
    assert shapes["main K5"][2] == ["inc"]
    assert shapes["beam16 K4"] == ((1000, 32, 40), (16, 32), [])
    assert shapes["chunk K6"] == ((128, 32, 16), (8, 16),
                                  ["cls_map", "inc", "state_in"])
    assert shapes["chunk K7"][2] == ["state_in"]
    args, kw = beam_step_breakdown.problem("main K5", "cpu")
    assert args[3].tolist() == [750, 550, 375, 750, 550, 375, 550, 375]
    assert kw["inc"].shape == (33, 32)

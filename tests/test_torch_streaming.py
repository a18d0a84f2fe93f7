"""Streaming decoders and long-form transcription: the port's four
streaming decoders stepped over chunkings of 1 frame, 7 frames and the
whole input against the port's one-shot decodes and the JAX package's
streaming decoders (CPU, the same seeded inputs); `finish()` mid-stream
is pure, a state survives `torch.save`/`torch.load`, an empty sample and
global timestamps come through; the long-form transcribers against the
port's stitched `transcribe_long_form` and JAX's.

Tolerances: tokens, lengths and times equal everywhere.  Scores: against
the port's one-shot decode 1e-5 (the same float32 terms; a chunked sum
or a capped beam's blank tail adds them in another order), against JAX's
rtol 1e-5, atol 1e-4 (tests/test_torch_rnnt_beam.py's), the long-form
paths 5e-4 (tests/test_torch_pipeline.py's).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import end2end_tpu.ops.streaming_decode as jsd
from end2end_tpu.models import streaming as jstream
from end2end_tpu.models.transducer import ConformerTransducer as JaxModel
from end2end_tpu.models.transducer import TransducerConfig as JaxConfig
from end2end_tpu_torch import (ConformerCTCPipeline, ConformerTransducer,
                               PipelineConfig, StreamingBeamDecoder,
                               StreamingGreedyDecoder,
                               StreamingRNNTBeamDecoder,
                               StreamingRNNTGreedyDecoder,
                               TransducerConfig, beam_search_decode,
                               greedy_decode, rnnt_beam_decode,
                               rnnt_greedy_decode)
from end2end_tpu_torch.models import streaming as tstream
from tests.test_torch_rnnt_beam import (_bigram_pair, assert_decodes_equal,
                                        problem)

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

CHUNKINGS = [1, 7, None]  # frames a chunk; None: the whole input at once


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _cuts(t, size):
    return list(range(0, t, size or t)) + [t]


def _close(got, want, tol=1e-5):
    """Port against port: tokens, lengths (and times) equal, scores to
    float32 sum order."""
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=tol)
        else:
            assert torch.equal(g, w), i


def _run(dec, state, chunks, finish_kw=None, probe=None):
    """Step `dec` through `chunks` [(chunk, lengths)]; `probe(i, state)`
    runs after step i."""
    for i, (x, cl) in enumerate(chunks):
        state = dec.step(state, x, cl)
        if probe is not None:
            probe(i, state)
    return state


# --------------------------------------------------------------------------
# CTC
# --------------------------------------------------------------------------

def _lattice(seed, t=20, n=3, v=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, n, v)) * 1.5
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    il = np.array([t, t - 6, 0], np.int32)
    return lp, il


def _ctc_chunks(lp, il, size):
    cuts = _cuts(lp.shape[0], size)
    return [(lp[a:b], np.clip(il - a, 0, b - a).astype(np.int32))
            for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("size", CHUNKINGS)
def test_ctc_greedy_streaming(size):
    lp, il = _lattice(0)
    chunks = _ctc_chunks(lp, il, size)
    dec = StreamingGreedyDecoder(max_symbols=20)
    st = _run(dec, dec.init(3, device="cpu"),
              [(torch.from_numpy(x), c) for x, c in chunks])
    got = dec.finish(st)
    _close(got, greedy_decode(torch.from_numpy(lp), il))
    jdec = jsd.StreamingGreedyDecoder(max_symbols=20)
    jst = jdec.init(3)
    for x, c in chunks:
        jst = jdec.step(jst, x, c)
    assert_decodes_equal(got, jdec.finish(jst))


def test_ctc_greedy_streaming_collapses_across_the_chunk_edge():
    path = [1, 1, 0, 2, 2, 2, 2, 0, 2, 3]
    lp = np.full((len(path), 1, 5), -12.0, np.float32)
    lp[np.arange(len(path)), 0, path] = -0.01
    dec = StreamingGreedyDecoder(max_symbols=16)
    st = dec.init(1, device="cpu")
    for a, b in ((0, 5), (5, 10)):  # splits the run of 2s
        st = dec.step(st, torch.from_numpy(lp[a:b]))
    toks, lens, _ = dec.finish(st)
    assert toks[0, :lens[0]].tolist() == [1, 2, 2, 3]


def _ctc_beam_case(with_lm):
    lp, il = _lattice(1, t=16, v=6)
    lms = _bigram_pair(6, 5) if with_lm else (None, None)
    kw = dict(beam_width=4, prune_k=5, max_symbols=12, lm_alpha=0.6,
              lm_beta=0.3)
    return lp, il, lms[0], lms[1], kw


@pytest.mark.parametrize("with_lm", [False, True])
@pytest.mark.parametrize("size", CHUNKINGS)
def test_ctc_beam_streaming(size, with_lm):
    """Against the one-shot prefix-beam scan and JAX's streaming decoder,
    timestamps global; an LM rides the carried state."""
    lp, il, jl, tl, kw = _ctc_beam_case(with_lm)
    chunks = _ctc_chunks(lp, il, size)
    dec = StreamingBeamDecoder(lm=tl, **kw)
    st = _run(dec, dec.init(3, device="cpu"),
              [(torch.from_numpy(x), c) for x, c in chunks])
    got = dec.finish(st, return_timestamps=True)
    want = beam_search_decode(torch.from_numpy(lp), il, lm=tl,
                              implementation="xla", return_timestamps=True,
                              **kw)
    _close(got, want)
    jdec = jsd.StreamingBeamDecoder(lm=jl, **kw)
    jst = jdec.init(3)
    for x, c in chunks:
        jst = jdec.step(jst, x, c)
    jwant = jdec.finish(jst, return_timestamps=True)
    live = np.isfinite(np.asarray(jwant[2]))
    for g, w in zip(got, jwant):  # dead beams: -inf scores, any tokens
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g[live], w[live], rtol=1e-5,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(g[live], w[live])
    assert (got[3][0, 0, :got[1][0, 0]] >= 7).any()  # past the first chunk


def test_ctc_beam_finish_is_pure_and_the_state_round_trips():
    lp, il, _, tl, kw = _ctc_beam_case(True)
    chunks = [(torch.from_numpy(x), c) for x, c in _ctc_chunks(lp, il, 7)]
    dec = StreamingBeamDecoder(lm=tl, **kw)
    want = dec.finish(_run(dec, dec.init(3, device="cpu"), chunks))
    mid = []

    def probe(i, st):
        mid.append(dec.finish(st))
        buf = io.BytesIO()
        torch.save(st, buf)
        buf.seek(0)
        mid.append(torch.load(buf))

    st = _run(dec, dec.init(3, device="cpu"), chunks[:1], probe=probe)
    _close(dec.finish(_run(dec, st, chunks[1:])), want)
    _close(dec.finish(_run(dec, mid[1], chunks[1:])), want)
    # the partial result is the decode of the frames so far
    _close(mid[0], beam_search_decode(
        chunks[0][0], chunks[0][1], lm=tl, implementation="xla", **kw))


# --------------------------------------------------------------------------
# Transducer
# --------------------------------------------------------------------------

def _rnnt_chunks(enc, il, size):
    cuts = _cuts(enc.shape[1], size)
    return [(enc[:, a:b], np.clip(il - a, 0, b - a).astype(np.int32))
            for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("lookahead", [1, 4])
@pytest.mark.parametrize("size", CHUNKINGS)
def test_rnnt_greedy_streaming(size, lookahead):
    enc, jf, tf = problem(5, n=3, t=18, v=7, blank_bias=1.0, factored=True)
    il = np.array([18, 11, 0], np.int32)
    kw = dict(max_symbols=6, lookahead=lookahead)
    chunks = _rnnt_chunks(enc, il, size)
    dec = StreamingRNNTGreedyDecoder(*tf, **kw)
    st = _run(dec, dec.init(3),
              [(torch.from_numpy(x), c) for x, c in chunks])
    got = dec.finish(st, return_timestamps=True)
    _close(got, rnnt_greedy_decode(torch.from_numpy(enc), il, *tf,
                                   return_timestamps=True, **kw))
    jdec = jsd.StreamingRNNTGreedyDecoder(*jf, **kw)
    jst = jdec.init(3)
    for x, c in chunks:
        jst = jdec.step(jst, x, c)
    assert_decodes_equal(got, jdec.finish(jst, return_timestamps=True))


def _rnnt_beam_case(with_lm):
    enc, jf, tf = problem(13, n=3, t=14, v=6, blank_bias=0.8)
    il = np.array([14, 11, 0], np.int32)
    lms = _bigram_pair(6, 2) if with_lm else (None, None)
    kw = dict(beam_width=4, prune_k=4, max_symbols=5, lm_alpha=0.5,
              lm_beta=0.2)
    return enc, il, jf, tf, lms[0], lms[1], kw


@pytest.mark.parametrize("with_lm", [False, True])
@pytest.mark.parametrize("size", CHUNKINGS)
def test_rnnt_beam_streaming(size, with_lm):
    enc, il, jf, tf, jl, tl, kw = _rnnt_beam_case(with_lm)
    chunks = _rnnt_chunks(enc, il, size)
    dec = StreamingRNNTBeamDecoder(*tf, lm=tl, **kw)
    st = _run(dec, dec.init(3, enc.shape[2]),
              [(torch.from_numpy(x), c) for x, c in chunks])
    got = dec.finish(st, return_timestamps=True)
    _close(got, rnnt_beam_decode(torch.from_numpy(enc), il, *tf, lm=tl,
                                 return_timestamps=True, **kw))
    jdec = jsd.StreamingRNNTBeamDecoder(*jf, lm=jl, **kw)
    jst = jdec.init(3, enc.shape[2])
    for x, c in chunks:
        jst = jdec.step(jst, jnp.asarray(x), c)
    assert_decodes_equal(got, jdec.finish(jst, return_timestamps=True))


def test_rnnt_beam_streaming_with_lookahead():
    enc, il, _, tf, _, _, kw = _rnnt_beam_case(False)
    chunks = [(torch.from_numpy(x), c) for x, c in _rnnt_chunks(enc, il, 5)]
    want = None
    for lookahead in (1, 4):
        dec = StreamingRNNTBeamDecoder(*tf, lookahead=lookahead, **kw)
        got = dec.finish(_run(dec, dec.init(3, enc.shape[2]), chunks),
                         return_timestamps=True)
        if want is not None:
            _close(got, want)
        want = got


def test_rnnt_finish_is_pure_and_the_state_round_trips():
    """finish() mid-stream changes nothing that follows; a state saved
    and loaded mid-stream resumes to the same result (greedy and beam)."""
    enc, il, _, tf, _, tl, kw = _rnnt_beam_case(True)
    chunks = [(torch.from_numpy(x), c) for x, c in _rnnt_chunks(enc, il, 4)]
    for dec, state0 in (
            (StreamingRNNTBeamDecoder(*tf, lm=tl, **kw),
             lambda d: d.init(3, enc.shape[2])),
            (StreamingRNNTGreedyDecoder(*tf, max_symbols=5),
             lambda d: d.init(3))):
        want = dec.finish(_run(dec, state0(dec), chunks))
        saved = []

        def probe(i, st):
            dec.finish(st)
            buf = io.BytesIO()
            torch.save(st, buf)
            buf.seek(0)
            saved.append(torch.load(buf))

        st = _run(dec, state0(dec), chunks[:2], probe=probe)
        _close(dec.finish(_run(dec, st, chunks[2:])), want)
        _close(dec.finish(_run(dec, saved[1], chunks[2:])), want)


# --------------------------------------------------------------------------
# Long form
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    jpipe = graft._tiny_pipeline()
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((3, 4000)).astype(np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)
    params = jax.device_get(jpipe.init(jax.random.key(0), wav, ns))
    tpipe = ConformerCTCPipeline(PipelineConfig(
        vocab_size=16, d_model=64, num_layers=2, num_heads=2, n_mels=16),
        device="cpu")
    tpipe.load_flax_params(params)
    return jpipe, params, tpipe


@pytest.mark.parametrize("beam", [0, 4])
def test_long_form_streaming(pipes, beam):
    """The streaming transcriber equals the stitched one and JAX's
    streaming one; partial results arrive once a chunk."""
    jpipe, params, tpipe = pipes
    long = np.random.default_rng(2).standard_normal(
        int(16000 * 1.2)).astype(np.float32)
    partials = []
    got = tstream.transcribe_long_form_streaming(
        tpipe, long, 0.5, 0.05, beam_width=beam,
        partial_cb=lambda t, n, i: partials.append((list(t), n, i)))
    stitched = tstream.transcribe_long_form(tpipe, long, 0.5, 0.05,
                                            beam_width=beam)
    want = jstream.transcribe_long_form_streaming(jpipe, params, long, 0.5,
                                                  0.05, beam_width=beam)
    for ref in (stitched, want):
        assert got[1] == ref[1]
        assert (got[0][: got[1]].tolist()
                == np.asarray(ref[0])[: ref[1]].tolist())
        np.testing.assert_allclose(got[2], ref[2], atol=5e-4, rtol=0)
    assert [p[2] for p in partials] == [0, 1, 2]
    assert partials[-1][:2] == (got[0][: got[1]].tolist(), got[1])


KW = dict(vocab_size=8, n_mels=12, d_model=16, num_layers=1, num_heads=2,
          conv_kernel=7, enc_dim=16, emb_dim=6, pred_hidden=10, joint_dim=12)


@pytest.fixture(scope="module")
def transducers():
    rng = np.random.default_rng(0)
    jmodel = JaxModel(JaxConfig(**KW))
    feats = rng.standard_normal((130, KW["n_mels"])).astype(np.float32)
    params = jmodel.init(jax.random.key(0), feats[None, :40],
                         np.array([40], np.int32))
    tmodel = ConformerTransducer(TransducerConfig(**KW), device="cpu")
    tmodel.load_jax_params(jax.device_get(params))
    return jmodel, params, tmodel, feats


@pytest.mark.parametrize("beam", [0, 3])
def test_long_form_rnnt_matches_jax(transducers, beam):
    jmodel, params, tmodel, feats = transducers
    kw = dict(chunk_frames=48, overlap_frames=8, beam_width=beam,
              max_symbols=20)
    partials = []
    got = tstream.transcribe_long_form_rnnt(
        tmodel, feats, partial_cb=lambda t, n, i: partials.append(i), **kw)
    want = jstream.transcribe_long_form_rnnt(jmodel, params, feats, **kw)
    assert got[1] == want[1] and got[1] > 0
    assert got[0][: got[1]].tolist() == np.asarray(want[0])[: want[1]].tolist()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=5e-4)
    assert partials == [0, 1, 2, 3]


@pytest.mark.parametrize("beam", [0, 3])
def test_long_form_rnnt_is_the_one_shot_decode_of_the_stitch(transducers,
                                                              beam):
    """The long form equals the one-shot decode of its chunks' trimmed
    encoder outputs stitched along time (the check chip_smoke makes on the
    card at full width)."""
    _, _, tmodel, feats = transducers
    got = tstream.transcribe_long_form_rnnt(
        tmodel, feats, chunk_frames=48, overlap_frames=8, beam_width=beam,
        max_symbols=20)
    stitch = torch.cat(list(tstream._rnnt_encoded_chunks(tmodel, feats, 48,
                                                         8)), 1)
    fns = tmodel.decoder_fns()
    if beam:
        toks, lens, scores = (x[:, 0] for x in rnnt_beam_decode(
            stitch, None, *fns, beam_width=beam, max_symbols=20))
    else:
        toks, lens, scores = rnnt_greedy_decode(stitch, None, *fns,
                                                max_symbols=20)
    assert got[1] == int(lens[0]) > 0
    assert got[0][: got[1]].tolist() == toks[0, : got[1]].tolist()
    np.testing.assert_allclose(got[2], float(scores[0]), rtol=0, atol=1e-5)

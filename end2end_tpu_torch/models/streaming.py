"""Long-form audio: chunked encoding with one stitched CTC decode, or with
the decoder streamed chunk by chunk (torch port of
`end2end_tpu/models/streaming.py`).

Stitched (`transcribe_long_form`):
  1. split the waveform into fixed-size overlapping chunks,
  2. encode all chunks as one batch,
  3. trim half the overlap from each side, in encoder frames, and
     concatenate the log-probs along time,
  4. decode the stitched lattice once (greedy or beam).

Streamed (`transcribe_long_form_streaming`, and for the transducer
`transcribe_long_form_rnnt`): encode each chunk as it arrives and advance
a streaming decoder (ops/streaming_decode.py) on its trimmed frames, so
latency is one chunk.  Both CTC paths cut the same trimmed slices
(`_chunk_plan`), and the streaming decoders equal their one-shot decodes,
so the two give the same transcript.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.beam_search import beam_search_decode
from ..ops.greedy import greedy_decode
from ..ops.streaming_decode import (StreamingBeamDecoder,
                                    StreamingGreedyDecoder,
                                    StreamingRNNTBeamDecoder,
                                    StreamingRNNTGreedyDecoder)
from .conformer import ConvSubsampling
from .frontend import num_frames


def chunk_waveform(waveform, chunk_samples: int, overlap_samples: int):
    """(num_samples,) -> (n_chunks, chunk_samples) numpy float32 with the
    given overlap, the tail zero-padded; also the valid sample counts."""
    waveform = np.asarray(waveform, np.float32).reshape(-1)
    hop = chunk_samples - overlap_samples
    if hop <= 0:
        raise ValueError("overlap must be smaller than the chunk")
    n = max(1, int(np.ceil(max(len(waveform) - overlap_samples, 1) / hop)))
    chunks = np.zeros((n, chunk_samples), np.float32)
    valid = np.zeros(n, np.int32)
    for i in range(n):
        piece = waveform[i * hop: i * hop + chunk_samples]
        chunks[i, : len(piece)] = piece
        valid[i] = len(piece)
    return chunks, valid


def _chunk_plan(pipe, waveform, chunk_seconds, overlap_seconds):
    """The chunks, their valid sample counts and the encoder frames to trim
    at each inner edge (lo_trim at a chunk's start, hi_trim at its end),
    shared by both CTC transcribers so they decode the same slices."""
    c = pipe.config
    chunk_samples = int(chunk_seconds * c.sample_rate)
    overlap_samples = int(overlap_seconds * c.sample_rate)
    chunks, valid = chunk_waveform(waveform, chunk_samples, overlap_samples)
    ov_frames = int(ConvSubsampling.out_length(
        num_frames(overlap_samples, c.n_fft, c.hop_length)))
    return chunks, valid, ov_frames // 2, ov_frames - ov_frames // 2


def _trim(i, n, out_len, lo_trim, hi_trim):
    """The kept frames [lo, hi) of chunk i of n."""
    lo = lo_trim if i > 0 else 0
    return lo, max(int(out_len) - (hi_trim if i < n - 1 else 0), lo)


def _best(out, beam_width):
    """(tokens, length, score) of the best hypothesis of sample 0."""
    toks, lens, scores = out
    if beam_width == 0:
        return toks[0], int(lens[0]), float(scores[0])
    return toks[0, 0], int(lens[0, 0]), float(scores[0, 0])


def _partial(dec, state, beam_width, partial_cb, i):
    if partial_cb is not None:
        toks, blen, _ = _best(dec.finish(state), beam_width)
        partial_cb(toks[:blen].cpu().numpy(), blen, i)


@torch.no_grad()
def transcribe_long_form(pipe, waveform, chunk_seconds: float = 10.0,
                         overlap_seconds: float = 1.0, beam_width: int = 0,
                         blank: int = 0, **beam_kwargs):
    """Transcribe one long waveform with a ConformerCTCPipeline.

    Returns (tokens, length, score) of the stitched utterance (beam: the
    best hypothesis); tokens is a 1-D int32 tensor, -1 padded.
    """
    chunks, valid, lo_trim, hi_trim = _chunk_plan(
        pipe, waveform, chunk_seconds, overlap_seconds)
    n = chunks.shape[0]
    logits, out_len = pipe.encode(chunks, valid)
    log_probs = torch.log_softmax(logits, dim=-1)
    pieces = []
    for i in range(n):
        lo, hi = _trim(i, n, out_len[i], lo_trim, hi_trim)
        pieces.append(log_probs[i, lo:hi])
    lattice = torch.cat(pieces, dim=0)[:, None, :]  # (T_total, 1, V)
    t_total = torch.tensor([lattice.shape[0]], dtype=torch.int32)
    if beam_width == 0:
        return _best(greedy_decode(lattice, t_total, blank=blank), 0)
    return _best(beam_search_decode(lattice, t_total, beam_width=beam_width,
                                    blank=blank, **beam_kwargs), beam_width)


@torch.no_grad()
def transcribe_long_form_streaming(pipe, waveform,
                                   chunk_seconds: float = 10.0,
                                   overlap_seconds: float = 1.0,
                                   beam_width: int = 0, blank: int = 0,
                                   max_symbols: int = 512, partial_cb=None,
                                   **beam_kwargs):
    """Bounded-latency long-form transcription: encode each chunk as it
    arrives and advance the streaming decoder on its trimmed frames.

    The same transcript as `transcribe_long_form` (the same trimmed
    slices; the streaming decoders equal the one-shot greedy decode and
    prefix-beam scan).  After each chunk, `partial_cb(tokens, length,
    chunk_index)` gets the best hypothesis so far (the pure mid-stream
    `finish()`; tokens a numpy array).  Returns (tokens, length, score).
    """
    chunks, valid, lo_trim, hi_trim = _chunk_plan(
        pipe, waveform, chunk_seconds, overlap_seconds)
    n = chunks.shape[0]
    if beam_width == 0:
        dec = StreamingGreedyDecoder(blank=blank, max_symbols=max_symbols)
    else:
        dec = StreamingBeamDecoder(beam_width=beam_width, blank=blank,
                                   max_symbols=max_symbols, **beam_kwargs)
    state = dec.init(1, device=pipe.device)
    for i in range(n):
        logits, out_len = pipe.encode(chunks[i: i + 1], valid[i: i + 1])
        lo, hi = _trim(i, n, out_len[0], lo_trim, hi_trim)
        if hi > lo:
            piece = torch.log_softmax(logits, dim=-1)[:, lo:hi].transpose(
                0, 1)  # (Tc, 1, V)
            state = dec.step(state, piece, torch.tensor(
                [hi - lo], dtype=torch.int32, device=piece.device))
        _partial(dec, state, beam_width, partial_cb, i)
    return _best(dec.finish(state), beam_width)


@torch.no_grad()
def transcribe_long_form_rnnt(model, feats, chunk_frames: int = 400,
                              overlap_frames: int = 32,
                              beam_width: int = 0, max_symbols: int = 512,
                              partial_cb=None, lm=None,
                              lm_alpha: float = 0.0, lm_beta: float = 0.0,
                              prune_k=None):
    """Bounded-latency long-form transducer transcription.

    Split the features (T_f, F) into overlapping chunks of `chunk_frames`
    (the tail zero-padded), encode each through the `ConformerTransducer`
    as it arrives, trim half the overlap in encoder frames and advance the
    streaming greedy (beam_width 0) or ALSD decoder on the rest.  The
    result is the one-shot decode of the stitched trimmed encoder output.
    `partial_cb(tokens, length, chunk_index)` gets the best hypothesis so
    far after each chunk.  Returns (tokens, length, score).
    """
    pred, init_h, joint = model.decoder_fns()
    if beam_width == 0:
        dec = StreamingRNNTGreedyDecoder(pred, init_h, joint,
                                         max_symbols=max_symbols)
        state = dec.init(1)
    else:
        dec = StreamingRNNTBeamDecoder(
            pred, init_h, joint, beam_width=beam_width, prune_k=prune_k,
            max_symbols=max_symbols, lm=lm, lm_alpha=lm_alpha,
            lm_beta=lm_beta)
        state = dec.init(1, model.config.enc_dim)
    pieces = _rnnt_encoded_chunks(model, feats, chunk_frames,
                                  overlap_frames)
    for i, piece in enumerate(pieces):
        if piece.shape[1]:
            state = dec.step(state, piece, torch.tensor(
                [piece.shape[1]], dtype=torch.int32, device=piece.device))
        _partial(dec, state, beam_width, partial_cb, i)
    return _best(dec.finish(state), beam_width)


@torch.no_grad()
def _rnnt_encoded_chunks(model, feats, chunk_frames: int = 400,
                         overlap_frames: int = 32):
    """`transcribe_long_form_rnnt`'s encoder pass, a chunk at a time:
    yields each chunk's trimmed encoder output (1, T_i, enc_dim), possibly
    empty.  Concatenated along time they are the stitched encoder output
    that the long form's transcript is the one-shot decode of."""
    feats = np.asarray(feats, np.float32)
    if feats.ndim != 2:
        raise ValueError(f"feats must be (T_f, F), got {feats.shape}")
    hop = chunk_frames - overlap_frames
    if hop <= 0:
        raise ValueError("overlap must be smaller than the chunk")
    t_f = feats.shape[0]
    n = max(1, int(np.ceil(max(t_f - overlap_frames, 1) / hop)))
    ov_out = (int(ConvSubsampling.out_length(overlap_frames))
              if model.config.subsample else overlap_frames)
    lo_trim, hi_trim = ov_out // 2, ov_out - ov_out // 2
    for i in range(n):
        piece = feats[i * hop: i * hop + chunk_frames]
        valid = piece.shape[0]
        if valid < chunk_frames:
            piece = np.pad(piece, ((0, chunk_frames - valid), (0, 0)))
        enc, out_len = model.encode(piece[None], np.array([valid], np.int32))
        lo, hi = _trim(i, n, out_len[0], lo_trim, hi_trim)
        yield enc[:, lo:hi]

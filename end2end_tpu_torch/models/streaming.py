"""Long-form audio by chunked encoding and one stitched CTC decode (torch
port of `transcribe_long_form` in `end2end_tpu/models/streaming.py`).

  1. split the waveform into fixed-size overlapping chunks,
  2. encode all chunks as one batch,
  3. trim half the overlap from each side, in encoder frames, and
     concatenate the log-probs along time,
  4. decode the stitched lattice once (greedy or beam).

The bounded-latency streaming variant needs the CTC streaming decoders
(ROADMAP.md queue 1 item 5) and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.beam_search import beam_search_decode
from ..ops.greedy import greedy_decode
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


@torch.no_grad()
def transcribe_long_form(pipe, waveform, chunk_seconds: float = 10.0,
                         overlap_seconds: float = 1.0, beam_width: int = 0,
                         blank: int = 0, **beam_kwargs):
    """Transcribe one long waveform with a ConformerCTCPipeline.

    Returns (tokens, length, score) of the stitched utterance (beam: the
    best hypothesis); tokens is a 1-D int32 tensor, -1 padded.
    """
    c = pipe.config
    chunk_samples = int(chunk_seconds * c.sample_rate)
    overlap_samples = int(overlap_seconds * c.sample_rate)
    chunks, valid = chunk_waveform(waveform, chunk_samples, overlap_samples)
    ov_frames = int(ConvSubsampling.out_length(
        num_frames(overlap_samples, c.n_fft, c.hop_length)))
    lo_trim = ov_frames // 2
    hi_trim = ov_frames - lo_trim
    n = chunks.shape[0]

    logits, out_len = pipe.encode(chunks, valid)
    log_probs = torch.log_softmax(logits, dim=-1)
    pieces = []
    for i in range(n):
        lo = lo_trim if i > 0 else 0
        hi = int(out_len[i]) - (hi_trim if i < n - 1 else 0)
        pieces.append(log_probs[i, lo:max(hi, lo)])
    lattice = torch.cat(pieces, dim=0)[:, None, :]  # (T_total, 1, V)
    t_total = torch.tensor([lattice.shape[0]], dtype=torch.int32)

    if beam_width == 0:
        toks, lens, scores = greedy_decode(lattice, t_total, blank=blank)
        return toks[0], int(lens[0]), float(scores[0])
    toks, lens, scores = beam_search_decode(
        lattice, t_total, beam_width=beam_width, blank=blank, **beam_kwargs)
    return toks[0, 0], int(lens[0, 0]), float(scores[0, 0])

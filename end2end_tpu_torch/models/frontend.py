"""Log-mel audio frontend (torch port of `end2end_tpu/models/frontend.py`).

Frames without centring (`frames = 1 + max(0, n - n_fft) // hop`), a
symmetric Hann window (numpy's `hanning`), `torch.fft.rfft`, the power
spectrum, one matmul with an HTK-mel triangular filterbank and a floored
log.  Plain torch throughout: the JAX package leaves this to XLA too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.profiling import span


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular filterbank, numpy float32 (read-only:
    the cached array is shared by every caller)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb.setflags(write=False)
    return fb


def log_mel_spectrogram(waveform, sample_rate: int = 16000, n_fft: int = 400,
                        hop_length: int = 160, n_mels: int = 80,
                        fmin: float = 0.0, fmax: float | None = None,
                        eps: float = 1e-10) -> torch.Tensor:
    """(N, num_samples) float32 -> (N, frames, n_mels) log-mel features,
    frames = 1 + max(0, num_samples - n_fft) // hop_length."""
    with span("frontend"):
        waveform = torch.as_tensor(waveform, dtype=torch.float32)
        if waveform.ndim == 1:
            waveform = waveform[None, :]
        dev = waveform.device
        num_samples = waveform.shape[1]
        frames = 1 + max(0, num_samples - n_fft) // hop_length
        idx = (torch.arange(frames, device=dev)[:, None] * hop_length
               + torch.arange(n_fft, device=dev)[None, :])
        # a clip shorter than one window reads its last sample again (the
        # JAX package's gather clamps out-of-range indices the same way)
        framed = waveform[:, idx.clamp(max=num_samples - 1)]
        window = torch.hann_window(n_fft, periodic=False,
                                   dtype=torch.float32, device=dev)
        spec = torch.fft.rfft(framed * window, dim=-1)
        power = spec.real.square() + spec.imag.square()
        fb = torch.from_numpy(mel_filterbank(
            n_mels, n_fft, sample_rate, fmin,
            fmax or sample_rate / 2.0).copy())
        mel = power @ fb.to(dev)
        return torch.log(torch.clamp(mel, min=eps))


def num_frames(num_samples, n_fft: int = 400, hop_length: int = 160):
    """Sample counts -> frame counts (tensor in, tensor out)."""
    num_samples = torch.as_tensor(num_samples)
    return 1 + torch.clamp(num_samples - n_fft, min=0) // hop_length

"""Log-mel features, from their definition: frames of `n_fft` samples every
`hop` samples with no centring, a symmetric Hann window, the power
spectrum, an HTK-mel triangular filterbank from 0 Hz to Nyquist, and the
log floored at 1e-10.  Clips are at least `n_fft` samples long."""

from __future__ import annotations

import math

import numpy as np
import torch


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) float32 triangles, equally spaced on the
    HTK mel scale m = 2595 log10(1 + f / 700)."""
    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    top = 2595.0 * math.log10(1.0 + sample_rate / 2.0 / 700.0)
    hz = 700.0 * (10.0 ** (np.linspace(0.0, top, n_mels + 2) / 2595.0) - 1.0)
    lo, mid, hi = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    rise = (bins[None] - lo) / np.maximum(mid - lo, 1e-10)
    fall = (hi - bins[None]) / np.maximum(hi - mid, 1e-10)
    return np.clip(np.minimum(rise, fall), 0.0, None).T.astype(np.float32)


def num_frames(num_samples, n_fft: int, hop: int) -> torch.Tensor:
    n = torch.as_tensor(num_samples).long()
    return 1 + torch.clamp(n - n_fft, min=0) // hop


def log_mel(wave: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """(N, samples) float32 -> (N, frames, n_mels)."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    frames = wave.unfold(-1, n_fft, hop)
    k = torch.arange(n_fft, dtype=torch.float64, device=wave.device)
    hann = (0.5 - 0.5 * torch.cos(2 * math.pi * k / (n_fft - 1))).float()
    spec = torch.fft.rfft(frames * hann, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(cfg["n_mels"], n_fft,
                                         cfg["sample_rate"])).to(wave.device)
    return torch.log(torch.clamp(prec.mm(power, fb), min=1e-10))

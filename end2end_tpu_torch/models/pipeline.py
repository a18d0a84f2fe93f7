"""Conformer-CTC ASR pipeline: waveform -> log-mel -> encoder -> CTC loss or
decode (torch port of `end2end_tpu/models/pipeline.py`).

    pipe = ConformerCTCPipeline(PipelineConfig(), device="cuda",
                                generator=torch.Generator().manual_seed(0))
    logits, out_len = pipe.encode(waveforms, num_samples)
    loss = pipe.loss(waveforms, num_samples, targets, target_lengths)
    loss.backward()                      # gradients on pipe.parameters()
    tokens, lengths, scores = pipe.decode(waveforms, num_samples,
                                          beam_width=8, prune_k=16)

The module holds its weights (JAX passes `params` instead); load flax
weights with `load_flax_params`.  It is built on the card unless `device`
says otherwise (utils/device.py).  On the card, `loss` runs the CTC kernels
K1/K2 and `decode` the top-k and beam-step kernels (with `lm=`, the beam
kernel's in-kernel LM mode K5).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.beam_search import beam_search_decode
from ..ops.ctc_loss import ctc_loss
from ..ops.greedy import greedy_decode
from ..utils.convert import conformer_state_dict_from_flax
from ..utils.profiling import span
from .conformer import ConformerEncoder
from .frontend import log_mel_spectrogram, num_frames


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int = 32  # includes blank at id 0
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 80
    d_model: int = 256
    num_layers: int = 4
    num_heads: int = 4


class ConformerCTCPipeline(nn.Module):
    """End-to-end ASR: frontend config + encoder weights."""

    def __init__(self, config: PipelineConfig = PipelineConfig(), *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.encoder = ConformerEncoder(
            vocab_size=config.vocab_size, d_model=config.d_model,
            num_layers=config.num_layers, num_heads=config.num_heads,
            n_mels=config.n_mels, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.encoder.out.weight.device

    def load_flax_params(self, params) -> None:
        """Load the JAX pipeline's params (nested dicts of numpy arrays)."""
        self.encoder.load_state_dict(conformer_state_dict_from_flax(params))

    def features(self, waveforms) -> torch.Tensor:
        c = self.config
        waveforms = torch.as_tensor(waveforms, dtype=torch.float32)
        return log_mel_spectrogram(waveforms.to(self.device), c.sample_rate,
                                   c.n_fft, c.hop_length, c.n_mels)

    def feature_lengths(self, num_samples) -> torch.Tensor:
        c = self.config
        return num_frames(num_samples, c.n_fft, c.hop_length)

    def encode(self, waveforms, num_samples):
        """(N, samples) audio + (N,) valid sample counts -> logits
        (N, T', V) and out lengths (N,)."""
        feats = self.features(waveforms)
        lens = self.feature_lengths(num_samples).to(self.device)
        return self.encoder(feats, lens)

    def loss(self, waveforms, num_samples, targets, target_lengths,
             blank: int = 0, implementation: str = "auto") -> torch.Tensor:
        """Mean CTC loss of a batch (zero_infinity=True), differentiable
        wrt the encoder's parameters: the training objective."""
        with span("ctc_pipeline.loss"):
            logits, out_len = self.encode(waveforms, num_samples)
            log_probs = torch.log_softmax(logits, dim=-1)
            # (N, T, V) -> (T, N, V)
            return ctc_loss(log_probs.transpose(0, 1),
                            targets, out_len, target_lengths, blank=blank,
                            reduction="mean", zero_infinity=True,
                            implementation=implementation)

    @torch.no_grad()
    def decode(self, waveforms, num_samples, beam_width: int = 0,
               blank: int = 0, prune_k: int | None = None, lm=None,
               lm_alpha: float = 0.0, lm_beta: float = 0.0):
        """Greedy when beam_width == 0, else prefix beam search, with LM
        shallow fusion when `lm` is given (ops/lm.py, on the model's
        device); returns the best hypothesis per sample: tokens, lengths,
        scores."""
        with span("ctc_pipeline.decode"):
            logits, out_len = self.encode(waveforms, num_samples)
            log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
            if beam_width == 0:
                return greedy_decode(log_probs, out_len, blank=blank)
            tokens, lengths, scores = beam_search_decode(
                log_probs, out_len, beam_width=beam_width, blank=blank,
                prune_k=prune_k, lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta)
            return tokens[:, 0], lengths[:, 0], scores[:, 0]

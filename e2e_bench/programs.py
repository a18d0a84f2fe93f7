"""The system under test: the port's models, built for a configuration, and
the calls the timed entries drive.  The only module of the benchmark that
imports the port."""

from __future__ import annotations

import contextlib
import logging

import torch

from end2end_tpu_torch.models.conformer import ConformerEncoder
from end2end_tpu_torch.models.frontend import log_mel_spectrogram, num_frames
from end2end_tpu_torch.models.pipeline import (ConformerCTCPipeline,
                                               PipelineConfig)
from end2end_tpu_torch.models.transducer import (ConformerTransducer,
                                                 TransducerConfig)
from end2end_tpu_torch.utils.profiling import log_compiles


@contextlib.contextmanager
def builds():
    """Yields a list that gains the seconds of each build of the port's
    native libraries inside the block (none where every library is found
    already built in the checkout)."""
    built = []

    class _Builds(logging.Handler):
        def emit(self, record):
            if record.args and record.args[0] == "built":
                built.append(float(record.args[2]))

    handler = _Builds()
    logger = logging.getLogger("end2end_tpu_torch")
    logger.addHandler(handler)
    try:
        with log_compiles():
            yield built
    finally:
        logger.removeHandler(handler)


def build(cfg: dict, device) -> torch.nn.Module:
    """The port's model at the configuration's sizes, with the port's own
    initial weights (the caller loads the benchmark's)."""
    enc = dict(d_model=cfg["d_model"], num_layers=cfg["num_layers"],
               num_heads=cfg["num_heads"])
    if cfg["model"] == "ctc":
        pipe = ConformerCTCPipeline(PipelineConfig(
            vocab_size=cfg["vocab_size"], sample_rate=cfg["sample_rate"],
            n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
            n_mels=cfg["n_mels"], **enc), device=device)
        # PipelineConfig has no kernel size: the encoder is the port's
        # ConformerEncoder at the configuration's
        pipe.encoder = ConformerEncoder(
            vocab_size=cfg["vocab_size"], conv_kernel=cfg["conv_kernel_size"],
            n_mels=cfg["n_mels"], device=device, **enc)
        return pipe
    if cfg["model"] == "transducer":
        return ConformerTransducer(TransducerConfig(
            vocab_size=cfg["vocab_size"], n_mels=cfg["n_mels"],
            conv_kernel=cfg["conv_kernel_size"], enc_dim=cfg["enc_dim"],
            emb_dim=cfg["pred_emb_dim"], pred_hidden=cfg["pred_hidden"],
            joint_dim=cfg["joint_hidden"], **enc), device=device)
    raise ValueError(f"unknown model {cfg['model']!r}")


def loss(model, cfg: dict, wave, num_samples, targets, target_lengths):
    """The training objective through the port's own entry point."""
    if cfg["model"] == "ctc":
        return model.loss(wave, num_samples, targets, target_lengths)
    feats = log_mel_spectrogram(wave, cfg["sample_rate"], cfg["n_fft"],
                                cfg["hop_length"], cfg["n_mels"])
    frames = num_frames(num_samples, cfg["n_fft"], cfg["hop_length"])
    return model.loss(feats, frames, targets, target_lengths)


def decode(model, wave, num_samples, beam_width: int, prune_k=None):
    """Best hypotheses (tokens (N, S), lengths (N,), scores (N,))."""
    return model.decode(wave, num_samples, beam_width=beam_width,
                        prune_k=prune_k)

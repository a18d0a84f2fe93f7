"""end2end_tpu_torch: the PyTorch/CUDA port of end2end_tpu.

The Conformer-CTC pipeline's serving and training paths: log-mel frontend,
Conformer encoder, the CTC loss and its gradient, greedy and prefix
beam-search CTC decoding.  On CUDA tensors the loss runs two hand-written
kernels (csrc/ctc_loss.cu) and the beam search two more (csrc/topk.cu,
csrc/beam_step.cu), built with nvcc at first use; on CPU tensors their
plain torch versions.  This package imports torch and numpy, never jax or
the JAX package.
"""

from .models.pipeline import ConformerCTCPipeline, PipelineConfig
from .ops.beam_search import BeamSearchCTCDecoder, beam_search_decode
from .ops.ctc_loss import CTCLoss, ctc_loss, ctc_loss_jit, ctc_nll
from .ops.greedy import (
    GreedyCTCDecoder,
    greedy_decode,
    greedy_decode_with_timestamps,
)

__all__ = [
    "BeamSearchCTCDecoder",
    "CTCLoss",
    "ConformerCTCPipeline",
    "GreedyCTCDecoder",
    "PipelineConfig",
    "beam_search_decode",
    "ctc_loss",
    "ctc_loss_jit",
    "ctc_nll",
    "greedy_decode",
    "greedy_decode_with_timestamps",
]

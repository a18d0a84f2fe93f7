"""end2end_tpu_torch: the PyTorch/CUDA port of end2end_tpu.

The Conformer-CTC pipeline's serving and training paths: log-mel frontend,
Conformer encoder, the CTC loss and its gradient, greedy and prefix
beam-search CTC decoding, with LM shallow fusion (dense bigram in the
kernel, class-keyed guides, chunked word-LM decoding, N-best rescoring,
ARPA loading).  The Conformer-Transducer's training path and greedy
decoding: the RNN-T loss and its gradient (from logits, log-probs or
planes, over a chunked never-materialised joint, and through the
online-softmax fused joint `rnnt_nll_fused_pallas`).  On CUDA tensors the
CTC loss runs two hand-written kernels (csrc/ctc_loss.cu), the beam search
two more (csrc/topk.cu, csrc/beam_step.cu, whose beam kernel has the LM
modes), the RNN-T loss two (csrc/rnnt_loss.cu) and the fused joint three
(csrc/rnnt_joint.cu), built with nvcc at first use; on CPU tensors their
plain torch versions.  Models and LMs are
built on the card unless `device="cpu"` is passed.  This package imports
torch and numpy, never jax or the JAX package.
"""

from .models.pipeline import ConformerCTCPipeline, PipelineConfig
from .models.transducer import ConformerTransducer, TransducerConfig
from .ops.beam_search import BeamSearchCTCDecoder, beam_search_decode
from .ops.ctc_loss import CTCLoss, ctc_loss, ctc_loss_jit, ctc_nll
from .ops.beam_chunked import beam_search_chunked_lm
from .ops.greedy import (
    GreedyCTCDecoder,
    greedy_decode,
    greedy_decode_with_timestamps,
)
from .ops.lm import (
    NGramLM,
    QuantizedBigramGuide,
    UniformLM,
    WordNGramLM,
    bigram_from_counts,
)
from .ops.rescore import rescore_nbest
from .ops.rnnt_decode import rnnt_greedy_decode
from .ops.rnnt_joint import rnnt_nll_fused_pallas
from .ops.rnnt_loss import (
    RNNTLoss,
    fused_additive_joint,
    rnnt_loss,
    rnnt_loss_fused,
    rnnt_nll,
    rnnt_nll_from_planes,
    rnnt_nll_fused,
)
from .utils.arpa import load_arpa, ngram_lm_from_arpa

__all__ = [
    "BeamSearchCTCDecoder",
    "CTCLoss",
    "ConformerCTCPipeline",
    "ConformerTransducer",
    "GreedyCTCDecoder",
    "NGramLM",
    "PipelineConfig",
    "QuantizedBigramGuide",
    "RNNTLoss",
    "TransducerConfig",
    "UniformLM",
    "WordNGramLM",
    "beam_search_chunked_lm",
    "beam_search_decode",
    "bigram_from_counts",
    "ctc_loss",
    "ctc_loss_jit",
    "ctc_nll",
    "fused_additive_joint",
    "greedy_decode",
    "greedy_decode_with_timestamps",
    "load_arpa",
    "ngram_lm_from_arpa",
    "rescore_nbest",
    "rnnt_greedy_decode",
    "rnnt_loss",
    "rnnt_loss_fused",
    "rnnt_nll",
    "rnnt_nll_from_planes",
    "rnnt_nll_fused",
    "rnnt_nll_fused_pallas",
]

"""end2end_tpu_torch: the PyTorch/CUDA port of end2end_tpu.

The Conformer-CTC pipeline's serving and training paths: log-mel frontend,
Conformer encoder, the CTC loss and its gradient, greedy and prefix
beam-search CTC decoding, with LM shallow fusion (dense bigram in the
kernel, class-keyed guides, hashed token and word n-gram LMs of any order,
hotword boosting, composite and neural LMs, chunked decoding, N-best
rescoring, ARPA loading and Kneser-Ney training); CTC forced alignment, decode confidences, blank collapse
and the MWER fine-tuning loss; streaming (chunk-at-a-time) greedy and
beam decoders and long-form transcription.  The Conformer-Transducer's
training path and decoding (greedy with lookahead, ALSD beam search with
LM fusion, their streaming forms, confidences and the transducer MWER
loss): the RNN-T loss and its gradient (from logits,
log-probs or planes, over a chunked never-materialised joint, and through
the online-softmax fused joint `rnnt_nll_fused_pallas`), and the fused
joint with its output projection vocabulary-sharded over a
torch.distributed group (`rnnt_nll_fused_pallas_vocab_parallel` and the
float32 `rnnt_nll_fused_vocab_parallel`).  `models.ocr` holds the OCR
text-line recognizer; `parallel` the data-, vocabulary- and
time-parallel CTC and transducer losses and decoders and the multi-GPU
dry run.  On CUDA tensors the CTC loss
runs two hand-written kernels (csrc/ctc_loss.cu), the beam search three
more (csrc/topk.cu, csrc/beam_step.cu, whose beam kernel has the LM
modes, and csrc/backtrace.cu), the forced alignment one
(csrc/ctc_align.cu), the RNN-T loss two (csrc/rnnt_loss.cu) and the fused
joint three with their vocabulary-sharded modes (csrc/rnnt_joint.cu),
built with nvcc at first use; on CPU tensors their plain torch versions.
Models and LMs are built on the card unless `device="cpu"` is passed.
`utils` also holds checkpointing, profiling (`trace`, `log_compiles`,
`Throughput`, and `span`, the profiler ranges that mark the port's layer
boundaries while a profiler records), the C++ host runtime (`native`, built with g++) and the
float64 NumPy oracles; `examples` the five demos.
This package imports torch and numpy, never jax or the JAX package.
"""

from .models.pipeline import ConformerCTCPipeline, PipelineConfig
from .models.transducer import ConformerTransducer, TransducerConfig
from .ops.alignment import ForcedAlignment, ctc_forced_alignment
from .ops.beam_search import BeamSearchCTCDecoder, beam_search_decode
from .ops.confidence import (
    aggregate_confidence,
    frame_confidence,
    greedy_decode_with_confidence,
    rnnt_greedy_decode_with_confidence,
    rnnt_token_confidence,
    token_confidence,
    word_confidences,
)
from .ops.ctc_loss import CTCLoss, ctc_loss, ctc_loss_jit, ctc_nll
from .ops.beam_chunked import beam_search_chunked_lm
from .ops.greedy import (
    GreedyCTCDecoder,
    greedy_decode,
    greedy_decode_with_timestamps,
)
from .ops.lm import (
    CompositeLM,
    HashedNGramLM,
    HashedWordNGramLM,
    HotwordBoostLM,
    NGramLM,
    QuantizedBigramGuide,
    UniformLM,
    WordNGramLM,
    bigram_from_counts,
)
from .ops.mwer import mwer_loss, mwer_loss_from_nbest, rnnt_mwer_loss
from .ops.neural_lm import NeuralLM
from .ops.rescore import rescore_nbest
from .ops.rnnt_decode import (FactoredAdditiveJoint, additive_joint,
                              rnnt_beam_decode, rnnt_greedy_decode)
from .ops.rnnt_joint import (rnnt_nll_fused_pallas,
                             rnnt_nll_fused_pallas_vocab_parallel)
from .ops.rnnt_loss import (
    RNNTLoss,
    fused_additive_joint,
    rnnt_loss,
    rnnt_loss_fused,
    rnnt_nll,
    rnnt_nll_from_planes,
    rnnt_nll_fused,
)
from .ops.streaming_decode import (
    StreamingBeamDecoder,
    StreamingGreedyDecoder,
    StreamingRNNTBeamDecoder,
    StreamingRNNTGreedyDecoder,
)
from .parallel.vocab_parallel import rnnt_nll_fused_vocab_parallel
from .utils.arpa import load_arpa, ngram_lm_from_arpa
from .utils.lm_train import (train_ngram_arpa, train_ngram_lm,
                             word_lm_from_corpus)

__version__ = "0.2.0"

__all__ = [
    "__version__",
    "BeamSearchCTCDecoder",
    "CTCLoss",
    "CompositeLM",
    "ConformerCTCPipeline",
    "ConformerTransducer",
    "FactoredAdditiveJoint",
    "ForcedAlignment",
    "GreedyCTCDecoder",
    "HashedNGramLM",
    "HashedWordNGramLM",
    "HotwordBoostLM",
    "NGramLM",
    "NeuralLM",
    "PipelineConfig",
    "QuantizedBigramGuide",
    "RNNTLoss",
    "StreamingBeamDecoder",
    "StreamingGreedyDecoder",
    "StreamingRNNTBeamDecoder",
    "StreamingRNNTGreedyDecoder",
    "TransducerConfig",
    "UniformLM",
    "WordNGramLM",
    "additive_joint",
    "aggregate_confidence",
    "beam_search_chunked_lm",
    "beam_search_decode",
    "bigram_from_counts",
    "ctc_forced_alignment",
    "ctc_loss",
    "ctc_loss_jit",
    "ctc_nll",
    "frame_confidence",
    "fused_additive_joint",
    "greedy_decode",
    "greedy_decode_with_confidence",
    "greedy_decode_with_timestamps",
    "load_arpa",
    "mwer_loss",
    "mwer_loss_from_nbest",
    "ngram_lm_from_arpa",
    "rescore_nbest",
    "rnnt_beam_decode",
    "rnnt_greedy_decode",
    "rnnt_greedy_decode_with_confidence",
    "rnnt_loss",
    "rnnt_mwer_loss",
    "rnnt_loss_fused",
    "rnnt_nll",
    "rnnt_nll_from_planes",
    "rnnt_nll_fused",
    "rnnt_nll_fused_pallas",
    "rnnt_nll_fused_pallas_vocab_parallel",
    "rnnt_nll_fused_vocab_parallel",
    "rnnt_token_confidence",
    "token_confidence",
    "train_ngram_arpa",
    "train_ngram_lm",
    "word_confidences",
    "word_lm_from_corpus",
]

"""Multi-process losses over `torch.distributed` (torch port of
`end2end_tpu/parallel/`): so far the vocabulary-parallel fused transducer
loss, in float32 and through the kernels."""

from .vocab_parallel import (rnnt_nll_fused_pallas_vocab_parallel,
                             rnnt_nll_fused_vocab_parallel)

__all__ = ["rnnt_nll_fused_pallas_vocab_parallel",
           "rnnt_nll_fused_vocab_parallel"]

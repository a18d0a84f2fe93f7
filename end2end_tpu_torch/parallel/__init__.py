"""Multi-process losses and decoders over `torch.distributed` (torch port
of `end2end_tpu/parallel/`): data parallel (`sharding`: each rank passes
its own rows), vocabulary parallel (`vocab_parallel`: every rank passes
the global values and reads its columns) and time parallel
(`time_parallel`: every rank passes the global values and reads its
frames), and `dryrun.dryrun_multichip`, which drives them all over a
group of spawned gloo ranks."""

from .sharding import (DataParallelStreamingRNNT, ctc_loss_data_parallel,
                       greedy_decode_data_parallel, group_rank,
                       rnnt_beam_decode_data_parallel,
                       rnnt_greedy_decode_data_parallel,
                       rnnt_loss_data_parallel, shard_batch, sum_gradients)
from .time_parallel import ctc_nll_time_parallel
from .vocab_parallel import (beam_search_decode_vocab_parallel,
                             beam_topk_prep_vocab_parallel,
                             ctc_nll_vocab_parallel,
                             greedy_decode_vocab_parallel,
                             rnnt_nll_fused_pallas_vocab_parallel,
                             rnnt_nll_fused_vocab_parallel)

__all__ = ["DataParallelStreamingRNNT", "beam_search_decode_vocab_parallel",
           "beam_topk_prep_vocab_parallel", "ctc_loss_data_parallel",
           "ctc_nll_time_parallel", "ctc_nll_vocab_parallel",
           "greedy_decode_data_parallel", "greedy_decode_vocab_parallel",
           "group_rank", "rnnt_beam_decode_data_parallel",
           "rnnt_greedy_decode_data_parallel", "rnnt_loss_data_parallel",
           "rnnt_nll_fused_pallas_vocab_parallel",
           "rnnt_nll_fused_vocab_parallel", "shard_batch", "sum_gradients"]

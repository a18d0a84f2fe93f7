"""Drive the PyTorch/CUDA port's serving and training paths (CTC,
transducer and the fused transducer joint) once on one GPU and check
them.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (every failure raises, so the exit code is nonzero):
  1. a CUDA device must be present;
  2. print the card's name and power limit (nvidia-smi);
  3. build the CUDA kernels from end2end_tpu_torch/csrc (nvcc, sm_90a),
     and beside them the two-barrier K1 that K1 replaced
     (tools/ctc_alpha_reference.cu), the baseline of phases 8-10, and the
     wmma K10 that K10 replaced (tools/joint_fwd_reference.cu), the
     baseline of phases 20 and 25;
  4. top-k kernel vs its plain version: values bit-equal, indices equal;
  5. beam-step kernel vs its plain version on peaked lattices at the beam
     decoder's reference shape (B=32, T=1000, V=1024, beam 8, prune 16):
     same best hypotheses, beam-set scores within 1e-4;
  6. the serving slice: the full-width Conformer-CTC pipeline (vocab 32,
     d 256, 4 layers, 4 heads, 80 mels, seeded random weights, built on
     the card by default, with no device argument) answers three
     batches of 8 requests of mixed length (padded to 30 s) with greedy and
     beam-8 / prune-16 decoding; the launch counters must show both kernels
     ran; one batch's log-probs must match the same model on the CPU within
     1e-3, and on them the kernels' best hypotheses must equal the plain
     path's;
  7. timings with CUDA events (median of 5 after warm-up), and K3 against
     torch.topk in device time, in turns (A B B A);
  8. CTC alpha (K1) and beta (K2) kernels vs their plain versions at the
     loss's reference shapes (metric B=32 T=1000 S=100 V=1024,
     librispeech-char B=32 T=1000 S=200 V=29, bpe-asr B=16 T=1500 S=150
     V=1024; variable lengths, one infeasible sample): losses within
     max(1e-4, 20 ulp) abs and 2e-6 rel of the plain float32 scan,
     gradients within 1e-5; the float32 gradient within 1e-4 of the
     plain float64 scan or at least as accurate as torch's own CTC loss;
     checkpoint_every 0 and 64 give bit-identical losses and gamma; K1's
     outputs (tape and checkpoint rows, norms, z_hat, norm_end2) bit-equal
     to the two-barrier K1's;
  9. the training slice: the full-width pipeline takes 3 AdamW steps on
     batches of 8 requests (30/22/15 s, padded to 30 s) with random
     targets; the launch counters must show K1 and K2 once per step and
     every loss finite and > 0; on the first batch the CUDA loss must be
     within 1e-3 rel of the CPU model's, the encoder's gradients through
     the kernels within 1e-4 (of each tensor's max) of those through the
     plain scan, and K1/K2 within phase 8's tolerances at this shape;
 10. timings: K1, K2 and the plain scans at the metric shape (also as
     lattice cells/s) and at the training slice's shape, the loss+gradient
     both ways, torch's own CTC loss forward and forward+backward, and the
     whole train step, and K2 in checkpoint mode (64 frames); K1, the
     two-barrier K1 and F.ctc_loss forward in device time, in turns; the
     card's SM clock and power under K1;
 11. the beam kernel's in-kernel bigram mode (K5) vs its plain twin at
     B=32, T=1000, V=29, beam 8, prune 16 (seeded bigram LM, alpha 0.6,
     beta 0.3): backpointer codes and the 10-field state identical, same
     best hypotheses, beam-set scores within 1e-4;
 12. the chunked LM decode (chunks of 128 frames, B=32, T=1000, beam 8,
     prune 16) three ways: a 2000-word bigram LM over V=29; the same
     steered by a symbol-keyed bigram guide (K5 inside K7); a dense bigram
     LM at V=1024 steered by its 63-class QuantizedBigramGuide (K6 inside
     K7).  Driven through `beam_search_decode(implementation='chunked')`
     with the launch counters read around it, then kernels vs the plain
     twin on the card: every chunk's codes and the final state identical,
     same hypotheses;
 13. the serving slice with an LM: the pipeline of phase 6 decodes the
     same 3 batches with beam 8, prune 16 and a seeded bigram LM over its
     32 symbols; the counters must show the top-k kernel and K5 once per
     batch, and on one batch the kernels' best hypotheses must equal the
     plain path's;
 14. timings: K5, K6, K7 alone vs their plain twins, the LM-fused and the
     chunked word-LM decodes at B=128, T=1000, V=29 (seq/s; the chunked
     one split into kernel and chunk-boundary time), the pipeline's LM
     decode at B=8 x 30 s, and torch.topk beside K3;
 15. the RNN-T alpha (K8) and posterior (K9) kernels vs the plain scans at
     the JAX bench row's shape (B=8, T=400, U=80, V=256, random logits,
     from logits) and two edge batches (U > T with variable lengths and an
     empty target; blank = V-1): NLL within max(1e-4, 20 ulp) abs + 2e-6
     rel, K9's posteriors on the same residuals within 1e-6, the logits
     gradient within 1e-5; against the plain float64 scan the gradient
     within 1e-4 and the NLL within 1e-4 relative;
 16. the transducer training slice: the full-width ConformerTransducer
     (vocab 32, 80 mels, d 144, 2 layers, 4 heads, conv 15, enc 144, emb
     64, GRU 128, joint 128; seeded random weights, built on the card by
     default) takes 3 AdamW steps on batches of 8 requests (30/22/15 s as
     log-mel features, padded to 30 s, T'=750) with random targets of
     T'/5 labels (lattice (8, 750, 151, 32)); the counters must show K8
     and K9 once per step and every loss finite and > 0; on the first
     batch the CUDA loss within 1e-3 rel of the CPU model's, every
     parameter's gradient through the kernels within 1e-4 (of its max)
     of the plain scan's, and K8/K9 within phase 15's tolerances at this
     shape; then greedy decoding (lengths within the cap, finite scores,
     the count of requests decoding alike on the card and the CPU);
 17. timings: K8, K9 and their twins at the training and bench shapes,
     the loss+gradient at the bench shape (also as lattice cells/s), the
     transducer train step with its parts, and the greedy decode;
 18. the online-softmax fused joint's kernels K10 (forward) and K11 (dh),
     both wgmma with the rows of a block (K10: 256 up to J = 128, K11:
     128) sharing each 128-column W tile from a TMA bulk-copy ring and the
     logits in registers (K10's online softmax there, its warpgroups' exps
     under each other's products; K11's d), and K12 (dW, db; wgmma, rows
     split over blocks) vs their plain twins on the card at JAX's
     test problem
     (R=56, J=8, V=11), V=13 with blank 5, V=1100 with J=16, blank 600
     and R=1000, and the JAX bench row (B=8, T=400, U=80, V=32768, J=128:
     R=259,200), with the DP's real cotangents: planes, m and log s
     within 1e-5, dh, dW and db within 1e-3 of each tensor's max;
 19. the fused-joint slice: 3 AdamW steps on enc_proj, pred_proj, w_out
     and b_out at the bench row (bench.py's draw) through
     `rnnt_nll_fused_pallas` with a mean loss; the counters must show K10,
     K11, K12, K8 and K9 once per step and every loss finite and > 0; on
     step 1 the NLL within 2e-3 relative of the float32 chunked
     `rnnt_nll_fused` (chunk_t 8) and the four gradients with cosine >
     0.995 and within 1.5e-2 (of each tensor's max) of the bf16-joint
     chunked loss's;
 20. timings at the bench row: K10, K11, K12 and their twins, the bf16
     torch.matmul products of each (row-blocked, the library yardstick),
     the fused loss+gradient, its torch work outside the kernels (the
     activation forward and backward, the bf16 casts, K10's and K11's W
     tiles and log2 bias) and the float32
     chunked loss+gradient (the two losses also as lattice cells/s), and
     K10's, K11's launch (blocks, registers, spilled bytes, blocks per SM,
     shared memory, stages) and K12's (row splits too), and the card's SM
     clock, power and temperature while it runs K10, K11, and K12, back to
     back; K10 against the wmma K10 it replaced
     (tools/joint_fwd_reference.cu, built in phase 3) in device time, in
     turns (A B B A), their outputs compared;
 21. J > 128 (the kernels walk J in 128-row slabs): K10-K12 vs their
     twins at J = 200, 256 and 320 (R=1000, V=1100, blank 600) and at the
     bench row with J=256, to phase 18's tolerances; K10-K12 and their
     twins timed at that bench row;
 22. the CTC gradient's combine kernel at the metric shape: two gradient
     runs through K1, K2 and the combine bit-equal, and the combine within
     1e-5 of the plain `scatter_add_` combine on the same gamma; K11, K12
     and K11tp, K12tp (each of the D=4 shards) at the bench row, two runs
     each, dh, dW and db bit-equal;
 23. the vocabulary-sharded kernels K10tp, K11tp, K12tp, D=4 shards run
     one after another on the card, vs their TP twins (phase 18's
     tolerances), and the shards combined (MAX and SUM in torch) vs
     unsharded K10-K12: planes, m and log s within 1e-5, the summed
     partial dh and the concatenated dW, db within 1e-3 of each tensor's
     max; at V=16 with blank 9 (a middle shard owns it), V=1100 with J=16
     and blank 600, and the bench row;
 24. the vocabulary-parallel slice: 4 processes, gloo ranks through the
     host on the one card (`file://` rendezvous), each holding its shard
     of w_out and b_out and its shard's AdamW state, take 3 steps through
     `rnnt_nll_fused_pallas_vocab_parallel` at the bench row; every
     rank's counters must show K10tp, K11tp, K12tp, K8 and K9 once per
     step and no unsharded joint kernel; on step 1 the NLL within 1e-5
     relative of the unsharded `rnnt_nll_fused_pallas` and the four
     gradients (w_out's and b_out's the ranks' shards side by side) to
     phase 19's bf16 budget; a rank that fails fails the run;
 25. timings at the bench row: K10tp-K12tp on each shard, their twins
     (shard 0), the bf16 torch.matmul yardsticks at the shard's shape,
     K10tp against the wmma K10tp in turns (shard 0), K10tp's, K11tp's
     and K12tp's launches, the card's clock while it runs each,
     and the shards' K11tp and K12tp times against K11's and K12's; and
     the combine against the `scatter_add_` combine.
Every kernel row and library yardstick is also timed on the device alone
(`device_ms`: calls captured in a CUDA graph and replayed between one
pair of events; torch.profiler's kernel time where a call cannot be
captured); the kernels line gives that as `ms` (and `ms_method`), the
cost of one call with the host's work as `call_ms`, and the library's as
`library_ms` and `library_call_ms`.
The line before the last is the card's name and power limit; the line
before it the per-kernel JSON (with each kernel's bound: the largest of
its bytes over 3.35 TB/s, its float32 operations over 67 TFLOP/s, its bf16
tensor-core operations over 4096 and its exps over 16 per SM clock, both
on 132 SMs at the card's max SM clock (1,070 TFLOP/s and 4.2e12 exps a
second at 1,980 MHz); `bound_by` says "bytes" or "operations",
the log line which operations); the last line is the JSON result.  It
imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import copy
import datetime
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from end2end_tpu_torch import (ConformerCTCPipeline, ConformerTransducer,
                               PipelineConfig, TransducerConfig)
from end2end_tpu_torch.models.frontend import log_mel_spectrogram, num_frames
from end2end_tpu_torch.ops import (beam_chunked, beam_search_cuda,
                                   ctc_common, ctc_loss_cuda, ctc_loss_plain,
                                   rnnt_joint_cuda, rnnt_joint_plain,
                                   rnnt_loss_cuda, rnnt_loss_plain, topk_cuda)
from end2end_tpu_torch.ops.beam_search import beam_search_decode
from end2end_tpu_torch.ops.ctc_loss import ctc_nll
from end2end_tpu_torch.ops.rnnt_decode import rnnt_greedy_decode
from end2end_tpu_torch.ops.rnnt_joint import (
    rnnt_nll_fused_pallas, rnnt_nll_fused_pallas_vocab_parallel)
from end2end_tpu_torch.ops.rnnt_loss import (fused_additive_joint, rnnt_nll,
                                             rnnt_nll_from_planes,
                                             rnnt_nll_fused)
from end2end_tpu_torch.ops.lm import (NGramLM, QuantizedBigramGuide,
                                      WordNGramLM, bigram_from_counts)
from end2end_tpu_torch.tools import ctc_alpha_breakdown, joint_fwd_breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import (
    N_SMS, device_ms, max_sm_mhz, tensor_ops_per_s, under_load)
from end2end_tpu_torch.utils import cuda_build

SEED = 0
SCORE_TOL = 1e-4  # beam-set scores, kernel vs plain: ulp-level libm drift
LOGP_TOL = 1e-3  # CUDA vs CPU encoder log-probs: different sum orders
# CTC kernels vs the plain float32 scan: the JAX package's full-config loss
# tolerance (float32 ulps of losses ~1e4 at T=1500), and 1e-5 on gradients
# (the same recurrences in the same order; only exp/log1p rounding differs)
CTC_LOSS_RTOL = 2e-6
CTC_GRAD_TOL = 1e-5
TRAIN_LOSS_RTOL = 1e-3  # CUDA vs CPU pipeline loss (TF32 off)
TRAIN_GRAD_RTOL = 1e-4  # kernel vs plain encoder gradients, of tensor max
CTC_SHAPES = {  # name: (B, T, S, V), tests/test_full_configs.py
    "metric": (32, 1000, 100, 1024),
    "librispeech-char": (32, 1000, 200, 29),
    "bpe-asr": (16, 1500, 150, 1024),
}
RNNT_SHAPES = {  # name: (B, T, U, V, blank, variable lengths)
    "bench": (8, 400, 80, 256, 0, False),  # bench.py's RNN-T loss row
    "U > T, empty target": (6, 60, 150, 64, 0, True),
    "blank = V-1": (4, 100, 20, 64, 63, True),
}
# K8/K9 vs plain: NLL and logits gradient as for K1/K2 (CTC_LOSS_RTOL,
# CTC_GRAD_TOL); posteriors on the same residuals within 1e-6 (the same
# sums in the same order, libm exp rounding only); the float32 kernels vs
# the float64 scan within 1e-4 on the gradient and 1e-4 relative on the NLL
# (the NLL reaches ~2e3 at the bench row, where float32's spacing is 2.4e-4)
RNNT_POST_TOL = 1e-6
RNNT_F64_TOL = 1e-4
LM_ALPHA, LM_BETA = 0.6, 0.3  # LM weight and insertion bonus
CHUNK_T = 128  # frames per chunk of the chunked LM decode
JOINT_SHAPES = {  # name: (N, T, U, V, J, blank, bias scale); R = N T (U+1)
    "JAX test problem": (2, 7, 3, 11, 8, 0, 0.1),  # test_rnnt_joint_pallas
    "V=13, blank=5": (2, 7, 3, 13, 8, 5, 0.1),
    "V=1100, J=16, blank=600, R=1000": (2, 25, 19, 1100, 16, 600, 0.1),
    "bench": (8, 400, 80, 32768, 128, 0, 0.0),  # bench_rnnt_fused_pallas
}
# K10-K12 vs their plain twins on the card: the forward outputs within 1e-5
# (float32 sums in other orders and __expf; 2.4e-6 at the bench row on an
# H100); dh, dW and db within 1e-3 of each tensor's max (a last-bit
# difference of the float32 d can round it to the neighbouring bf16 value)
JOINT_FWD_TOL = 1e-5
JOINT_GRAD_RTOL = 1e-3
JOINT_PLAIN_ROWS = 1 << 15  # the twins' row block at the bench row (memory)
# the fused joint vs the float32 and the bf16-joint chunked loss (step 1 of
# phase 19): tests/test_rnnt_joint_pallas.py's budget, its gradient
# tolerance of 1.5e-2 taken of each tensor's max (the test's gradients are
# O(1); at the bench row w_out's sums 259,200 rows and reaches O(100), and
# the error, from the bf16 rounding of d, grows with it)
FUSED_NLL_RTOL = 2e-3
FUSED_GRAD_COS = 0.995
FUSED_GRAD_RTOL = 1.5e-2
FUSED_CHUNK_T = 8  # frames per chunk of the float32 reference (0.7 GB)
JOINT_WIDE_SHAPES = {  # J > 128: name as JOINT_SHAPES
    "J=200 (a ragged slab)": (2, 25, 19, 1100, 200, 600, 0.1),
    "J=256": (2, 25, 19, 1100, 256, 600, 0.1),
    "J=320": (2, 25, 19, 1100, 320, 600, 0.1),
    "bench, J=256": (8, 400, 80, 32768, 256, 0, 0.0),
}
TP_RANKS = 4  # vocabulary shards (D)
TP_SHAPES = {  # the bench row is phase 20's problem
    "V=16, blank 9": (2, 7, 3, 16, 8, 9, 0.1),
    "V=1100, J=16, blank 600": (2, 25, 19, 1100, 16, 600, 0.1),
}
# the vocabulary-parallel slice's step 1 vs the unsharded kernels: the NLL
# within 1e-5 relative (the same bf16 products; only the cross-shard order
# of the sum-exp differs); the gradients to phase 19's bf16 budget
# (FUSED_GRAD_COS, FUSED_GRAD_RTOL), since the last bits of log s differ
# and flip the bf16 rounding of some d, and enc_proj's gradient sums U+1
# rows of dh that mostly cancel (its max 0.05 against pred_proj's 5.9 at
# the bench row), so one flip moves it by more of its own max
TP_NLL_RTOL = 1e-5
TP_TIMEOUT = datetime.timedelta(seconds=300)  # a stuck collective raises
# H100 SXM data sheet: HBM bandwidth and the float32 rate outside the
# tensor cores, yardsticks of each kernel's bound; the dense bf16
# tensor-core rate (4096 a clock per SM, tensor_ops_per_s) and the exp
# rate (16 a clock per SM, exp_per_s) are taken on 132 SMs at the card's
# max SM clock, as the float32 rate is (the data sheet's 989 TFLOP/s in
# bf16 is the tensor rate at 1,830 MHz, below the card's 1,980)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
EXP_PER_SM_CLOCK = 16
BEAM_COUNTERS = ("launches", "launches_lm", "launches_cls",
                 "launches_resume")


START = time.perf_counter()


def log(msg: str) -> None:
    """Print msg after the seconds since the script started."""
    print(f"[{time.perf_counter() - START:6.1f} s] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# key: (device ms, method) of every kernel row and library yardstick
DEVICE_MS = {}


def time_both(key, fn) -> float:
    """time_ms(fn), the cost of one call with the host's work, returned;
    and fn's device time (device_ms, ~20 ms of calls) into DEVICE_MS."""
    call = time_ms(fn)
    DEVICE_MS[key] = device_ms(fn, max(5, min(400, int(20 / max(call,
                                                                0.05)))))
    return call


def in_turns(what, fns: dict, calls: int) -> dict:
    """device_ms of each fn once in order, then again in the reverse
    order (A B B A): {name: [first, second]}, logged."""
    out, how = {name: [] for name in fns}, {}
    for name in [*fns, *reversed(fns)]:
        t, how[name] = device_ms(fns[name], calls)
        out[name].append(t)
    log(f"{what}, device ms in turns (A B B A, {calls} calls each): "
        + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} ({how[k]})"
                    for k, v in out.items()))
    return out


def card_under_load(fn) -> str:
    """The card's SM clock, power and temperature while fn() runs back to
    back for 1.5 s (a card at its power or thermal limit clocks down, and
    every kernel's time with it)."""
    mhz, watts, temp = under_load(fn, seconds=1.5)
    return f"SM clock {mhz:.0f} MHz, {watts:.1f} W, {temp:.0f} C"


def time_plain(fn) -> float:
    """Device time of one call of a plain twin in ms: its Python loop takes
    0.1-10 s and is only a yardstick, so one run, no warm-up."""
    return time_ms(fn, reps=1, warmup=0)


def peaked_lattice(rng, t, b, v):
    """Log-probs with one dominant token per frame (blank half the time)
    over a noisy background: the regime a trained CTC model produces."""
    x = np.log(0.003 / (v - 1)) + 0.5 * rng.standard_normal((t, b, v))
    ids = np.where(rng.random((t, b)) < 0.5, 0, rng.integers(1, v, (t, b)))
    np.put_along_axis(x, ids[..., None], np.log(0.997), axis=-1)
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x.astype(np.float32)


def exp_per_s() -> float:
    """The card's exp rate: 16 a clock per SM at the max SM clock."""
    return N_SMS * EXP_PER_SM_CLOCK * max_sm_mhz() * 1e6


def bound(nbytes: float, nops: float = 0.0, tensor_ops: float = 0.0,
          exps: float = 0.0):
    """(ms, what bounds it): the least time the card could take to move
    `nbytes`, do `nops` float32 operations, `tensor_ops` bf16 tensor-core
    operations and `exps` exponentials."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": nops / FP32_OPS_PER_S,
             "bf16 tensor ops": tensor_ops / tensor_ops_per_s(),
             "exp": exps / exp_per_s() if exps else 0.0}
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def topk_bound(x, k):
    """Read every value once, write k (value, index) pairs per row; one
    compare per value."""
    rows = x.numel() // x.shape[-1]
    return bound(x.numel() * 4 + rows * k * 8, x.numel())


def beam_bound(lpk, il, W, K, inc=None, cls_map=None, resume=False):
    """The beam step on this run's data: each running frame (t < il) reads
    its ks candidates and blank, every frame writes W codes, the state is
    written (and read when resuming) once, the LM tables read once.
    Operations per running frame: the ks-wide repeat search, W*K
    extensions, the W*W merge search, W argmax rounds over W*K + W
    candidates, and W*K bonus adds with an increment table."""
    t_max, n, ks = lpk.shape
    frames = int(il.long().clamp(0, t_max).sum())
    nbytes = frames * (ks * 8 + 4) + n * 4 + t_max * W * n * 4 + 11 * W * n * 4
    nops = frames * (W * ks + W * K + W * W + W * (W * K + W))
    if inc is not None:
        nbytes += inc.numel() * 4
        nops += frames * W * K
    if cls_map is not None:
        nbytes += cls_map.numel() * 4
    if resume:
        nbytes += 10 * W * n * 4
    return bound(nbytes, nops)


def ctc_bound(lp, tgt, il, tl, beta):
    """K1 reads the log-probs its lattice needs (il * (tl + 1) per sample)
    and the targets and writes the alpha tape and the loss terms; K2 reads
    the same log-probs, targets and the tape and writes gamma.  About 10
    operations per lattice cell (a 3-way logaddexp), 12 for K2 (and the
    occupation)."""
    t_max, n, _ = lp.shape
    il, tl = il.long(), tl.long()
    cells = int((il * (2 * tl + 1)).sum())
    lp_bytes = int((il * (tl + 1)).sum()) * 4
    tape = t_max * n * (2 * tgt.shape[1] + 1) * 4 + t_max * n * 4
    nbytes = lp_bytes + tgt.numel() * 4 + tape + n * 8
    if beta:
        nbytes += t_max * n * (2 * tgt.shape[1] + 1) * 4
    return bound(nbytes, (12 if beta else 10) * cells)


def beam_counts():
    return {c: getattr(beam_search_cuda, c) for c in BEAM_COUNTERS}


def reset_counts():
    topk_cuda.launches = 0
    for c in BEAM_COUNTERS:
        setattr(beam_search_cuda, c, 0)


def seeded_bigram(rng, v, dev):
    """A dense bigram LM over v symbols from random counts, with start and
    end-of-sequence rows."""
    rows = bigram_from_counts(rng.integers(0, 20, (v + 1, v)))
    eos = (-2.0 + 0.5 * rng.standard_normal(v)).astype(np.float32)
    return NGramLM(rows[:v], start_logp=rows[v], eos_logp=eos, device=dev)


def seeded_lexicon(rng, v, n_words=2000):
    """n_words distinct spellings of 2-8 symbols in 1..v-2 (v-1 is the
    word separator), drawn as bench.py draws its word LM's."""
    spell = set()
    while len(spell) < n_words:
        spell.add(tuple(int(x) for x in rng.integers(1, v - 1,
                                                     int(rng.integers(2, 9)))))
    return sorted(spell)


def seeded_word_lm(rng, spellings, v, dev):
    """A dense word bigram over the lexicon (random log-softmax rows)."""
    wv = len(spellings)
    x = 2.0 * rng.standard_normal((wv + 1, wv))
    rows = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    uni = rows[wv] - 1.0
    eos = (-2.0 + 0.5 * rng.standard_normal(wv)).astype(np.float32)
    return WordNGramLM(spellings, rows[:wv], rows[wv], v - 1,
                       unigram_logp=uni, eos_logp=eos, device=dev)


def word_lattice(rng, t, b, v, spellings, peak=0.9):
    """Log-probs whose most likely path spells random lexicon words, each
    followed by the separator v-1, with 0-2 blanks after every symbol,
    over a noisy background."""
    ids = np.zeros((t, b), np.int64)
    for n in range(b):
        seq = []
        while len(seq) < t:
            word = spellings[int(rng.integers(len(spellings)))]
            for c in (*word, v - 1):
                seq += [c] + [0] * int(rng.integers(0, 3))
        ids[:, n] = seq[:t]
    x = np.log((1 - peak) / (v - 1)) + 0.5 * rng.standard_normal((t, b, v))
    np.put_along_axis(x, ids[..., None], np.log(peak), axis=-1)
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return x.astype(np.float32)


def beam_sets(tokens, lens, scores):
    tokens, lens, scores = (x.cpu() for x in (tokens, lens, scores))
    return [{tuple(tokens[n, w, : int(lens[n, w])].tolist()):
             float(scores[n, w])
             for w in range(tokens.shape[1])
             if np.isfinite(float(scores[n, w]))}
            for n in range(tokens.shape[0])]


def compare_beams(got, want, what):
    """Same best hypotheses, same beam sets, scores within SCORE_TOL.
    Returns the largest score difference."""
    err = 0.0
    for n, (g, w) in enumerate(zip(got, want)):
        if max(g, key=g.get) != max(w, key=w.get):
            raise AssertionError(f"{what}: best hypothesis differs, seq {n}")
        if set(g) != set(w):
            raise AssertionError(f"{what}: beam sets differ, seq {n}")
        err = max([err] + [abs(g[p] - w[p]) for p in g])
    if err > SCORE_TOL:
        raise AssertionError(f"{what}: score error {err} > {SCORE_TOL}")
    return err


def plain_beam_decode(log_probs, il, W, K, s_cap, blank=0, lm=None):
    """The plain path: plain top-k, plain beam step (with the LM's
    increments), the end-of-sequence bonus, backtrace."""
    v = log_probs.shape[-1]
    ks = min(K + 8, v)
    lpk, ck = topk_cuda.topk_plain(log_probs, ks)
    lpb = log_probs[:, :, blank].contiguous()
    inc = None if lm is None else LM_ALPHA * lm._table + LM_BETA
    bp, score, last, _ = beam_search_cuda.beam_step_plain(
        lpk, ck, lpb, il, W, K, s_cap, blank, inc=inc)
    if lm is not None:
        eos = lm._eos[last.long().clamp(0, v - 1)]
        score = score + torch.where(last >= 0, LM_ALPHA * eos, 0.0)
    return beam_search_cuda.backtrace(bp, ck, score, W, K, s_cap)[:3]


def same_state(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def check_beam_lm(rng, dev, t, b, v, W, K):
    """K5 vs its plain twin on the card.  Returns (score err, inputs)."""
    lp = torch.from_numpy(peaked_lattice(rng, t, b, v)).to(dev)
    il = torch.from_numpy(
        rng.integers(t // 2, t + 1, b).astype(np.int32)).to(dev)
    lm = seeded_bigram(rng, v, dev)
    inc = LM_ALPHA * lm._table + LM_BETA
    s_cap = min(t, 512)
    lpk, ck = topk_cuda.topk_plain(lp, min(K + 8, v))
    lpb = lp[:, :, 0].contiguous()
    args = (lpk, ck, lpb, il, W, K, s_cap, 0)
    kern = beam_search_cuda.beam_step_cuda(*args, inc=inc)
    plain = beam_search_cuda.beam_step_plain(*args, inc=inc)
    torch.cuda.synchronize()
    differing = int((kern[0] != plain[0]).sum())
    if differing or not same_state(kern[3], plain[3]):
        raise AssertionError(f"K5 vs plain: {differing} codes differ or the "
                             "state does")

    def sets(bp, score, last):
        eos = lm._eos[last.long().clamp(0, v - 1)]
        score = score + torch.where(last >= 0, LM_ALPHA * eos, 0.0)
        return beam_sets(*beam_search_cuda.backtrace(bp, ck, score, W, K,
                                                     s_cap)[:3])

    err = compare_beams(sets(*kern[:3]), sets(*plain[:3]), "K5 vs plain")
    log(f"phase 11 K5 (B={b}, T={t}, V={v}, W={W}, K={K}): 0 of "
        f"{kern[0].numel()} codes differ, state identical, best hypotheses "
        f"equal, max score err {err:.3g}")
    return err, (lpk, ck, lpb, il, inc, lm)


def chunked_inputs(lp, il, guide, W, K):
    lpk, ck = topk_cuda.topk_cuda(lp, K)
    inc, cls_map = beam_chunked._resolve_guide(guide, lp.shape[-1], W,
                                               LM_ALPHA, LM_BETA)
    return lpk, ck, lp[:, :, 0].contiguous(), il, inc, cls_map


def run_chunks(inputs, lm, W, step):
    """The chunk loop of beam_search_decode(implementation='chunked') on
    chunked_inputs, with `step` as the beam step."""
    lpk, ck, lpb, il, inc, cls_map = inputs
    return beam_chunked.decode_chunks(lpk, ck, lpb, il, W,
                                      min(lpk.shape[0], 512), 0, lm,
                                      LM_ALPHA, LM_BETA, CHUNK_T, inc,
                                      cls_map, step=step)


def check_chunked(name, inputs, lm, main_out, W, K):
    """The chunked decode with the kernels vs with the plain twin, both on
    the card: every code and the final state identical; the hypotheses
    equal to the main path's run.  Returns the max score error."""
    lpk, ck = inputs[:2]
    s_cap = min(lpk.shape[0], 512)
    kern = run_chunks(inputs, lm, W, beam_search_cuda.beam_step_cuda)
    plain = run_chunks(inputs, lm, W, beam_search_cuda.beam_step_plain)
    torch.cuda.synchronize()
    differing = int((kern[0] != plain[0]).sum())
    if differing or not same_state(kern[2], plain[2]):
        raise AssertionError(f"{name}: {differing} codes differ, or the "
                             "state does")
    got = beam_search_cuda.backtrace(kern[0], ck, kern[1], W, K, s_cap)[:3]
    want = beam_search_cuda.backtrace(plain[0], ck, plain[1], W, K, s_cap)
    err = compare_beams(beam_sets(*got), beam_sets(*want[:3]), name)
    if not all(torch.equal(a, b) for a, b in zip(got, main_out)):
        raise AssertionError(f"{name}: beam_search_decode differs from the "
                             "chunk loop")
    log(f"phase 12 {name}: 0 of {kern[0].numel()} codes differ, state "
        f"identical, hypotheses equal, max score err {err:.3g}")
    return err


def check_topk(rng, dev, shapes):
    err = 0.0
    for t, b, v, ks in shapes:
        x = torch.from_numpy(
            rng.standard_normal((t, b, v)).astype(np.float32)).to(dev)
        vals, idx = topk_cuda.topk_cuda(x, ks)
        pv, pi = topk_cuda.topk_plain(x, ks)
        torch.cuda.synchronize()
        if not torch.equal(vals, pv) or not torch.equal(idx, pi):
            raise AssertionError(f"top-k kernel != plain at {(t, b, v, ks)}")
        err = max(err, float((vals - pv).abs().max()))
        log(f"phase 4 top-k (T={t}, B={b}, V={v}, ks={ks}): bit-equal")
    return err


def check_beam(rng, dev, t, b, v, W, K):
    lp = torch.from_numpy(peaked_lattice(rng, t, b, v)).to(dev)
    il = torch.from_numpy(
        rng.integers(t // 2, t + 1, b).astype(np.int32)).to(dev)
    ks = min(K + 8, v)
    s_cap = min(t, 512)
    lpk, ck = topk_cuda.topk_plain(lp, ks)
    lpb = lp[:, :, 0].contiguous()
    bp, score, _, state = beam_search_cuda.beam_step_cuda(lpk, ck, lpb, il,
                                                          W, K, s_cap, 0)
    pbp, pscore, _, pstate = beam_search_cuda.beam_step_plain(
        lpk, ck, lpb, il, W, K, s_cap, 0)
    torch.cuda.synchronize()
    got = beam_sets(*beam_search_cuda.backtrace(bp, ck, score, W, K,
                                                s_cap)[:3])
    want = beam_sets(*beam_search_cuda.backtrace(pbp, ck, pscore, W, K,
                                                 s_cap)[:3])
    err = compare_beams(got, want, "beam kernel vs plain")
    log(f"phase 5 beam step (B={b}, T={t}, V={v}, W={W}, K={K}): best "
        f"hypotheses equal, max score err {err:.3g}, backpointer codes "
        f"differing: {int((bp != pbp).sum())} of {bp.numel()}, state "
        f"identical: {same_state(state, pstate)}")
    return err, (lpk, ck, lpb, il, s_cap)


def ctc_problem(rng, b, t, s, v):
    """Random log-softmax lattice, variable lengths, sample 1 infeasible
    (target longer than its input)."""
    x = rng.standard_normal((t, b, v)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    il = rng.integers(t // 2, t + 1, b).astype(np.int32)
    tl = np.minimum(rng.integers(1, s + 1, b), np.maximum(il // 3, 1))
    tl[1], il[1] = s, s - 1
    tgt = rng.integers(1, v, (b, s)).astype(np.int32)
    return lp, tgt, il, tl.astype(np.int32)


def nll_and_grad(lp, tgt, il, tl, implementation, every=0):
    x = lp.detach().clone().requires_grad_(True)
    nll = ctc_nll(x, tgt, il, tl, implementation=implementation,
                  checkpoint_every=every)
    nll.sum().backward()
    return nll.detach(), x.grad


def kernel_outputs(lp, tgt, il, tl, every):
    """(nll, gamma) straight from K1 then K2."""
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl, 0, every)
    gamma = ctc_loss_cuda.beta_cuda(lp, tgt, il, tl, a, an, z, ne, 0, every)
    return ctc_loss_plain.nll_from(z, ne), gamma


def check_alpha_ab(lp, tgt, il, tl, ref_lib, what):
    """K1 vs the two-barrier K1 it replaced (tools/ctc_alpha_reference.cu)
    on the same inputs: the tape and checkpoint rows (every 64), the norms,
    z_hat and norm_end2 bit-equal."""
    for every in (0, 64):
        got = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl, 0, every)
        want = ctc_alpha_breakdown.runner(ref_lib, False, (lp, tgt, il, tl),
                                          every)()
        torch.cuda.synchronize()
        if not ctc_alpha_breakdown.equal_outputs(got, want):
            raise AssertionError(f"{what}: K1 (every={every}) differs from "
                                 "the two-barrier K1")
    log(f"{what}: K1 == the two-barrier K1 bit for bit (tape, checkpoint "
        "rows, norms, z_hat, norm_end2)")


def check_ctc(lp, tgt, il, tl, what, ref_lib):
    """K1/K2 (through ctc_nll) vs the plain float32 and float64 scans on
    the card, and the kernels' tape and checkpoint modes against each other
    (bit-identical outputs and gradients); K1 vs the two-barrier K1 (bit
    for bit).  Returns (loss err, grad err)."""
    check_alpha_ab(lp, tgt, il, tl, ref_lib, what)
    k_loss, k_grad = nll_and_grad(lp, tgt, il, tl, "pallas")
    c_loss, c_grad = nll_and_grad(lp, tgt, il, tl, "pallas", every=64)
    p_loss, p_grad = nll_and_grad(lp, tgt, il, tl, "xla")
    _, g64 = nll_and_grad(lp.double(), tgt, il, tl, "xla")
    tape, ckpt = (kernel_outputs(lp, tgt, il, tl, k) for k in (0, 64))
    torch.cuda.synchronize()
    if not (torch.equal(tape[0], ckpt[0]) and torch.equal(tape[1], ckpt[1])
            and torch.equal(c_loss, k_loss)):
        raise AssertionError(f"{what}: checkpoint mode != tape mode")
    if not torch.equal(c_grad, k_grad):
        raise AssertionError(f"{what}: checkpoint-mode gradient differs")
    fin = torch.isfinite(p_loss)
    if not torch.equal(torch.isfinite(k_loss), fin):
        raise AssertionError(f"{what}: kernel and plain disagree on which "
                             "samples are feasible")
    if not torch.isfinite(k_grad).all():
        raise AssertionError(f"{what}: non-finite kernel gradient")
    loss_err = float((k_loss[fin] - p_loss[fin]).abs().max())
    ulp = float(np.spacing(np.float32(p_loss[fin].abs().max().item())))
    tol = max(1e-4, 20 * ulp) + CTC_LOSS_RTOL * p_loss[fin].abs()
    if ((k_loss[fin] - p_loss[fin]).abs() > tol).any():
        raise AssertionError(f"{what}: kernel loss vs plain, err {loss_err}")
    grad_err = float((k_grad - p_grad).abs().max())
    if grad_err > CTC_GRAD_TOL:
        raise AssertionError(f"{what}: kernel grad vs plain, err {grad_err}")
    # float64 truth, on the feasible samples (torch's f32 gradient of an
    # infeasible one is not comparable)
    x = lp.detach().clone().requires_grad_(True)
    torch.nn.functional.ctc_loss(
        x, tgt.long(), il.long(), tl.long(), reduction="sum",
        zero_infinity=True).backward()
    cols = fin.nonzero()[:, 0]
    k_err = float((k_grad - g64)[:, cols].abs().max())
    t_err = float((x.grad.double() - g64)[:, cols].abs().max())
    if k_err > max(1e-4, t_err):
        raise AssertionError(f"{what}: f32 grad err vs f64 {k_err} exceeds "
                             f"both 1e-4 and torch's own {t_err}")
    log(f"{what}: K1/K2 vs plain loss err {loss_err:.3g}, grad err "
        f"{grad_err:.3g}; vs float64 grad err {k_err:.3g} (torch "
        f"{t_err:.3g}); checkpoint_every=64: loss, gamma and gradient "
        "bit-identical")
    return loss_err, grad_err


def training_batches(rng, cfg, n_batches=3):
    sr = cfg.sample_rate
    pad = 30 * sr
    out = []
    for i in range(n_batches):
        secs = np.roll(np.array([30, 22, 15, 30, 22, 15, 22, 15]), i)
        wav = np.zeros((8, pad), np.float32)
        for j, s in enumerate(secs):
            wav[j, : s * sr] = 0.1 * rng.standard_normal(s * sr)
        ns = (secs * sr).astype(np.int32)
        t_out = ((1 + (ns - cfg.n_fft) // cfg.hop_length) + 3) // 4
        tl = (t_out // 4).astype(np.int32)
        tgt = rng.integers(1, cfg.vocab_size, (8, int(tl.max())))
        out.append((wav, ns, tgt.astype(np.int32), tl))
    return out


def encoder_grads(pipe, batch, implementation):
    pipe.zero_grad()
    loss = pipe.loss(*batch, implementation=implementation)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in pipe.named_parameters()}


def train_shape_inputs(pipe, batch):
    """The log-probs, targets and lengths the training slice's loss sees."""
    with torch.no_grad():
        logits, out_len = pipe.encode(batch[0], batch[1])
        lp = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    dev = lp.device
    return (lp, *(torch.as_tensor(a, device=dev)
                  for a in (batch[2], out_len, batch[3])))


def check_training_batch(pipe, batch, ref_lib):
    """First batch: CUDA vs CPU loss, kernel vs plain encoder gradients,
    and K1/K2 vs plain at this shape.  Returns (loss err, grad err)."""
    k_loss, k_grads = encoder_grads(pipe, batch, "auto")
    p_loss, p_grads = encoder_grads(pipe, batch, "xla")
    pipe_cpu = copy.deepcopy(pipe).cpu()
    with torch.no_grad():
        c_loss = pipe_cpu.loss(*batch).item()
    rel = abs(k_loss.item() - c_loss) / abs(c_loss)
    log(f"phase 9 first batch: CUDA loss {k_loss.item():.6f}, CPU loss "
        f"{c_loss:.6f} (rel err {rel:.3g}), plain-path loss "
        f"{p_loss.item():.6f}")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"CUDA loss vs CPU: rel err {rel}")
    worst = 0.0
    for name, kg in k_grads.items():
        scale = max(float(p_grads[name].abs().max()), 1e-4)
        worst = max(worst, float((kg - p_grads[name]).abs().max()) / scale)
    log(f"phase 9 encoder gradients, kernels vs plain: max err "
        f"{worst:.3g} of each tensor's max")
    if worst > TRAIN_GRAD_RTOL:
        raise AssertionError(f"encoder grads differ: {worst}")
    lp, tgt, il, tl = train_shape_inputs(pipe, batch)
    return check_ctc(lp, tgt, il, tl, f"phase 9 K1/K2 at T'={lp.shape[0]}, "
                     f"B=8, S={tgt.shape[1]}", ref_lib)


def time_ctc(name, lp, tgt, il, tl):
    """K1, K2 and the combine alone, the plain scans and combine they
    replace (emission gather included in both forward columns), and the
    whole loss+gradient."""
    tables = ctc_common.build_ctc_tables(tgt, tl, 0, lp.shape[-1])
    il64, tl64 = il.long(), tl.long()
    # F.ctc_loss takes host lengths: given CUDA ones it copies them back
    # inside the timed window
    lib_args = (tgt.long(), il64.cpu(), tl64.cpu())
    fwd = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl)
    gamma = ctc_loss_cuda.beta_cuda(lp, tgt, il, tl, fwd[2], fwd[3], fwd[0],
                                    fwd[1])
    g = torch.ones(lp.shape[1], device=lp.device)
    lp_ext = ctc_common.gather_lp_ext(lp, tables)
    pfwd = ctc_loss_plain.forward_scan(lp_ext, tables.skip2, il64, tl64)
    ms = {
        f"ctc_alpha_{name}": time_both(
            f"ctc_alpha_{name}",
            lambda: ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl)),
        f"ctc_alpha_plain_{name}": time_plain(
            lambda: ctc_loss_plain.forward_scan(
                ctc_common.gather_lp_ext(lp, tables), tables.skip2, il64,
                tl64)),
        f"ctc_beta_{name}": time_both(
            f"ctc_beta_{name}", lambda: ctc_loss_cuda.beta_cuda(
                lp, tgt, il, tl, fwd[2], fwd[3], fwd[0], fwd[1])),
        f"ctc_beta_plain_{name}": time_plain(
            lambda: ctc_loss_plain.backward_scan(
                lp_ext, pfwd[2], pfwd[3], pfwd[4], pfwd[1], tables, il64,
                tl64)),
        f"ctc_grad_{name}": time_both(
            f"ctc_grad_{name}",
            lambda: ctc_loss_cuda.grad_cuda(lp, tgt, il, tl, gamma, g)),
        f"ctc_grad_plain_{name}": time_plain(
            lambda: ctc_loss_plain.nll_grad(lp, gamma, tables.ext_labels,
                                            il64, g)),
        f"ctc_loss_grad_{name}": time_ms(
            lambda: nll_and_grad(lp, tgt, il, tl, "pallas")),
        f"ctc_loss_grad_plain_{name}": time_plain(
            lambda: nll_and_grad(lp, tgt, il, tl, "xla")),
        f"ctc_library_fwd_{name}": time_both(
            f"ctc_library_fwd_{name}",
            lambda: library_ctc(lp, *lib_args, grad=False)),
        f"ctc_library_fwd_bwd_{name}": time_both(
            f"ctc_library_fwd_bwd_{name}",
            lambda: library_ctc(lp, *lib_args, grad=True)),
    }
    # K2 in checkpoint mode: each 64-frame chunk's alpha rows recomputed
    # by K1's step
    ck = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl, 0, 64)
    ms[f"ctc_beta_ckpt64_{name}"] = time_both(
        f"ctc_beta_ckpt64_{name}", lambda: ctc_loss_cuda.beta_cuda(
            lp, tgt, il, tl, ck[2], ck[3], ck[0], ck[1], 0, 64))
    return ms


def library_ctc(lp, tgt, il, tl, grad):
    """torch's own CTC loss on the same inputs (the yardstick only): int64
    targets on the card, lengths on the host."""
    x = lp.detach().requires_grad_(grad)
    loss = torch.nn.functional.ctc_loss(x, tgt, il, tl,
                                        reduction="sum", zero_infinity=True)
    if grad:
        loss.backward()
    return loss


def timed(fn, events):
    """fn with CUDA events recorded around each call into `events`."""
    def wrapper(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out
    return wrapper


def time_chunk_split(inputs, lm, W, reps=5):
    """The chunk loop of a chunked decode with CUDA events around it, each
    kernel launch and each piece of the chunk boundary: the lane walk back
    through the chunk's codes (`_chunk_emissions`), the left-justification
    of the emitted tokens (`compact_rows`) and the LM replay
    (`score_chunk`); the rest of the boundary is the LM-state re-homing and
    the bonus update.  Returns the ms of the median rep after a warm-up."""
    pieces = {"lane_walk": (beam_chunked, "_chunk_emissions"),
              "compact": (beam_chunked, "compact_rows"),
              "score_chunk": (lm, "score_chunk")}
    originals = {k: getattr(o, a) for k, (o, a) in pieces.items()}
    rows = []
    for rep in range(reps + 1):
        events = {k: [] for k in ("kernels", *pieces)}
        for k, (obj, attr) in pieces.items():
            setattr(obj, attr, timed(originals[k], events[k]))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run_chunks(inputs, lm, W,
                   timed(beam_search_cuda.beam_step_cuda, events["kernels"]))
        end.record()
        end.synchronize()
        setattr(beam_chunked, "_chunk_emissions", originals["lane_walk"])
        setattr(beam_chunked, "compact_rows", originals["compact"])
        del lm.score_chunk  # the class's method again
        if rep:
            rows.append((start.elapsed_time(end),
                         *(sum(a.elapsed_time(b) for a, b in ev)
                           for ev in events.values())))
    loop, kern, walk, compact, replay = sorted(rows)[reps // 2]
    return {"chunk_loop_b128": loop, "chunk_kernels_b128": kern,
            "chunk_boundary_b128": loop - kern,
            "boundary_lane_walk_b128": walk,
            "boundary_compact_b128": compact,
            "boundary_score_chunk_b128": replay,
            "boundary_other_b128": loop - kern - walk - compact - replay}


def rnnt_problem(rng, dev, b, t, u, v, blank=0, variable=False):
    """Random logits (bench.py's RNN-T row draws them so) and targets;
    with `variable`, random lengths, sample 1's target empty."""
    x = torch.from_numpy(
        rng.standard_normal((b, t, u + 1, v)).astype(np.float32)).to(dev)
    lo, hi = (1, v) if blank == 0 else (0, v - 1)
    tgt = rng.integers(lo, hi, (b, u)).astype(np.int32)
    il, ul = np.full(b, t, np.int32), np.full(b, u, np.int32)
    if variable:
        il = rng.integers(t // 2, t + 1, b).astype(np.int32)
        ul = rng.integers(1, u + 1, b).astype(np.int32)
        il[0], ul[0], ul[1] = t, u, 0
    return (x, *(torch.from_numpy(a).to(dev) for a in (tgt, il, ul)))


def rnnt_nll_and_grad(x, tgt, il, ul, blank, implementation):
    x = x.detach().clone().requires_grad_(True)
    nll = rnnt_nll(x, tgt, il, ul, blank=blank, implementation=implementation)
    nll.sum().backward()
    return nll.detach(), x.grad


def rnnt_dp_inputs(x, tgt, il, ul, blank):
    """The (N, T, U+1) planes the loss's DP sees, and K8's outputs and
    the split logZ on them."""
    y = torch.nn.functional.pad(tgt.long(), (0, 1))
    b_pl, l_pl = rnnt_loss_plain.planes(torch.log_softmax(x.detach(), -1), y,
                                        ul.long(), blank)
    tape, rcum = rnnt_loss_cuda.alpha(b_pl, l_pl)
    zs, zo = rnnt_loss_plain.log_z(b_pl, tape, rcum, il.long(), ul.long())
    return b_pl, l_pl, tape, rcum, il.long(), ul.long(), zs, zo


def check_rnnt(x, tgt, il, ul, blank, what):
    """K8/K9 (through rnnt_nll, from logits) vs the plain float32 and
    float64 scans on the card, and K9 alone vs its plain twin on the same
    residuals.  Returns (nll err, posterior err)."""
    k_nll, k_grad = rnnt_nll_and_grad(x, tgt, il, ul, blank, "pallas")
    p_nll, p_grad = rnnt_nll_and_grad(x, tgt, il, ul, blank, "xla")
    d_nll, d_grad = rnnt_nll_and_grad(x.double(), tgt, il, ul, blank, "xla")
    b_pl, l_pl, tape, rcum, *rest = rnnt_dp_inputs(x, tgt, il, ul, blank)
    p_tape, p_rcum = rnnt_loss_plain.alpha(b_pl, l_pl)
    post = rnnt_loss_cuda.posteriors(b_pl, l_pl, tape, rcum, *rest)
    p_post = rnnt_loss_plain.posteriors(b_pl, l_pl, tape, rcum, *rest)
    torch.cuda.synchronize()
    nll_err = float((k_nll - p_nll).abs().max())
    ulp = float(np.spacing(np.float32(p_nll.abs().max().item())))
    if ((k_nll - p_nll).abs()
            > max(1e-4, 20 * ulp) + CTC_LOSS_RTOL * p_nll.abs()).any():
        raise AssertionError(f"{what}: K8/K9 NLL vs plain, err {nll_err}")
    post_err = max(float((a - b).abs().max()) for a, b in zip(post, p_post))
    if post_err > RNNT_POST_TOL:
        raise AssertionError(f"{what}: K9 posteriors vs plain, err {post_err}")
    grad_err = float((k_grad - p_grad).abs().max())
    if grad_err > CTC_GRAD_TOL or not torch.isfinite(k_grad).all():
        raise AssertionError(f"{what}: K8/K9 grad vs plain, err {grad_err}")
    d_rel = float(((k_nll.double() - d_nll).abs()
                   / d_nll.abs().clamp(min=1.0)).max())
    d_grad_err = float((k_grad.double() - d_grad).abs().max())
    if d_rel > RNNT_F64_TOL or d_grad_err > RNNT_F64_TOL:
        raise AssertionError(f"{what}: float32 kernels vs float64 scan: NLL "
                             f"rel err {d_rel}, grad err {d_grad_err}")
    log(f"{what}: K8/K9 vs plain NLL err {nll_err:.3g} (NLL up to "
        f"{float(p_nll.abs().max()):.1f}), posteriors err {post_err:.3g}, "
        f"logits grad err {grad_err:.3g}; K8 tape err "
        f"{float((tape - p_tape).abs().max()):.3g}, offsets equal "
        f"{bool(torch.equal(rcum, p_rcum))}; vs float64: NLL rel err "
        f"{d_rel:.3g}, grad err {d_grad_err:.3g}")
    return nll_err, post_err


def rnnt_bound(b_pl, posteriors):
    """K8 reads the two (N, T, U+1) planes and writes the (D, N, U+1) tape
    and the (D, N) offsets; K9 reads the planes, the tape and the offsets
    and writes the two posterior planes.  Per lattice node, K8 does ~12
    operations (a logaddexp2, two adds, the renorm's max, subtract and
    clamp), K9 ~30 (two logaddexp2, the two posteriors' sums and exps)."""
    n, t, up = b_pl.shape
    d = t + up - 1
    plane, tape = n * t * up * 4, d * n * up * 4 + d * n * 4
    nbytes = 2 * plane + tape + (2 * plane + n * 16 if posteriors else 0)
    return bound(nbytes, (30 if posteriors else 12) * n * t * up)


def transducer_batches(rng, dev, vocab, n_batches=3):
    """Batches of 8 requests (30/22/15 s, padded to 30 s) as log-mel
    features on the card, with random targets of T'/5 labels."""
    out = []
    for i in range(n_batches):
        secs = np.roll(np.array([30, 22, 15, 30, 22, 15, 22, 15]), i)
        wav = np.zeros((8, 30 * 16000), np.float32)
        for j, s in enumerate(secs):
            wav[j, : s * 16000] = 0.1 * rng.standard_normal(s * 16000)
        feats = log_mel_spectrogram(torch.from_numpy(wav).to(dev))
        lens = num_frames(torch.from_numpy(secs * 16000))
        tl = (((lens + 1) // 2 + 1) // 2 // 5).numpy().astype(np.int32)
        tgt = rng.integers(1, vocab, (8, int(tl.max()))).astype(np.int32)
        out.append((feats, lens, tgt, tl))
    return out


def transducer_grads(model, batch, implementation):
    model.zero_grad()
    loss = model.loss(*batch, implementation=implementation)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()
                           if p.grad is not None}


def check_transducer_batch(model, batch):
    """First batch: CUDA vs CPU loss, kernel vs plain gradients of every
    parameter, and K8/K9 vs plain at this shape.  Returns (nll err,
    posterior err, the DP inputs of this batch)."""
    k_loss, k_grads = transducer_grads(model, batch, "auto")
    p_loss, p_grads = transducer_grads(model, batch, "xla")
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        c_loss = cpu.loss(*batch).item()
    rel = abs(k_loss.item() - c_loss) / abs(c_loss)
    log(f"phase 16 first batch: CUDA loss {k_loss.item():.6f}, CPU loss "
        f"{c_loss:.6f} (rel err {rel:.3g}), plain-path loss "
        f"{p_loss.item():.6f}")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"transducer CUDA loss vs CPU: rel err {rel}")
    worst = 0.0
    for name, kg in k_grads.items():
        # floor 1e-3: the attention key bias's gradient is 0 in exact
        # arithmetic and rounding noise on both paths
        scale = max(float(p_grads[name].abs().max()), 1e-3)
        worst = max(worst, float((kg - p_grads[name]).abs().max()) / scale)
    log(f"phase 16 gradients of {len(k_grads)} tensors, kernels vs plain: "
        f"max err {worst:.3g} of each tensor's max")
    if worst > TRAIN_GRAD_RTOL or set(k_grads) != set(p_grads):
        raise AssertionError(f"transducer grads differ: {worst}")
    with torch.no_grad():
        enc, enc_len = model.encode(batch[0], batch[1])
        x = model.joint_logits(enc, model._pred_states(batch[2]))
    tgt, tl = (torch.as_tensor(a, device=x.device) for a in batch[2:])
    errs = check_rnnt(x, tgt, enc_len, tl, 0,
                      f"phase 16 K8/K9 at the training shape {tuple(x.shape)}")
    return (*errs, rnnt_dp_inputs(x, tgt, enc_len, tl, 0), cpu)


TRANSDUCER_PARTS = ("tr_encoder_fwd_bwd", "tr_predictor_fwd_bwd",
                    "tr_joint_fwd_bwd", "tr_loss_grad", "tr_adamw")


def time_transducer_parts(model, batch):
    """The train step's pieces, each forward + backward on its own (the
    backward seeded with ones): the encoder, the predictor's U-step GRU
    loop, the joint logits, the loss + gradient wrt the logits (K8, K9 and
    the vocabulary prep and combine), and the AdamW update."""
    feats, lens, tgt, tl = batch
    with torch.no_grad():
        enc, enc_len = model.encode(feats, lens)
        hs = model._pred_states(tgt)
        x = model.joint_logits(enc, hs)
    tgt_d, tl_d = (torch.as_tensor(a, device=x.device) for a in (tgt, tl))
    enc, hs = enc.requires_grad_(True), hs.requires_grad_(True)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0)
    return {
        "tr_encoder_fwd_bwd": time_ms(
            lambda: model.encode(feats, lens)[0].sum().backward()),
        "tr_predictor_fwd_bwd": time_ms(
            lambda: model._pred_states(tgt).sum().backward()),
        "tr_joint_fwd_bwd": time_ms(
            lambda: model.joint_logits(enc, hs).sum().backward()),
        "tr_loss_grad": time_ms(
            lambda: rnnt_nll_and_grad(x, tgt_d, enc_len, tl_d, 0, "auto")),
        "tr_adamw": time_ms(opt.step),
    }


def decode_steps(model, feats, lens):
    """How many lockstep joint evaluations the greedy decode makes."""
    enc, enc_len = model.encode(feats, lens)
    pred, h0, joint = model.decoder_fns()
    calls = [0]

    def counted(f, h):
        calls[0] += 1
        return joint.from_projected(f, h)

    counting = copy.copy(joint)
    counting.from_projected = counted
    rnnt_greedy_decode(enc, enc_len, pred, h0, counting)
    return calls[0]


def joint_problem(rng, dev, n, t, u, v, j, blank, bias):
    """bench.py's draw for the fused joint (bench_rnnt_fused_pallas):
    enc_proj and pred_proj standard normal, w_out ~ N(0, 1)/sqrt(J), b_out
    `bias` x N(0, 1) (0 at the bench row), targets in [0, V) without the
    blank, full lengths.  Float32 tensors on the card."""
    enc = rng.standard_normal((n, t, j))
    pred = rng.standard_normal((n, u + 1, j))
    w = rng.standard_normal((j, v)) / np.sqrt(j)
    b = bias * rng.standard_normal(v)
    tgt = rng.integers(1, v, (n, u))
    tgt = np.where(tgt == blank, (blank + 1) % v, tgt).astype(np.int32)
    lens = (np.full(n, t, np.int32), np.full(n, u, np.int32))
    return ([torch.from_numpy(x.astype(np.float32)).to(dev)
             for x in (enc, pred, w, b)],
            *(torch.from_numpy(x).to(dev) for x in (tgt, *lens)))


def joint_inputs(enc, pred, w, b, tgt, blank):
    """The (h, w, b, y, blank) the fused joint's kernels see."""
    n, t, j = enc.shape
    up = pred.shape[1]
    h = torch.tanh(enc[:, :, None] + pred[:, None]).reshape(-1, j)
    y = torch.nn.functional.pad(tgt.long(), (0, up - tgt.shape[1]))
    y = y[:, None, :].expand(n, t, up).reshape(-1).to(torch.int32)
    return h, w, b, y, blank


def joint_cotangents(args, il, ul, shape):
    """The forward's m, log s and the DP's cotangents of the two planes
    (the plain twin's planes through the DP; gb, gl = -posteriors)."""
    b_pl, l_pl, m, logs = rnnt_joint_plain.joint_fwd(
        *args, rows=JOINT_PLAIN_ROWS)
    planes = [p.reshape(shape).requires_grad_(True) for p in (b_pl, l_pl)]
    rnnt_nll_from_planes(*planes, il, ul).sum().backward()
    return m, logs, planes[0].grad.reshape(-1), planes[1].grad.reshape(-1)


def rel_max_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def check_joint(args, stats, what):
    """K10, K11, K12 vs their plain twins on the card.  Returns the max
    abs errors (forward, dh, dW/db)."""
    got = rnnt_joint_cuda.joint_fwd(*args)
    want = rnnt_joint_plain.joint_fwd(*args, rows=JOINT_PLAIN_ROWS)
    dh = rnnt_joint_cuda.joint_dh(*args, *stats)
    p_dh = rnnt_joint_plain.joint_dh(*args, *stats, rows=JOINT_PLAIN_ROWS)
    dw = rnnt_joint_cuda.joint_dw(*args, *stats)
    p_dw = rnnt_joint_plain.joint_dw(*args, *stats, rows=JOINT_PLAIN_ROWS)
    torch.cuda.synchronize()
    fwd_err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    rel = [rel_max_err(dh, p_dh)] + [rel_max_err(g, p)
                                     for g, p in zip(dw, p_dw)]
    log(f"{what}: K10 vs plain max abs err {fwd_err:.3g} (planes, m, log "
        f"s); K11 dh {rel[0]:.3g}, K12 dW {rel[1]:.3g}, db {rel[2]:.3g} of "
        "each tensor's max")
    if fwd_err > JOINT_FWD_TOL or not all(torch.isfinite(g).all()
                                          for g in got):
        raise AssertionError(f"{what}: K10 vs plain, err {fwd_err}")
    if max(rel) > JOINT_GRAD_RTOL:
        raise AssertionError(f"{what}: K11/K12 vs plain, errs {rel}")
    return (fwd_err, float((dh - p_dh).abs().max()),
            max(float((g - p).abs().max()) for g, p in zip(dw, p_dw)))


def fused_grads(loss_fn, params):
    """The mean loss and the four gradients of loss_fn(*params)."""
    xs = [p.detach().clone().requires_grad_(True) for p in params]
    nll = loss_fn(*xs)
    nll.mean().backward()
    return nll.detach(), [x.grad for x in xs]


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-30))


def check_fused_slice(params, tgt, il, ul):
    """Step 1 of the slice: the fused joint's NLL vs the float32 chunked
    loss, and its gradients vs the bf16-joint chunked loss's."""
    enc, pred, w, b = params
    with torch.no_grad():
        ref = rnnt_nll_fused(enc, pred, fused_additive_joint(w, b), tgt, il,
                             ul, chunk_t=FUSED_CHUNK_T)
    got, grads = fused_grads(
        lambda *x: rnnt_nll_fused_pallas(*x, tgt, il, ul), params)
    _, ref_grads = fused_grads(
        lambda e, p, ww, bb: rnnt_nll_fused(
            e, p, fused_additive_joint(ww, bb, matmul_dtype="bfloat16"), tgt,
            il, ul, chunk_t=FUSED_CHUNK_T), params)
    nll_rel = float(((got - ref).abs() / ref.abs()).max())
    log(f"phase 19 step 1: NLL {got.tolist()} vs float32 chunked "
        f"{ref.tolist()}: max rel err {nll_rel:.3g}")
    if nll_rel > FUSED_NLL_RTOL or not torch.isfinite(got).all():
        raise AssertionError(f"fused joint NLL vs float32: {nll_rel}")
    worst = (1.0, 0.0)
    for name, g, r in zip(("enc_proj", "pred_proj", "w_out", "b_out"), grads,
                          ref_grads):
        cos, err = cosine(g, r), rel_max_err(g, r)
        log(f"phase 19 step 1 gradient {name}: cosine {cos:.6f}, max abs "
            f"err {float((g - r).abs().max()):.3g} = {err:.3g} of the max "
            f"{float(r.abs().max()):.3g}, vs the bf16-joint chunked loss")
        worst = (min(worst[0], cos), max(worst[1], err))
    if worst[0] < FUSED_GRAD_COS or worst[1] > FUSED_GRAD_RTOL:
        raise AssertionError(f"fused joint gradients: {worst}")
    return nll_rel, worst


def joint_bound(args, kernel):
    """K10 reads h, W, b and y and writes four (R,) rows; K11 and K12 also
    read m, log s, gb, gl, K11 writes dh (R, J) and K12 dW, db.  K10 does
    2 R J V bf16 tensor-core operations, K11 and K12 twice that (the
    logits again, then d W^T or h^T d); each does R V exps."""
    h, w, _, _, _ = args
    r, j = h.shape
    v = w.shape[1]
    inputs = (r * j + j * v + v + r) * 4
    nbytes = {"fwd": inputs + 4 * r * 4,
              "dh": inputs + 4 * r * 4 + r * j * 4,
              "dw": inputs + 4 * r * 4 + (j * v + v) * 4}[kernel]
    flops = (2 if kernel == "fwd" else 4) * r * j * v
    return bound(nbytes, tensor_ops=flops, exps=r * v)


def library_joint(args, kernel, rows=1 << 14):
    """The bf16 torch.matmul products of one kernel, row-blocked (the
    yardstick only): the logits h W and, for K10, their logsumexp; for K11
    also (logits) W^T, for K12 also h^T (logits)."""
    h, w = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for r0 in range(0, h.shape[0], rows):
        x = h[r0:r0 + rows] @ w
        if kernel == "fwd":
            torch.logsumexp(x, -1)
        elif kernel == "dh":
            x @ w.T
        else:
            acc += h[r0:r0 + rows].T @ x
    return acc


def ctc_grad_bound(lp, tgt, il, tl):
    """The combine writes the (T, N, V) gradient, reads the log-probs and
    gamma of each running frame (t < il) and the targets; one exp per
    running frame and column."""
    t_max, n, v = lp.shape
    il = il.long().clamp(0, t_max)
    frames = int(il.sum())
    states = int((il * (2 * tl.long().clamp(0, tgt.shape[1]) + 1)).sum())
    nbytes = t_max * n * v * 4 + frames * v * 4 + states * 4 + tgt.numel() * 4
    return bound(nbytes, frames * v, exps=frames * v)


def check_bwd_determinism(args, stats, what):
    """K11 and K12, and K11tp and K12tp on each of the D shards, twice on
    the same inputs: dh, dW and db bit-equal."""
    shards = [tp_shard(args, rank) for rank in range(TP_RANKS)]
    runs = [(rnnt_joint_cuda.joint_dh, args), (rnnt_joint_cuda.joint_dw,
                                               args)] + [
        (fn, shard) for shard in shards
        for fn in (rnnt_joint_cuda.joint_dh_tp, rnnt_joint_cuda.joint_dw_tp)]
    for fn, inputs in runs:
        first, second = fn(*inputs, *stats), fn(*inputs, *stats)
        torch.cuda.synchronize()
        if isinstance(first, torch.Tensor):
            first, second = (first,), (second,)
        if not all(torch.equal(a, c) for a, c in zip(first, second)):
            raise AssertionError(f"{what}: {fn.__name__} is not "
                                 "deterministic")
    log(f"{what}: K11, K12 and K11tp, K12tp on each of the {TP_RANKS} "
        "shards, two runs each, dh, dW and db bit-equal")


def plan_line(args, kernel):
    """K10's ("fwd"), K11's ("dh") or K12's ("dw") launch for these
    inputs, as a log line."""
    h, w = args[0], args[1]
    r, j = h.shape
    plan = (rnnt_joint_cuda.dw_plan(r, j, w.shape[1], h.device)
            if kernel == "dw" else
            getattr(rnnt_joint_cuda, f"{kernel}_plan")(r, j, h.device))
    splits = (f"S={plan['splits']} row splits, " if kernel == "dw" else "")
    return (f"{splits}{plan['blocks']} blocks on {plan['sms']} SMs, "
            f"{plan['blocks_per_sm']} blocks per SM, {plan['regs']} "
            f"registers per thread, {plan['spill_bytes']} B spilled, "
            f"{plan['smem']} B shared memory, {plan['stages']} stages"
            + (f", h {'streams' if plan['h_streams'] else 'resident'}"
               if kernel != "dw" else ""))


def k10_vs_wmma(args, raw, what, ref_lib):
    """K10 (K10tp with `raw`) against the wmma K10 it replaced, in device
    time in turns (A B B A), their outputs compared (logged)."""
    fn = rnnt_joint_cuda.joint_fwd_tp if raw else rnnt_joint_cuda.joint_fwd
    wmma = joint_fwd_breakdown.runner(ref_lib, args, raw)
    diff = float((torch.stack(fn(*args)) - wmma()).abs().max())
    log(f"{what} vs the wmma K10: max abs diff {diff:.3g}")
    if diff > 2 * JOINT_FWD_TOL:
        raise AssertionError(f"{what} vs the wmma K10: {diff}")
    in_turns(f"{what} vs the wmma K10 it replaced", {
        "K10": lambda: fn(*args), "wmma K10": wmma}, 5)


def check_ctc_determinism(lp, tgt, il, tl, what):
    """Two gradients through K1, K2 and the combine bit-equal; the combine
    vs the plain combine on the same gamma.  Returns its max abs err."""
    runs = [nll_and_grad(lp, tgt, il, tl, "pallas")[1] for _ in range(2)]
    z, ne, a, an = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl)
    gamma = ctc_loss_cuda.beta_cuda(lp, tgt, il, tl, a, an, z, ne)
    g = torch.ones(lp.shape[1], device=lp.device)
    got = ctc_loss_cuda.grad_cuda(lp, tgt, il, tl, gamma, g)
    ext = ctc_common.build_ctc_tables(tgt, tl, 0, lp.shape[-1]).ext_labels
    want = ctc_loss_plain.nll_grad(lp, gamma, ext, il.long(), g)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"{what}: two gradients bit-equal: {torch.equal(*runs)}; the "
        f"combine vs the plain scatter_add_ combine max abs err {err:.3g}")
    if not (torch.equal(*runs) and torch.equal(got, runs[0])):
        raise AssertionError(f"{what}: the CTC gradient is not deterministic")
    if err > CTC_GRAD_TOL:
        raise AssertionError(f"{what}: the combine vs plain, err {err}")
    return err


def tp_shard(args, rank):
    """Rank `rank`'s (h, w, b, y, blank) of D=TP_RANKS: its W and b
    columns, the labels and blank shard-relative (-1 elsewhere)."""
    h, w, b, y, blank = args
    vl = w.shape[1] // TP_RANKS
    lo = rank * vl
    y = torch.where((y >= lo) & (y < lo + vl), y - lo, -1).to(torch.int32)
    return (h, w[:, lo:lo + vl].contiguous(), b[lo:lo + vl].contiguous(),
            y, blank - lo if lo <= blank < lo + vl else -1)


def check_joint_tp(args, stats, what):
    """K10tp, K11tp, K12tp on each shard vs their TP twins, and the shards
    combined vs K10-K12 unsharded.  Returns the max abs errors vs the
    twins (forward, dh, dW/db)."""
    errs = [0.0, 0.0, 0.0]
    fwd, dh, dw, db = [], 0.0, [], []
    for rank in range(TP_RANKS):
        shard = tp_shard(args, rank)
        got = rnnt_joint_cuda.joint_fwd_tp(*shard)
        want = rnnt_joint_plain.joint_fwd_tp(*shard, rows=JOINT_PLAIN_ROWS)
        s_dh = rnnt_joint_cuda.joint_dh_tp(*shard, *stats)
        p_dh = rnnt_joint_plain.joint_dh_tp(*shard, *stats,
                                            rows=JOINT_PLAIN_ROWS)
        s_dw = rnnt_joint_cuda.joint_dw_tp(*shard, *stats)
        p_dw = rnnt_joint_plain.joint_dw_tp(*shard, *stats,
                                            rows=JOINT_PLAIN_ROWS)
        torch.cuda.synchronize()
        fwd_err = max(float((g - p).abs().max()) for g, p in zip(got, want))
        rel = [rel_max_err(s_dh, p_dh)] + [rel_max_err(g, p)
                                           for g, p in zip(s_dw, p_dw)]
        if fwd_err > JOINT_FWD_TOL or max(rel) > JOINT_GRAD_RTOL:
            raise AssertionError(f"{what} shard {rank}: K10tp-K12tp vs their"
                                 f" twins, errs {fwd_err}, {rel}")
        errs = [max(errs[0], fwd_err),
                max(errs[1], float((s_dh - p_dh).abs().max())),
                max([errs[2]] + [float((g - p).abs().max())
                                 for g, p in zip(s_dw, p_dw)])]
        fwd.append(got)
        dh, dw, db = dh + s_dh, dw + [s_dw[0]], db + [s_dw[1]]
    xb, xy, m_l, logs_l = (torch.stack(c) for c in zip(*fwd))
    m = m_l.amax(0)
    logs = torch.log(torch.exp(logs_l + (m_l - m)).sum(0))
    combined = ((xb.sum(0) - m) - logs, (xy.sum(0) - m) - logs, m, logs)
    whole = rnnt_joint_cuda.joint_fwd(*args)
    u_dh = rnnt_joint_cuda.joint_dh(*args, *stats)
    u_dw, u_db = rnnt_joint_cuda.joint_dw(*args, *stats)
    torch.cuda.synchronize()
    c_err = max(float((g - p).abs().max()) for g, p in zip(combined, whole))
    c_rel = [rel_max_err(dh, u_dh), rel_max_err(torch.cat(dw, 1), u_dw),
             rel_max_err(torch.cat(db), u_db)]
    log(f"{what}: K10tp-K12tp vs their twins max abs errs {errs[0]:.3g} "
        f"(forward), {errs[1]:.3g} (dh), {errs[2]:.3g} (dW, db); the {TP_RANKS}"
        f" shards combined vs K10-K12 unsharded: forward {c_err:.3g}, summed "
        f"dh {c_rel[0]:.3g}, dW {c_rel[1]:.3g}, db {c_rel[2]:.3g} of each "
        "tensor's max")
    if c_err > JOINT_FWD_TOL or max(c_rel) > JOINT_GRAD_RTOL:
        raise AssertionError(f"{what}: shards combined vs unsharded, errs "
                             f"{c_err}, {c_rel}")
    return errs


def tp_rank(rank, tmp):
    """One rank of the vocabulary-parallel slice (a spawned process): 3
    AdamW steps on its shard through rnnt_nll_fused_pallas_vocab_parallel;
    the counters, losses, step times and step 1's NLL and gradients to
    tmp/rank{rank}.pt."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=TP_RANKS, rank=rank,
                            timeout=TP_TIMEOUT)
    try:
        dev = torch.device("cuda", 0)
        prob = torch.load(f"{tmp}/problem.pt")
        enc, pred, w, b, tgt, il, ul = (prob[k].to(dev) for k in (
            "enc", "pred", "w", "b", "tgt", "il", "ul"))
        v = w.shape[1]
        vl = v // TP_RANKS
        lo = rank * vl
        params = [torch.nn.Parameter(x) for x in (
            enc, pred, w[:, lo:lo + vl].clone(), b[lo:lo + vl].clone())]
        opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)

        def full(x):  # this rank's shard in place, zeros elsewhere
            return torch.nn.functional.pad(x, (lo, v - lo - vl))

        counters = (rnnt_joint_cuda.launches, rnnt_loss_cuda.launches)
        torch.cuda.synchronize()
        for counts in counters:
            for k in counts:
                counts[k] = 0
        losses, step_s, first = [], [], None
        for step in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            opt.zero_grad()
            nll = rnnt_nll_fused_pallas_vocab_parallel(
                params[0], params[1], full(params[2]), full(params[3]), tgt,
                il, ul)
            nll.mean().backward()
            if step == 0:
                first = [nll.detach().clone()] + [p.grad.clone()
                                                  for p in params]
            opt.step()
            losses.append(nll.mean().item())
            step_s.append(time.perf_counter() - t0)
        launches = {**counters[0], **counters[1]}
        torch.save({"launches": launches, "losses": losses,
                    "step_s": step_s, "first": [x.cpu() for x in first]},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def check_tp_slice(params, tgt, il, ul):
    """Phase 24: spawn the ranks, hold step 1 against the unsharded fused
    loss.  Returns (the ranks' results, NLL rel err, worst gradient err)."""
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        torch.save({"enc": params[0].detach().cpu(),
                    "pred": params[1].detach().cpu(),
                    "w": params[2].detach().cpu(),
                    "b": params[3].detach().cpu(), "tgt": tgt.cpu(),
                    "il": il.cpu(), "ul": ul.cpu()}, f"{tmp}/problem.pt")
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(tmp,), nprocs=TP_RANKS, join=True)
        wall = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/rank{r}.pt") for r in range(TP_RANKS)]
    ref, ref_grads = fused_grads(
        lambda *x: rnnt_nll_fused_pallas(*x, tgt, il, ul), params)
    ref, ref_grads = ref.cpu(), [g.cpu() for g in ref_grads]
    firsts = [r["first"] for r in res]
    for r, f in enumerate(firsts):
        if not all(torch.equal(a, c) for a, c in zip(f[:3], firsts[0][:3])):
            raise AssertionError(f"rank {r}'s NLL or enc/pred gradient "
                                 "differs from rank 0's")
    got = firsts[0][0]
    grads = [firsts[0][1], firsts[0][2], torch.cat([f[3] for f in firsts], 1),
             torch.cat([f[4] for f in firsts])]
    nll_rel = float(((got - ref).abs() / ref.abs()).max())
    errs = [rel_max_err(g, w) for g, w in zip(grads, ref_grads)]
    cos = min(cosine(g, w) for g, w in zip(grads, ref_grads))
    log(f"phase 24 {TP_RANKS} gloo ranks on one card, spawned and joined in "
        f"{wall:.1f} s; step 1 vs the unsharded rnnt_nll_fused_pallas: NLL "
        f"max rel err {nll_rel:.3g}; gradients enc_proj {errs[0]:.3g}, "
        f"pred_proj {errs[1]:.3g}, w_out {errs[2]:.3g}, b_out {errs[3]:.3g} "
        f"of each tensor's max, least cosine {cos:.8f}")
    if nll_rel > TP_NLL_RTOL or not torch.isfinite(got).all():
        raise AssertionError(f"TP slice NLL vs unsharded: {nll_rel}")
    if max(errs) > FUSED_GRAD_RTOL or cos < FUSED_GRAD_COS:
        raise AssertionError(f"TP slice gradients vs unsharded: {errs}, "
                             f"cosine {cos}")
    want = {"joint_fwd": 0, "joint_dh": 0, "joint_dw": 0, "joint_fwd_tp": 3,
            "joint_dh_tp": 3, "joint_dw_tp": 3, "rnnt_alpha": 3,
            "rnnt_posteriors": 3}
    for r, x in enumerate(res):
        log(f"phase 24 rank {r}: losses {[round(v, 6) for v in x['losses']]}"
            f", step wall s {[round(v, 4) for v in x['step_s']]}, launches "
            f"{x['launches']}")
        if x["launches"] != want:
            raise AssertionError(f"rank {r}: kernels missed on the TP path: "
                                 f"{x['launches']}")
        if not all(np.isfinite(v) and v > 0 for v in x["losses"]):
            raise AssertionError(f"rank {r}: bad TP loss {x['losses']}")
    return res, nll_rel, max(errs)


def main() -> None:
    # 1. the device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    # 2. the card
    card = nvidia_smi()
    log(f"phase 2 card: {card}")
    # 3. the build
    # and, beside it, the two-barrier K1 that K1 replaced (the A/B baseline)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref_build = pool.submit(ctc_alpha_breakdown.build_reference,
                                cuda_build.BUILD_DIR / "reference")
        k10_build = pool.submit(joint_fwd_breakdown.build_reference,
                                cuda_build.BUILD_DIR / "reference_k10")
        _, info = cuda_build.library()
        ref_lib, ref_ptxas = ref_build.result()
        k10_ref_lib, k10_ref_ptxas = k10_build.result()
    log(f"phase 3 build: {info['build_s']:.1f} s nvcc, "
        f"{time.perf_counter() - t0:.1f} s to load ({info['path']})")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            log(f"  ptxas {line.strip()}")
    for line in ref_ptxas:
        log(f"  ptxas (the two-barrier K1) {line}")
    for line in k10_ref_ptxas:
        log(f"  ptxas (the wmma K10) {line}")
    rng = np.random.default_rng(SEED)

    # 4. top-k kernel vs plain
    topk_err = check_topk(rng, dev, [(1000, 32, 1024, 24), (750, 8, 32, 24)])
    # 5. beam kernel vs plain at the beam decoder's reference shape
    beam_err, beam_inputs = check_beam(rng, dev, 1000, 32, 1024, 8, 16)

    # 6. the serving slice
    cfg = PipelineConfig()  # vocab 32, d 256, 4 layers, 4 heads, 80 mels
    # the default device: a user's ConformerCTCPipeline(cfg) is on the card
    pipe = ConformerCTCPipeline(cfg,
                                generator=torch.Generator().manual_seed(SEED))
    if pipe.device != dev:
        raise AssertionError(f"the pipeline was built on {pipe.device}")
    pipe.eval()
    sr = cfg.sample_rate
    pad = 30 * sr
    batches = []
    for i in range(3):
        secs = np.array([30, 22, 15, 30, 22, 15, 22, 15])
        secs = np.roll(secs, i)
        wav = np.zeros((8, pad), np.float32)
        for j, s in enumerate(secs):
            wav[j, : s * sr] = 0.1 * rng.standard_normal(s * sr)
        batches.append((wav, (secs * sr).astype(np.int32)))
    torch.cuda.synchronize()
    topk_cuda.launches = 0
    beam_search_cuda.launches = 0
    results = []
    for wav, ns in batches:
        greedy = pipe.decode(wav, ns, beam_width=0)
        beam = pipe.decode(wav, ns, beam_width=8, prune_k=16)
        results.append((greedy, beam))
    torch.cuda.synchronize()
    launches = {"topk": topk_cuda.launches,
                "beam_step": beam_search_cuda.launches}
    log(f"phase 6 serving: pipeline built on {pipe.device} by default; 3 "
        f"batches x 8 requests, launches {launches}")
    if launches != {"topk": 3, "beam_step": 3}:
        raise AssertionError(f"kernels missed on the serving path: {launches}")
    for (g_tok, g_len, g_sc), (b_tok, b_len, b_sc) in results:
        if b_tok.shape[0] != 8 or g_tok.shape[0] != 8:
            raise AssertionError("wrong batch size out of decode")
        if not (torch.isfinite(g_sc).all() and torch.isfinite(b_sc).all()):
            raise AssertionError("non-finite best score")
    log("phase 6 best scores finite; mean best-beam length "
        f"{float(results[0][1][1].float().mean()):.1f} tokens")

    wav, ns = batches[0]
    with torch.no_grad():
        logits, out_len = pipe.encode(wav, ns)
        lp_gpu = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
        pipe_cpu = copy.deepcopy(pipe).cpu()
        logits_c, out_len_c = pipe_cpu.encode(wav, ns)
        lp_cpu = torch.log_softmax(logits_c, -1).transpose(0, 1)
    lp_err = float((lp_gpu.cpu() - lp_cpu).abs().max())
    log(f"phase 6 CUDA vs CPU log-probs: max abs err {lp_err:.3g}")
    if lp_err > LOGP_TOL or not torch.equal(out_len.cpu(), out_len_c):
        raise AssertionError(f"CUDA log-probs differ from CPU: {lp_err}")
    il = serve_il = out_len.to(torch.int32)
    s_cap = min(lp_gpu.shape[0], 512)
    kern = beam_sets(*beam_search_decode(lp_gpu, il, beam_width=8,
                                         prune_k=16))
    plain = beam_sets(*plain_beam_decode(lp_gpu, il, 8, 16, s_cap))
    beam_err = max(beam_err, compare_beams(kern, plain,
                                           "serving beam, kernel vs plain"))
    log("phase 6 serving beam: kernel best hypotheses == plain path")

    # 7. timings
    ms = {}
    for name, (t, b, v) in {"main": (lp_gpu.shape[0], 8, cfg.vocab_size),
                            "ref": (1000, 32, 1024)}.items():
        x = torch.from_numpy(
            rng.standard_normal((t, b, v)).astype(np.float32)).to(dev)
        ks = min(24, v)
        ms[f"topk_{name}"] = time_both(f"topk_{name}",
                                       lambda: topk_cuda.topk_cuda(x, ks))
        ms[f"topk_plain_{name}"] = time_ms(lambda: topk_cuda.topk_plain(x, ks))
        ms[f"topk_library_{name}"] = time_both(f"topk_library_{name}",
                                               lambda: torch.topk(x, ks))
        in_turns(f"phase 7 K3 vs torch.topk ({name}: T={t}, B={b}, V={v}, "
                 f"k={ks})", {"K3": lambda: topk_cuda.topk_cuda(x, ks),
                              "torch.topk": lambda: torch.topk(x, ks)}, 200)
        if name == "main":
            topk_b = topk_bound(x, ks)
    lpk, ck, lpb, il_ref, s_cap_ref = beam_inputs
    ms["beam_ref"] = time_ms(lambda: beam_search_cuda.beam_step_cuda(
        lpk, ck, lpb, il_ref, 8, 16, s_cap_ref, 0))
    ms["beam_plain_ref"] = time_plain(
        lambda: beam_search_cuda.beam_step_plain(lpk, ck, lpb, il_ref, 8, 16,
                                                 s_cap_ref, 0))
    bp, score, _, _ = beam_search_cuda.beam_step_cuda(lpk, ck, lpb, il_ref,
                                                      8, 16, s_cap_ref, 0)
    ms["backtrace_ref"] = time_ms(lambda: beam_search_cuda.backtrace(
        bp, ck, score, 8, 16, s_cap_ref))
    mlpk, mck = topk_cuda.topk_cuda(lp_gpu, 24)
    mlpb = lp_gpu[:, :, 0].contiguous()
    ms["beam_main"] = time_both(
        "beam_main", lambda: beam_search_cuda.beam_step_cuda(
            mlpk, mck, mlpb, il, 8, 16, s_cap, 0))
    ms["beam_plain_main"] = time_plain(
        lambda: beam_search_cuda.beam_step_plain(mlpk, mck, mlpb, il, 8, 16,
                                                 s_cap, 0))
    beam_b = beam_bound(mlpk, il, 8, 16)
    bp, score, _, _ = beam_search_cuda.beam_step_cuda(mlpk, mck, mlpb, il, 8,
                                                      16, s_cap, 0)
    ms["backtrace_main"] = time_ms(lambda: beam_search_cuda.backtrace(
        bp, mck, score, 8, 16, s_cap))
    ms["encode_b8_30s"] = time_ms(lambda: pipe.encode(wav, ns))
    ms["decode_greedy_b8_30s"] = time_ms(
        lambda: pipe.decode(wav, ns, beam_width=0))
    ms["decode_beam8_b8_30s"] = time_ms(
        lambda: pipe.decode(wav, ns, beam_width=8, prune_k=16))
    for k, val in ms.items():
        log(f"phase 7 time {k}: {val:.3f} ms")
    for mode in ("greedy", "beam8"):
        log(f"phase 7 pipeline {mode}: B=8 x 30 s, "
            f"{ms[f'decode_{mode}_b8_30s']:.3f} ms per batch, "
            f"{8e3 / ms[f'decode_{mode}_b8_30s']:.1f} seq/s")

    # 8. CTC kernels vs plain at the loss's reference shapes
    ctc_err = [0.0, 0.0]
    ctc_inputs = {}
    for name, (b, t, s, v) in CTC_SHAPES.items():
        lp_np, tgt_np, il_np, tl_np = ctc_problem(rng, b, t, s, v)
        args = (torch.from_numpy(lp_np).to(dev),
                *(torch.from_numpy(a).to(dev) for a in (tgt_np, il_np,
                                                        tl_np)))
        ctc_inputs[name] = args
        errs = check_ctc(*args, f"phase 8 {name} (B={b}, T={t}, S={s}, "
                                f"V={v})", ref_lib)
        ctc_err = [max(a, e) for a, e in zip(ctc_err, errs)]

    # 9. the training slice
    tpipe = ConformerCTCPipeline(
        cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    tbatches = training_batches(rng, cfg)
    errs = check_training_batch(tpipe, tbatches[0], ref_lib)
    ctc_err = [max(a, e) for a, e in zip(ctc_err, errs)]
    opt = torch.optim.AdamW(tpipe.parameters(), lr=1e-3, weight_decay=1e-4)
    torch.cuda.synchronize()
    for k in ctc_loss_cuda.launches:
        ctc_loss_cuda.launches[k] = 0
    losses = []
    for batch in tbatches:
        opt.zero_grad()
        loss = tpipe.loss(*batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    train_launches = dict(ctc_loss_cuda.launches)
    log(f"phase 9 training: 3 AdamW steps x 8 requests, losses "
        f"{[round(x, 6) for x in losses]}, launches {train_launches}")
    if train_launches != {"ctc_alpha": 3, "ctc_beta": 3, "ctc_grad": 3}:
        raise AssertionError(
            f"kernels missed on the training path: {train_launches}")
    if not all(np.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"bad training loss: {losses}")

    # 10. CTC and training timings
    for name, args in (("metric", ctc_inputs["metric"]),
                       ("main", train_shape_inputs(tpipe, tbatches[0]))):
        lp, tgt, il, tl = args
        ms.update(time_ctc(name, lp, tgt, il, tl))
        b, t = lp.shape[1], lp.shape[0]
        lib_args = (tgt.long(), il.long().cpu(), tl.long().cpu())
        in_turns(f"phase 10 K1 vs the two-barrier K1 and F.ctc_loss forward "
                 f"({name}: B={b}, T={t}, S={tgt.shape[1]})", {
                     "K1": lambda: ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl),
                     "two-barrier K1": ctc_alpha_breakdown.runner(
                         ref_lib, False, args),
                     "F.ctc_loss fwd": lambda: library_ctc(
                         lp, *lib_args, grad=False)}, 20)
        if name == "main":
            log("phase 10 the card running K1 back to back (main): "
                + card_under_load(
                    lambda: ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl)))
        cells = b * t * (2 * tgt.shape[1] + 1)
        for k in ("ctc_alpha", "ctc_alpha_plain", "ctc_beta",
                  "ctc_beta_ckpt64", "ctc_beta_plain", "ctc_grad",
                  "ctc_grad_plain",
                  "ctc_loss_grad", "ctc_loss_grad_plain",
                  "ctc_library_fwd", "ctc_library_fwd_bwd"):
            log(f"phase 10 {k}_{name} (B={b}, T={t}, S={tgt.shape[1]}): "
                f"{ms[f'{k}_{name}']:.3f} ms, "
                f"{cells / ms[f'{k}_{name}'] / 1e3:.1f} M lattice cells/s")
        if name == "main":
            ctc_b = [ctc_bound(lp, tgt, il, tl, beta) for beta in (0, 1)]
            ctc_grad_b = ctc_grad_bound(lp, tgt, il, tl)

    def train_step():
        opt.zero_grad()
        tpipe.loss(*tbatches[0]).backward()
        opt.step()

    ms["train_step_b8_30s"] = time_ms(train_step)
    log(f"phase 10 train step: B=8 x 30 s, {ms['train_step_b8_30s']:.3f} "
        f"ms, {8e3 / ms['train_step_b8_30s']:.1f} seq/s")

    # 11. K5 vs plain at the LM-fused decoder's reference shape
    W, K = 8, 16
    k5_err, _ = check_beam_lm(rng, dev, 1000, 32, 29, W, K)

    # 12. the chunked LM decode: K7, with K5 or K6 inside it for a guide
    spellings = seeded_lexicon(rng, 29)
    word_lm = seeded_word_lm(rng, spellings, 29, dev)
    lp29 = torch.from_numpy(word_lattice(rng, 1000, 32, 29,
                                         spellings)).to(dev)
    lm1024 = seeded_bigram(rng, 1024, dev)
    t0 = time.perf_counter()
    guide1024 = QuantizedBigramGuide.from_bigram(lm1024, n_classes=63)
    log(f"phase 12 QuantizedBigramGuide.from_bigram (V=1024, 63 classes): "
        f"{time.perf_counter() - t0:.1f} s")
    lp1024 = torch.from_numpy(peaked_lattice(rng, 1000, 32, 1024)).to(dev)
    il32 = torch.from_numpy(
        rng.integers(500, 1001, 32).astype(np.int32)).to(dev)
    chunked = {  # name: (log-probs, lm, guide)
        "word LM, V=29": (lp29, word_lm, None),
        "word LM + bigram guide, V=29": (lp29, word_lm,
                                         seeded_bigram(rng, 29, dev)),
        "bigram LM + 63-class guide, V=1024": (lp1024, lm1024, guide1024),
    }
    torch.cuda.synchronize()
    reset_counts()
    main_outs = {
        name: beam_search_decode(lp, il32, beam_width=W, prune_k=K, lm=lm,
                                 lm_alpha=LM_ALPHA, lm_beta=LM_BETA,
                                 implementation="chunked",
                                 lm_chunk_t=CHUNK_T, guide_lm=guide)
        for name, (lp, lm, guide) in chunked.items()}
    torch.cuda.synchronize()
    chunk_launches = beam_counts()
    log(f"phase 12 chunked decodes (3 x B=32, T=1000): launches "
        f"{chunk_launches}")
    n_chunks = -(-1000 // CHUNK_T)
    if chunk_launches != {"launches": 3 * n_chunks,
                          "launches_lm": n_chunks, "launches_cls": n_chunks,
                          "launches_resume": 3 * n_chunks}:
        raise AssertionError(f"kernels missed on the chunked path: "
                             f"{chunk_launches}")
    chunk_err, chunk_inputs = 0.0, {}
    for name, (lp, lm, guide) in chunked.items():
        chunk_inputs[name] = chunked_inputs(lp, il32, guide, W, K)
        chunk_err = max(chunk_err, check_chunked(
            name, chunk_inputs[name], lm, main_outs[name], W, K))

    # 13. the serving slice with an LM
    lm32 = seeded_bigram(rng, cfg.vocab_size, dev)
    torch.cuda.synchronize()
    reset_counts()
    lm_results = [pipe.decode(wav_b, ns_b, beam_width=W, prune_k=K, lm=lm32,
                              lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
                  for wav_b, ns_b in batches]
    torch.cuda.synchronize()
    lm_launches = {"topk": topk_cuda.launches, **beam_counts()}
    log(f"phase 13 serving with an LM: 3 batches x 8 requests, launches "
        f"{lm_launches}")
    if lm_launches != {"topk": 3, "launches": 3, "launches_lm": 3,
                       "launches_cls": 0, "launches_resume": 0}:
        raise AssertionError(f"kernels missed on the LM serving path: "
                             f"{lm_launches}")
    for tok, _, sc in lm_results:
        if tok.shape[0] != 8 or not torch.isfinite(sc).all():
            raise AssertionError("bad LM decode output")
    kern = beam_sets(*beam_search_decode(lp_gpu, serve_il, beam_width=W,
                                         prune_k=K, lm=lm32,
                                         lm_alpha=LM_ALPHA, lm_beta=LM_BETA))
    plain = beam_sets(*plain_beam_decode(lp_gpu, serve_il, W, K, s_cap,
                                         lm=lm32))
    k5_err = max(k5_err, compare_beams(kern, plain,
                                       "serving LM beam, kernel vs plain"))
    log("phase 13 serving LM beam: kernel best hypotheses == plain path")

    # 14. LM timings
    inc32 = LM_ALPHA * lm32._table + LM_BETA
    margs = (mlpk, mck, mlpb, serve_il, W, K, s_cap, 0)
    ms["beam_lm_main"] = time_both(
        "beam_lm_main",
        lambda: beam_search_cuda.beam_step_cuda(*margs, inc=inc32))
    ms["beam_lm_plain_main"] = time_plain(
        lambda: beam_search_cuda.beam_step_plain(*margs, inc=inc32))
    lm_b = beam_bound(mlpk, serve_il, W, K, inc=inc32)
    first = {}  # the first chunk's kernel inputs, resumed from the start
    for name in ("word LM, V=29", "bigram LM + 63-class guide, V=1024"):
        lpk, ck, lpb, il_c, inc, cls_map = chunk_inputs[name]
        first[name] = ((lpk[:CHUNK_T], ck[:CHUNK_T], lpb[:CHUNK_T], il_c, W,
                        K, min(lpk.shape[0], 512), 0),
                       dict(inc=inc, cls_map=cls_map,
                            state_in=beam_search_cuda.beam_state_init(
                                W, lpk.shape[1], dev)))
    for key, name in (("resume", "word LM, V=29"),
                      ("cls", "bigram LM + 63-class guide, V=1024")):
        args, kw = first[name]
        ms[f"beam_{key}_chunk"] = time_both(
            f"beam_{key}_chunk",
            lambda: beam_search_cuda.beam_step_cuda(*args, **kw))
        ms[f"beam_{key}_plain_chunk"] = time_plain(
            lambda: beam_search_cuda.beam_step_plain(*args, **kw))
    args, kw = first["word LM, V=29"]
    resume_b = beam_bound(args[0], args[3], W, K, resume=True)
    args, kw = first["bigram LM + 63-class guide, V=1024"]
    cls_b = beam_bound(args[0], args[3], W, K, inc=kw["inc"],
                       cls_map=kw["cls_map"], resume=True)

    lm29 = seeded_bigram(rng, 29, dev)
    lp128 = torch.from_numpy(peaked_lattice(rng, 1000, 128, 29)).to(dev)
    il128 = torch.full((128,), 1000, dtype=torch.int32, device=dev)
    ms["decode_lm_fused_b128"] = time_ms(lambda: beam_search_decode(
        lp128, il128, beam_width=W, prune_k=K, lm=lm29, lm_alpha=LM_ALPHA,
        lm_beta=LM_BETA))
    # its stages: the top-k, K5 and the backtrace
    ms["topk_b128"] = time_both("topk_b128",
                                lambda: topk_cuda.topk_cuda(lp128, K + 8))
    lpk, ck = topk_cuda.topk_cuda(lp128, K + 8)
    bargs = (lpk, ck, lp128[:, :, 0].contiguous(), il128, W, K, 512, 0)
    inc29 = LM_ALPHA * lm29._table + LM_BETA
    ms["beam_lm_b128"] = time_ms(
        lambda: beam_search_cuda.beam_step_cuda(*bargs, inc=inc29))
    bp, score, _, _ = beam_search_cuda.beam_step_cuda(*bargs, inc=inc29)
    ms["backtrace_b128"] = time_ms(
        lambda: beam_search_cuda.backtrace(bp, ck, score, W, K, 512))
    lpw128 = torch.from_numpy(word_lattice(rng, 1000, 128, 29,
                                           spellings)).to(dev)
    ms["decode_word_chunked_b128"] = time_ms(lambda: beam_search_decode(
        lpw128, il128, beam_width=W, prune_k=K, lm=word_lm,
        lm_alpha=LM_ALPHA, lm_beta=LM_BETA, implementation="chunked",
        lm_chunk_t=CHUNK_T))
    ms.update(time_chunk_split(chunked_inputs(lpw128, il128, None, W, K),
                               word_lm, W))
    ms["decode_beam8_lm_b8_30s"] = time_ms(lambda: pipe.decode(
        wav, ns, beam_width=W, prune_k=K, lm=lm32, lm_alpha=LM_ALPHA,
        lm_beta=LM_BETA))
    for k in ("beam_lm_main", "beam_lm_plain_main", "beam_resume_chunk",
              "beam_resume_plain_chunk", "beam_cls_chunk",
              "beam_cls_plain_chunk", "decode_lm_fused_b128", "topk_b128",
              "beam_lm_b128", "backtrace_b128", "decode_word_chunked_b128",
              "chunk_loop_b128", "chunk_kernels_b128", "chunk_boundary_b128",
              "boundary_lane_walk_b128", "boundary_compact_b128",
              "boundary_score_chunk_b128", "boundary_other_b128",
              "decode_beam8_lm_b8_30s"):
        log(f"phase 14 time {k}: {ms[k]:.3f} ms")
    for k, b in (("decode_lm_fused_b128", 128),
                 ("decode_word_chunked_b128", 128),
                 ("decode_beam8_lm_b8_30s", 8)):
        log(f"phase 14 {k}: {b * 1e3 / ms[k]:.1f} seq/s")

    # 15. RNN-T kernels K8/K9 vs plain at the bench row's shape and three
    # edge batches (U > T with variable lengths and an empty target,
    # blank = V-1)
    rnnt_err = [0.0, 0.0]
    rnnt_inputs = {}
    for name, (b, t, u, v, blank, var) in RNNT_SHAPES.items():
        args = rnnt_problem(rng, dev, b, t, u, v, blank, var)
        rnnt_inputs[name] = (*args, blank)
        errs = check_rnnt(*args, blank, f"phase 15 {name} (B={b}, T={t}, "
                                        f"U={u}, V={v}, blank={blank})")
        rnnt_err = [max(a, e) for a, e in zip(rnnt_err, errs)]

    # 16. the transducer training slice at full width
    tcfg = TransducerConfig()  # vocab 32, d 144, 2 layers, joint 128
    model = ConformerTransducer(tcfg, seed=SEED)
    if model.device != dev:
        raise AssertionError(f"the transducer was built on {model.device}")
    xbatches = transducer_batches(rng, dev, tcfg.vocab_size)
    *errs, main_dp, model_cpu = check_transducer_batch(model, xbatches[0])
    rnnt_err = [max(a, e) for a, e in zip(rnnt_err, errs)]
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    torch.cuda.synchronize()
    for k in rnnt_loss_cuda.launches:
        rnnt_loss_cuda.launches[k] = 0
    losses = []
    for batch in xbatches:
        opt.zero_grad()
        loss = model.loss(*batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    rnnt_launches = dict(rnnt_loss_cuda.launches)
    log(f"phase 16 training: 3 AdamW steps x 8 requests, lattice "
        f"{tuple(main_dp[0].shape)} x V={tcfg.vocab_size}, losses "
        f"{[round(x, 6) for x in losses]}, launches {rnnt_launches}")
    if rnnt_launches != {"rnnt_alpha": 3, "rnnt_posteriors": 3}:
        raise AssertionError(
            f"kernels missed on the transducer path: {rnnt_launches}")
    if not all(np.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"bad transducer loss: {losses}")
    feats, lens = xbatches[0][:2]
    tok, tlen, tsc = model.decode(feats, lens)
    cap = tok.shape[1]
    if (tlen > cap).any() or not torch.isfinite(tsc).all():
        raise AssertionError("bad greedy transducer decode")
    model_cpu.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    c_tok, c_len, _ = model_cpu.decode(feats, lens)
    same = sum(torch.equal(tok[i, : int(tlen[i])].cpu(),
                           c_tok[i, : int(c_len[i])]) for i in range(8))
    log(f"phase 16 greedy decode: B=8, cap {cap}, lengths "
        f"{tlen.tolist()}, scores finite; {same} of 8 requests decode to "
        "the same tokens on the card and on the CPU")

    # 17. RNN-T timings: K8, K9 and their twins at the training shape and
    # the bench row's, the loss+gradient, the train step and the decode
    for name, dp in (("main", main_dp),
                     ("bench", rnnt_dp_inputs(*rnnt_inputs["bench"]))):
        b_pl, l_pl, tape, rcum, *rest = dp
        ms[f"rnnt_alpha_{name}"] = time_both(
            f"rnnt_alpha_{name}",
            lambda: rnnt_loss_cuda.alpha(b_pl, l_pl))
        ms[f"rnnt_alpha_plain_{name}"] = time_plain(
            lambda: rnnt_loss_plain.alpha(b_pl, l_pl))
        ms[f"rnnt_posteriors_{name}"] = time_both(
            f"rnnt_posteriors_{name}",
            lambda: rnnt_loss_cuda.posteriors(b_pl, l_pl, tape, rcum, *rest))
        ms[f"rnnt_posteriors_plain_{name}"] = time_plain(
            lambda: rnnt_loss_plain.posteriors(b_pl, l_pl, tape, rcum,
                                               *rest))
        if name == "main":
            rnnt_b = [rnnt_bound(b_pl, post) for post in (0, 1)]
    x, tgt, il, ul, blank = rnnt_inputs["bench"]
    for impl, key in (("pallas", ""), ("xla", "_plain")):
        ms[f"rnnt_loss_grad{key}_bench"] = time_ms(
            lambda: rnnt_nll_and_grad(x, tgt, il, ul, blank, impl))
    cells = x.shape[0] * x.shape[1] * x.shape[2]

    def transducer_step():
        opt.zero_grad()
        model.loss(*xbatches[0]).backward()
        opt.step()

    ms["transducer_step_b8_30s"] = time_ms(transducer_step)
    ms.update(time_transducer_parts(model, xbatches[0]))
    ms["transducer_greedy_b8_30s"] = time_ms(
        lambda: model.decode(feats, lens))
    steps = decode_steps(model, feats, lens)
    log(f"phase 17 greedy decode: {steps} lockstep joint steps, "
        f"{ms['transducer_greedy_b8_30s'] / steps:.3f} ms each")
    for k in ("rnnt_alpha_main", "rnnt_alpha_plain_main",
              "rnnt_posteriors_main", "rnnt_posteriors_plain_main",
              "rnnt_alpha_bench", "rnnt_alpha_plain_bench",
              "rnnt_posteriors_bench", "rnnt_posteriors_plain_bench",
              "rnnt_loss_grad_bench", "rnnt_loss_grad_plain_bench",
              "transducer_step_b8_30s", *TRANSDUCER_PARTS,
              "transducer_greedy_b8_30s"):
        log(f"phase 17 time {k}: {ms[k]:.3f} ms")
    for k in ("rnnt_loss_grad_bench", "rnnt_loss_grad_plain_bench"):
        log(f"phase 17 {k} (B=8, T=400, U=80, V=256): "
            f"{cells / ms[k] / 1e3:.1f} M lattice cells/s")
    for k in ("transducer_step_b8_30s", "transducer_greedy_b8_30s"):
        log(f"phase 17 {k}: {8e3 / ms[k]:.1f} seq/s")

    # 18. the fused joint's kernels K10-K12 vs their plain twins
    joint_err = [0.0, 0.0, 0.0]
    for name, (n, t, u, v, j, blank, bias) in JOINT_SHAPES.items():
        params, tgt, il, ul = joint_problem(rng, dev, n, t, u, v, j, blank,
                                            bias)
        args = joint_inputs(*params, tgt, blank)
        stats = joint_cotangents(args, il, ul, (n, t, u + 1))
        errs = check_joint(args, stats, f"phase 18 {name} (R={n * t * (u + 1)}"
                                        f", J={j}, V={v}, blank={blank})")
        joint_err = [max(a, e) for a, e in zip(joint_err, errs)]

    # 19. the fused-joint slice: 3 AdamW steps at the bench row (the last
    # problem of phase 18)
    params = [torch.nn.Parameter(x) for x in params]
    fused_nll_err, fused_grad_err = check_fused_slice(params, tgt, il, ul)
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)
    torch.cuda.synchronize()
    for counts in (rnnt_joint_cuda.launches, rnnt_loss_cuda.launches):
        for k in counts:
            counts[k] = 0
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = rnnt_nll_fused_pallas(*params, tgt, il, ul).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    joint_launches = {**rnnt_joint_cuda.launches, **rnnt_loss_cuda.launches}
    log(f"phase 19 fused joint: 3 AdamW steps at B={n}, T={t}, U={u}, "
        f"V={v}, J={j}, losses {[round(x, 6) for x in losses]}, launches "
        f"{joint_launches}")
    if joint_launches != {"joint_fwd": 3, "joint_dh": 3, "joint_dw": 3,
                          "joint_fwd_tp": 0, "joint_dh_tp": 0,
                          "joint_dw_tp": 0, "rnnt_alpha": 3,
                          "rnnt_posteriors": 3}:
        raise AssertionError(
            f"kernels missed on the fused-joint path: {joint_launches}")
    if not all(np.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"bad fused-joint loss: {losses}")

    # 20. fused-joint timings at the bench row
    args = joint_inputs(*(p.detach() for p in params), tgt, blank)
    stats = joint_cotangents(args, il, ul, (n, t, u + 1))
    for kernel, fn in (("fwd", "joint_fwd"), ("dh", "joint_dh"),
                       ("dw", "joint_dw")):
        extra = () if kernel == "fwd" else stats
        ms[f"joint_{kernel}_bench"] = time_both(
            f"joint_{kernel}_bench",
            lambda: getattr(rnnt_joint_cuda, fn)(*args, *extra))
        ms[f"joint_{kernel}_plain_bench"] = time_plain(
            lambda: getattr(rnnt_joint_plain, fn)(*args, *extra,
                                                  rows=JOINT_PLAIN_ROWS))
        ms[f"joint_{kernel}_library_bench"] = time_both(
            f"joint_{kernel}_library_bench",
            lambda: library_joint(args, kernel))
    joint_b = {k: joint_bound(args, k) for k in ("fwd", "dh", "dw")}

    def fused_loss_grad(loss_fn):
        return lambda: fused_grads(loss_fn, params)

    ms["fused_pallas_loss_grad_bench"] = time_ms(fused_loss_grad(
        lambda *x: rnnt_nll_fused_pallas(*x, tgt, il, ul)))
    ms["fused_f32_chunked_loss_grad_bench"] = time_ms(fused_loss_grad(
        lambda e, p, ww, bb: rnnt_nll_fused(
            e, p, fused_additive_joint(ww, bb), tgt, il, ul,
            chunk_t=FUSED_CHUNK_T)))
    gh = torch.ones((n, t, u + 1, j), device=dev)

    def joint_glue():
        """The torch work of one fused loss+gradient outside the kernels
        (bar the label rows, 1 MB): the activation forward and backward,
        the bf16 casts of h and W made by each of the three kernel calls,
        and the W tiles and log2 bias of K10's and of K11's."""
        e, p = (x.detach().requires_grad_(True) for x in params[:2])
        h = torch.tanh(e[:, :, None] + p[:, None])
        h.backward(gh)
        for _ in range(3):
            h.detach().to(torch.bfloat16)
            wb, vp = rnnt_joint_cuda._bf16_w(params[2].detach(), v)
        for _ in range(2):
            rnnt_joint_cuda.w_tiles(wb, j)
            rnnt_joint_cuda.dh_bias(params[3].detach(), vp)

    ms["fused_glue_bench"] = time_ms(joint_glue)
    cells = n * t * (u + 1)
    for k in ("joint_fwd_bench", "joint_fwd_plain_bench",
              "joint_fwd_library_bench", "joint_dh_bench",
              "joint_dh_plain_bench", "joint_dh_library_bench",
              "joint_dw_bench", "joint_dw_plain_bench",
              "joint_dw_library_bench", "fused_pallas_loss_grad_bench",
              "fused_glue_bench", "fused_f32_chunked_loss_grad_bench"):
        log(f"phase 20 time {k}: {ms[k]:.3f} ms")
    for k in ("fwd", "dh", "dw"):
        log(f"phase 20 bound joint_{k}: {joint_b[k][0]:.3f} ms "
            f"({joint_b[k][1]})")
    log(f"phase 20 K10's plan at the bench row: {plan_line(args, 'fwd')}")
    log("phase 20 the card running K10 back to back: " + card_under_load(
        lambda: rnnt_joint_cuda.joint_fwd(*args)))
    k10_vs_wmma(args, 0, "phase 20 K10", k10_ref_lib)
    log(f"phase 20 K11's plan at the bench row: {plan_line(args, 'dh')}")
    log("phase 20 the card running K11 back to back: " + card_under_load(
        lambda: rnnt_joint_cuda.joint_dh(*args, *stats)))
    log(f"phase 20 K12's plan at the bench row: {plan_line(args, 'dw')}")
    log("phase 20 the card running K12 back to back: " + card_under_load(
        lambda: rnnt_joint_cuda.joint_dw(*args, *stats)))
    for k in ("fused_pallas_loss_grad_bench",
              "fused_f32_chunked_loss_grad_bench"):
        log(f"phase 20 {k} (B={n}, T={t}, U={u}, V={v}, J={j}): "
            f"{cells / ms[k] / 1e3:.1f} M lattice cells/s")

    # 21. J > 128: K10-K12 in 128-row J slabs vs their twins
    for name, (n2, t2, u2, v2, j2, blank2, bias) in JOINT_WIDE_SHAPES.items():
        wparams, wtgt, wil, wul = joint_problem(rng, dev, n2, t2, u2, v2, j2,
                                                blank2, bias)
        wargs = joint_inputs(*wparams, wtgt, blank2)
        wstats = joint_cotangents(wargs, wil, wul, (n2, t2, u2 + 1))
        errs = check_joint(wargs, wstats, f"phase 21 {name} (R="
                           f"{n2 * t2 * (u2 + 1)}, J={j2}, V={v2}, "
                           f"blank={blank2})")
        joint_err = [max(a, e) for a, e in zip(joint_err, errs)]
    for kernel, fn in (("fwd", "joint_fwd"), ("dh", "joint_dh"),
                       ("dw", "joint_dw")):
        extra = () if kernel == "fwd" else wstats
        ms[f"joint_{kernel}_j256_bench"] = time_ms(
            lambda: getattr(rnnt_joint_cuda, fn)(*wargs, *extra))
        ms[f"joint_{kernel}_plain_j256_bench"] = time_plain(
            lambda: getattr(rnnt_joint_plain, fn)(*wargs, *extra,
                                                  rows=JOINT_PLAIN_ROWS))
        b_ms, b_by = joint_bound(wargs, kernel)
        log(f"phase 21 time joint_{kernel} at the bench row with J=256: "
            f"{ms[f'joint_{kernel}_j256_bench']:.3f} ms (plain "
            f"{ms[f'joint_{kernel}_plain_j256_bench']:.3f} ms, bound "
            f"{b_ms:.3f} ms by {b_by})")
    del wparams, wargs, wstats

    # 22. the CTC gradient's combine: deterministic at the metric shape
    combine_err = check_ctc_determinism(
        *ctc_inputs["metric"], "phase 22 CTC gradient at the metric shape "
        "(B=32, T=1000, S=100, V=1024)")
    check_bwd_determinism(args, stats, f"phase 22 K11 and K12 at the bench "
                          f"row (R={args[0].shape[0]}, J={j}, V={v})")

    # 23. K10tp-K12tp, D shards one after another, vs their TP twins and,
    # combined, vs K10-K12 unsharded
    tp_err = [0.0, 0.0, 0.0]
    tp_problems = {}
    for name, (n2, t2, u2, v2, j2, blank2, bias) in TP_SHAPES.items():
        tparams, ttgt, til, tul = joint_problem(rng, dev, n2, t2, u2, v2, j2,
                                                blank2, bias)
        targs = joint_inputs(*tparams, ttgt, blank2)
        tp_problems[name] = (targs, joint_cotangents(targs, til, tul,
                                                     (n2, t2, u2 + 1)))
    tp_problems["bench"] = (args, stats)  # phase 20's
    for name, (targs, tstats) in tp_problems.items():
        h2, w2 = targs[0], targs[1]
        errs = check_joint_tp(targs, tstats, f"phase 23 {name} (R="
                              f"{h2.shape[0]}, J={h2.shape[1]}, V="
                              f"{w2.shape[1]}, D={TP_RANKS}, blank="
                              f"{targs[4]})")
        tp_err = [max(a, e) for a, e in zip(tp_err, errs)]

    # 24. the vocabulary-parallel slice: 4 gloo ranks on the one card
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tp_res, tp_nll_err, tp_grad_err = check_tp_slice(params, tgt, il, ul)
    tp_launches = {k: sum(r["launches"][k] for r in tp_res)
                   for k in ("joint_fwd_tp", "joint_dh_tp", "joint_dw_tp")}
    ms["tp_step_wall_4ranks_bench"] = 1e3 * statistics.median(
        max(r["step_s"][i] for r in tp_res) for i in range(3))
    log(f"phase 24 the 4-rank step (gloo through the host on one card, the "
        "slowest rank, median of 3 steps): "
        f"{ms['tp_step_wall_4ranks_bench']:.3f} ms")

    # 25. TP timings at the bench row, per shard
    for rank in range(TP_RANKS):
        shard = tp_shard(args, rank)
        for kernel in ("fwd", "dh", "dw"):
            extra = () if kernel == "fwd" else stats
            fn = getattr(rnnt_joint_cuda, f"joint_{kernel}_tp")
            ms[f"joint_{kernel}_tp{rank}_bench"] = time_both(
                f"joint_{kernel}_tp{rank}_bench",
                lambda: fn(*shard, *extra))
        if rank == 0:
            shard0 = shard
            for kernel in ("fwd", "dh", "dw"):
                extra = () if kernel == "fwd" else stats
                fn = getattr(rnnt_joint_plain, f"joint_{kernel}_tp")
                ms[f"joint_{kernel}_tp_plain_bench"] = time_plain(
                    lambda: fn(*shard, *extra, rows=JOINT_PLAIN_ROWS))
                ms[f"joint_{kernel}_tp_library_bench"] = time_both(
                    f"joint_{kernel}_tp_library_bench",
                    lambda: library_joint(shard, kernel))
    tp_b = {k: joint_bound(shard0, k) for k in ("fwd", "dh", "dw")}
    for kernel in ("fwd", "dh", "dw"):
        per = [ms[f"joint_{kernel}_tp{r}_bench"] for r in range(TP_RANKS)]
        ms[f"joint_{kernel}_tp_bench"] = per[0]
        DEVICE_MS[f"joint_{kernel}_tp_bench"] = DEVICE_MS[
            f"joint_{kernel}_tp0_bench"]
        ms[f"joint_{kernel}_tp_sum_bench"] = sum(per)
        log(f"phase 25 time joint_{kernel}_tp per shard (V/D="
            f"{shard0[1].shape[1]}): {[round(x, 3) for x in per]} ms, sum "
            f"{sum(per):.3f} ms vs unsharded {ms[f'joint_{kernel}_bench']:.3f}"
            f" ms; plain {ms[f'joint_{kernel}_tp_plain_bench']:.3f} ms; bf16 "
            f"matmul yardstick {ms[f'joint_{kernel}_tp_library_bench']:.3f} "
            f"ms; bound {tp_b[kernel][0]:.3f} ms by {tp_b[kernel][1]}")
    log(f"phase 25 K10tp's plan per shard: {plan_line(shard0, 'fwd')}")
    log("phase 25 the card running K10tp back to back: " + card_under_load(
        lambda: rnnt_joint_cuda.joint_fwd_tp(*shard0)))
    k10_vs_wmma(shard0, 1, "phase 25 K10tp (shard 0)", k10_ref_lib)
    log("phase 25 the card running K11tp back to back: " + card_under_load(
        lambda: rnnt_joint_cuda.joint_dh_tp(*shard0, *stats)))
    log(f"phase 25 K11tp's plan per shard: {plan_line(shard0, 'dh')}; the "
        f"{TP_RANKS} shards' K11tp {ms['joint_dh_tp_sum_bench']:.3f} ms = "
        f"{ms['joint_dh_tp_sum_bench'] / ms['joint_dh_bench']:.3f} x K11")
    log("phase 25 the card running K12tp back to back: " + card_under_load(
        lambda: rnnt_joint_cuda.joint_dw_tp(*shard0, *stats)))
    log(f"phase 25 K12tp's plan per shard: {plan_line(shard0, 'dw')}; the "
        f"{TP_RANKS} shards' K12tp {ms['joint_dw_tp_sum_bench']:.3f} ms = "
        f"{ms['joint_dw_tp_sum_bench'] / ms['joint_dw_bench']:.3f} x K12")
    for name in ("metric", "main"):
        log(f"phase 25 time the CTC combine ({name}): "
            f"{ms[f'ctc_grad_{name}']:.3f} ms vs the scatter_add_ combine "
            f"{ms[f'ctc_grad_plain_{name}']:.3f} ms")
    log(f"phase 25 bound ctc_grad (main): {ctc_grad_b[0]:.4f} ms "
        f"({ctc_grad_b[1]})")
    log(json.dumps({"card": card, "ms": ms, "device_ms": DEVICE_MS}))

    beam_src = "end2end_tpu_torch/csrc/beam_step.cu"
    beam_tpu = "end2end_tpu/ops/beam_search_pallas.py"
    ctc_src = "end2end_tpu_torch/csrc/ctc_loss.cu"
    rnnt_src = "end2end_tpu_torch/csrc/rnnt_loss.cu"
    rnnt_tpu = "end2end_tpu/ops/rnnt_loss_pallas.py"
    joint_src = "end2end_tpu_torch/csrc/rnnt_joint.cu"
    joint_tpu = "end2end_tpu/ops/rnnt_joint_pallas.py"
    rows = [  # name, source, replaces, launches, err, ms key, bound,
        # library key
        ("topk", "end2end_tpu_torch/csrc/topk.cu",
         "end2end_tpu/ops/topk_pallas.py:64", launches["topk"], topk_err,
         "topk_main", topk_b, "topk_library_main"),
        ("beam_step", beam_src, f"{beam_tpu}:94", launches["beam_step"],
         beam_err, "beam_main", beam_b, None),
        ("ctc_alpha", ctc_src, "end2end_tpu/ops/ctc_loss_pallas.py:115",
         train_launches["ctc_alpha"], ctc_err[0], "ctc_alpha_main", ctc_b[0],
         "ctc_library_fwd_main"),
        ("ctc_beta", ctc_src, "end2end_tpu/ops/ctc_loss_pallas.py:174",
         train_launches["ctc_beta"], ctc_err[1], "ctc_beta_main", ctc_b[1],
         "ctc_library_fwd_bwd_main"),
        ("beam_step_lm", beam_src, f"{beam_tpu}:202",
         lm_launches["launches_lm"], k5_err, "beam_lm_main", lm_b, None),
        ("beam_step_cls", beam_src, f"{beam_tpu}:101",
         chunk_launches["launches_cls"], chunk_err, "beam_cls_chunk", cls_b,
         None),
        ("beam_step_resume", beam_src, f"{beam_tpu}:129",
         chunk_launches["launches_resume"], chunk_err, "beam_resume_chunk",
         resume_b, None),
        # torch has no transducer loss (and torchaudio is not installed)
        ("rnnt_alpha", rnnt_src, f"{rnnt_tpu}:108",
         rnnt_launches["rnnt_alpha"], rnnt_err[0], "rnnt_alpha_main",
         rnnt_b[0], None),
        ("rnnt_posteriors", rnnt_src, f"{rnnt_tpu}:194",
         rnnt_launches["rnnt_posteriors"], rnnt_err[1],
         "rnnt_posteriors_main", rnnt_b[1], None),
        ("rnnt_joint_fwd", joint_src, f"{joint_tpu}:78",
         joint_launches["joint_fwd"], joint_err[0], "joint_fwd_bench",
         joint_b["fwd"], "joint_fwd_library_bench"),
        ("rnnt_joint_dh", joint_src, f"{joint_tpu}:114",
         joint_launches["joint_dh"], joint_err[1], "joint_dh_bench",
         joint_b["dh"], "joint_dh_library_bench"),
        ("rnnt_joint_dw", joint_src, f"{joint_tpu}:152",
         joint_launches["joint_dw"], joint_err[2], "joint_dw_bench",
         joint_b["dw"], "joint_dw_library_bench"),
        # launches: all ranks of phase 24; times: shard 0 of the bench row
        ("rnnt_joint_fwd_tp", joint_src, f"{joint_tpu}:376",
         tp_launches["joint_fwd_tp"], tp_err[0], "joint_fwd_tp_bench",
         tp_b["fwd"], "joint_fwd_tp_library_bench"),
        ("rnnt_joint_dh_tp", joint_src, f"{joint_tpu}:411",
         tp_launches["joint_dh_tp"], tp_err[1], "joint_dh_tp_bench",
         tp_b["dh"], "joint_dh_tp_library_bench"),
        ("rnnt_joint_dw_tp", joint_src, f"{joint_tpu}:445",
         tp_launches["joint_dw_tp"], tp_err[2], "joint_dw_tp_bench",
         tp_b["dw"], "joint_dw_tp_library_bench"),
        ("ctc_grad", ctc_src, "end2end_tpu/ops/ctc_loss_xla.py:196",
         train_launches["ctc_grad"], combine_err, "ctc_grad_main",
         ctc_grad_b, None),
    ]
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": err, "ms": DEVICE_MS[key][0],
         "ms_method": DEVICE_MS[key][1], "call_ms": ms[key],
         "plain_ms": ms[key.replace("_main", "_plain_main").replace(
             "_chunk", "_plain_chunk").replace("_bench", "_plain_bench")],
         "bound_ms": b[0],
         "bound_by": "bytes" if b[1] == "bytes" else "operations",
         "library_ms": DEVICE_MS[lib][0] if lib else None,
         "library_call_ms": ms[lib] if lib else None}
        for name, src, rep, n, err, key, b, lib in rows]
    for k in kernels:
        log(f"device time {k['name']}: {k['ms']:.4f} ms ({k['ms_method']}; "
            f"one call {k['call_ms']:.4f}), bound {k['bound_ms']:.4f}, "
            f"library {k['library_ms']} ms (one call "
            f"{k['library_call_ms']})")
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel never ran on its path: {kernels}")
    log("chip_smoke: done")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

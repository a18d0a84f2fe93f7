"""Drive the PyTorch/CUDA port's serving and training paths (CTC,
transducer and the fused transducer joint; forced alignment and MWER
fine-tuning; LM fusion with hashed, composite and neural LMs; transducer
beam, streaming and long-form decoding; the OCR recognizer and the
Dense-front-end transducer; data-, vocabulary- and time-parallel losses
and decoders over processes sharing the card; tracing, checkpoints, the
C++ host runtime, the float64 oracles and the examples) once on one GPU
and check them.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (every failure raises, so the exit code is nonzero):
  1. a CUDA device must be present;
  2. print the card's name and power limit (nvidia-smi);
  3. build the CUDA kernels from end2end_tpu_torch/csrc (nvcc, sm_90a),
     and beside them the two-barrier K1 and K2 that K1 and K2 replaced
     (tools/ctc_alpha_reference.cu, tools/ctc_beta_reference.cu), the
     baselines of phases 8-10, the wmma K10 that K10 replaced
     (tools/joint_fwd_reference.cu), the
     baseline of phases 20 and 25, the warp-per-sequence beam kernel
     that the beam step replaced (tools/beam_step_reference.cu), the
     baseline of phases 5, 7, 11, 12 and 14, the block-per-sequence
     K8/K9 that K8 and K9 replaced (tools/rnnt_loss_reference.cu), the
     baseline of phases 15-17, and the K3 that K3 replaced
     (tools/topk_reference.cu), the baseline of phases 4 and 7;
  4. top-k kernel vs its plain version and the parent K3 at the beam
     decoder's reference shape (V=1024, k=24), the serving slice's (V=32),
     the LM decode's at B=128 (V=29) and the beam-16 row's k=40: values
     and indices bit-equal;
  5. beam-step kernel vs its plain version and vs the parent kernel on
     peaked lattices at the beam decoder's reference shape (B=32, T=1000,
     V=1024, beam 8, prune 16) and at bench.py's beam-16 row (beam 16,
     prune 32): backpointer codes, scores and the 10-field state
     bit-identical, same best hypotheses, beam-set scores within 1e-4;
     the prefix-beam scan on the card (V=1024 with the default prune_k,
     outside the kernel's envelope): no beam kernel launched, finite
     scores, and 'xla' gives the same;
  6. the serving slice: the full-width Conformer-CTC pipeline (vocab 32,
     d 256, 4 layers, 4 heads, 80 mels, seeded random weights, built on
     the card by default, with no device argument) answers three
     batches of 8 requests of mixed length (padded to 30 s) with greedy and
     beam-8 / prune-16 decoding; the launch counters must show the top-k,
     the beam step and the backtrace kernel once per beam batch; one
     batch's log-probs must match the same model on the CPU within
     1e-3, and on them the kernels' best hypotheses must equal the plain
     path's;
  7. timings with CUDA events (median of 5 after warm-up), and in device
     time, in turns (A B B A): K3 against the parent K3 and torch.topk at
     phase 4's four shapes (bit-equal first), the beam step (K4) against
     the parent kernel at the serving slice's shape and at the beam-16 row
     (also as microseconds a frame; and one call at the beam-16 row); the
     backtrace kernel equal to
     backtrace_plain with the host walk (tokens, lengths, scores, times)
     and the lane-walk kernel equal to lane_walk_plain (lane0, the
     frame-aligned tokens, their counts) on the serving slice's, the
     reference shape's and the beam-16 row's codes, their device times
     and one calls beside the host walks';
  8. CTC alpha (K1) and beta (K2) kernels vs their plain versions at the
     loss's reference shapes (metric B=32 T=1000 S=100 V=1024,
     librispeech-char B=32 T=1000 S=200 V=29, bpe-asr B=16 T=1500 S=150
     V=1024; variable lengths, one infeasible sample): losses within
     max(1e-4, 20 ulp) abs and 2e-6 rel of the plain float32 scan,
     gradients within 1e-5; the float32 gradient within 1e-4 of the
     plain float64 scan or at least as accurate as torch's own CTC loss;
     checkpoint_every 0 and 64 give bit-identical losses and gamma; K1's
     outputs (tape and checkpoint rows, norms, z_hat, norm_end2) bit-equal
     to the two-barrier K1's, and K2's gamma to the two-barrier K2's in
     the tape and checkpoint (64 frames) modes; K2's branch-free log1p
     bit-equal to libm's log1pf on every float in [0, 4);
  9. the training slice: the full-width pipeline takes 3 AdamW steps on
     batches of 8 requests (30/22/15 s, padded to 30 s) with random
     targets; the launch counters must show K1 and K2 once per step and
     every loss finite and > 0; on the first batch the CUDA loss must be
     within 1e-3 rel of the CPU model's, the encoder's gradients through
     the kernels within 1e-4 (of each tensor's max) of those through the
     plain scan, and K1/K2 within phase 8's tolerances (and bit-equal to
     the two-barrier K1/K2) at this shape;
 10. timings: K1, K2 and the plain scans at the metric shape (also as
     lattice cells/s) and at the training slice's shape, the loss+gradient
     both ways, torch's own CTC loss forward, forward+backward and
     backward alone (beside K2 + the combine in device time), and the
     whole train step, and K2 in checkpoint mode (64 frames); K1, the
     two-barrier K1 and F.ctc_loss forward in device time, in turns; K2
     against the two-barrier K2 in turns (also as cycles a frame), in the
     tape and checkpoint (64 frames) modes; the card's SM clock and power
     under K1 and under K2;
 11. the beam kernel's in-kernel bigram mode (K5) vs its plain twin at
     B=32, T=1000, V=29, beam 8, prune 16 (seeded bigram LM, alpha 0.6,
     beta 0.3): backpointer codes and the 10-field state identical to
     the plain twin's and the parent kernel's, same best hypotheses,
     beam-set scores within 1e-4;
 12. the chunked LM decode (chunks of 128 frames, B=32, T=1000, beam 8,
     prune 16) three ways: a 2000-word bigram LM over V=29; the same
     steered by a symbol-keyed bigram guide (K5 inside K7); a dense bigram
     LM at V=1024 steered by its 63-class QuantizedBigramGuide (K6 inside
     K7).  Driven through `beam_search_decode(implementation='chunked')`
     with the launch counters read around it, then kernels vs the plain
     twin and vs the parent kernel on the card: every chunk's codes and
     the final state identical, same hypotheses; the lane walk launched
     once per chunk and the backtrace kernel once per decode;
 13. the serving slice with an LM: the pipeline of phase 6 decodes the
     same 3 batches with beam 8, prune 16 and a seeded bigram LM over its
     32 symbols; the counters must show the top-k kernel, K5 and the
     backtrace kernel once per batch, and on one batch the kernels' best
     hypotheses must equal the plain path's;
 14. timings: K5, K6, K7 alone vs their plain twins and, in device time
     in turns, vs the parent kernel (also as microseconds a frame), the
     LM-fused and the
     chunked word-LM decodes at B=128, T=1000, V=29 (seq/s; the chunked
     one split into kernel and chunk-boundary time), the pipeline's LM
     decode at B=8 x 30 s, and torch.topk beside K3; the lane walk equal
     to the host walk on the first chunk of two of phase 12's decodes
     (timed on the word LM's), and the backtrace kernel checked and timed
     at B=128 as in phase 7;
 15. the RNN-T alpha (K8) and posterior (K9) kernels vs the plain scans at
     the JAX bench row's shape (B=8, T=400, U=80, V=256, random logits,
     from logits) and two edge batches (U > T with variable lengths and an
     empty target; blank = V-1): NLL within max(1e-4, 20 ulp) abs + 2e-6
     rel, K9's posteriors on the same residuals within 1e-6, the logits
     gradient within 1e-5; against the plain float64 scan the gradient
     within 1e-4 and the NLL within 1e-4 relative; K8's tape and offsets
     and K9's posteriors bit-equal to the parent kernels';
 16. the transducer training slice: the full-width ConformerTransducer
     (vocab 32, 80 mels, d 144, 2 layers, 4 heads, conv 15, enc 144, emb
     64, GRU 128, joint 128; seeded random weights, built on the card by
     default) takes 3 AdamW steps on batches of 8 requests (30/22/15 s as
     log-mel features, padded to 30 s, T'=750) with random targets of
     T'/5 labels (lattice (8, 750, 151, 32)); the counters must show K8
     and K9 once per step, the predictor's GRU kernels (phase 37) once a
     direction per step, and every loss finite and > 0; on the first
     batch the CUDA loss within 1e-3 rel of the CPU model's, every
     parameter's gradient through the kernels within 1e-4 (of its max)
     of the plain scan's, and K8/K9 within phase 15's tolerances (and
     bit-equal to the parent kernels) at this shape; then greedy decoding
     (lengths within the cap, finite scores, the count of requests
     decoding alike on the card and the CPU);
 17. timings: K8, K9 and their twins at the training and bench shapes,
     K8 and K9 against the parent kernels in device time, in turns (their
     outputs bit-equal), with cycles a diagonal,
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
     the combine against the `scatter_add_` combine;
 26. the CTC forced alignment kernel (csrc/ctc_align.cu) vs align_plain on
     the card: through `ctc_forced_alignment` on phase 6's first batch of
     pipeline log-probs with random targets of T'/5 labels (the main
     path's run: one launch), and at BASELINE config 2's shape (B=32,
     T=1000, S=200, V=29, peaked lattices, variable lengths, an infeasible
     sample, an empty target, an input length of 0); labels, positions
     and the scores' bits equal; each request's greedy transcript,
     force-aligned by the kernel and by align_plain, scores the sum of its
     frames' maxima (within 1e-4 of the float32 sum in frame order);
 27. the MWER fine-tuning slice: a fresh full-width pipeline takes 3 AdamW
     steps on `pipeline.loss(...) + 0.5 * mwer_loss(log_probs, ...,
     beam_width=4, prune_k=16)` on phase 9's batches; the counters must
     show K3, K4 and the backtrace kernel once a step, K1, K2 and the
     combine twice, and every loss finite; before that, step 1's MWER term
     on the card's N-best through the kernels against the plain scan:
     loss within 1e-5 relative, posterior within 1e-5, errors equal, the
     encoder's gradients within 1e-4 of each tensor's max; on phase 6's
     first batch `greedy_decode_with_confidence` card vs CPU (tokens,
     lengths, times equal, confidences within 1e-6), one request's
     `word_confidences` and SRT, and `collapse_and_bucket` then the beam
     decode on the kept frames (K3, K4 once);
 28. timings: the alignment kernel (device and one call) and align_plain
     at both shapes with the bound; the MWER step and its parts (the
     N-best decode, the scoring on N*W rows forward and backward,
     batch_edit_distance, word_id_hashes, the rest);
     greedy_decode_with_confidence; blank_collapse;
 29. the hashed-LM serving slice: phase 6's 3 batches, encoded, decode
     with `beam_search_decode(implementation='chunked', beam_width=8,
     prune_k=16, lm_chunk_t=128, lm_alpha=0.8, lm_beta=0.4)`, the LM a
     `CompositeLM` of a 2000-word hashed word trigram over a seeded
     lexicon (drawn as bench.py's, separator 31) and a `HotwordBoostLM`
     of 5 lexicon words, the guide a 15-class `QuantizedBigramGuide`; the
     counters must show K3 once a batch, the class-keyed step (K6 in K7)
     and the lane walk once a chunk and the backtrace once a decode; on
     batch 0 the kernels against the plain top-k, step, walk and
     backtrace on the card, and the decode on the CPU: the same best
     hypotheses and beam sets, scores within SCORE_TOL; `rescore_nbest`
     of a no-LM beam-8 decode (K3, K4, the backtrace once a batch) by the
     word trigram, a `NeuralLM.gru` and the trigram without score_chunk
     (the per-token route): card against CPU and the two routes against
     each other within RESCORE_TOL; a Kneser-Ney trigram from
     `train_ngram_lm` on a seeded corpus through `HashedNGramLM` and the
     per-frame scan (`implementation='xla'`) on batch 0, card against
     CPU;
 30. timings: bench.py's word-trigram chunked row (B=128, T=1000, V=29,
     beam 8, prune 16, max_symbols 256, chunk 128, bench.py's 2000-word
     trigram and lattice; the chunk loop split into its kernels and its
     boundary, `score_chunk` alone; the plain chunk loop once) and its
     rescore row (the no-LM decode, then `rescore_nbest`), seq/s;
     `score_chunk` on one chunk's tokens (device time and one call);
     phase 29's decode of one batch;
 31. the transducer decoding slice, on a freshly seeded ConformerTransducer
     of phase 16's configuration, its blank logit biased by 1.7 (phase
     16's steps teach that model to emit blanks only; unbiased, a fresh
     one fills its hypotheses on the first frames) and phase 16's first
     batch (B=8 x 30 s, T'=750,
     symbol cap 256), and at bench.py's `_rnnt_decoder` shapes (B=16,
     T=400, V=256, GRU-256, joint 256, s_cap 128): with the counters at 0,
     the model's ALSD beam-4 decode and with a seeded dense bigram LM
     (alpha 0.5, beta 0.2), the rnnt_beam4 and rnnt_beam4+bigramLM rows,
     greedy lookahead 8 at blank bias 1.1, the streaming transducer greedy
     and beam-4 decoders on 40-frame chunks, and
     `transcribe_long_form_rnnt` (greedy, beam 4) on 60 s of features; K3
     must have run.  The long form must equal the one-shot greedy and
     beam-4 decodes of its chunks' trimmed encoder outputs stitched
     (tokens and length, a non-empty transcript, the score within 1e-5
     relative).  Then each ALSD decode with K3 against the same with
     `topk_plain` on the card (every output bit-equal); greedy lookahead 8
     equal to lookahead 1; the card against the CPU on the same encoder
     outputs (the requests whose best hypotheses agree, their scores
     within 1e-3); the streaming decoders against their one-shot decodes
     on the card (the transducer's, and the CTC greedy and beam-8 ones on
     the pipeline's log-probs of phase 29; tokens, lengths, times equal,
     score differences logged); one `rnnt_mwer_loss` step through the
     model (beam 4): finite loss and gradients, K8 and K9 launched 4 times
     each (once a hypothesis); the MWER term after its decode on the
     card's N-best of 4 requests (the best hypotheses as references) on
     the card and on the CPU in float32, each against a float64 CPU
     witness: the loss within 1e-3 relative, each hypothesis's score
     within 1e-5 relative, the errors equal, and the card's gradients
     within RNNT_MWER_GRAD_TOL of their norms (the CPU's float32 error
     logged beside it);
 32. timings (CUDA events, median of 5, seq/s): rnnt_beam4 and +bigramLM
     with their sequential steps and ms a step, rnnt_greedy_rt at
     lookahead 8 and 1, the model's beam-4 decode, one streamed 40-frame
     chunk of the blank-dominated bench decoder (greedy and beam 4), the
     transducer MWER step and its parts (the decode, the four scoring
     passes forward and backward (`mwer._rnnt_score_nbest`), the edit
     distances); rnnt_beam4's kernels' device time (K3's apart)
     under torch.profiler, and the device's idle share of the call;
 33. the OCR recognizer and the Dense front end: `OCRRecognizer` at JAX's
     default widths (d 128, 2 layers, 4 heads), V=96, built on the card by
     default, on BASELINE config 3's batch (B=64 seeded glyph text lines of
     H=32, widths up to 1024 (T'=256), targets of 16-64 characters) takes
     3 AdamW steps on `ctc_loss` (K1, K2 and the combine each step; step
     1's loss within 1e-3 of the same model's on the CPU), then, the
     blank's bias lowered by its median lead over the best character,
     `beam_search_decode(beam_width=10, prune_k=16)` (K3, K4 and the
     backtrace once; no line's best hypothesis empty); K4 at W=10
     bit-equal to its plain twin (codes, scores, state), the backtrace and
     lane-walk kernels to theirs, on the decode's candidates (its
     hypotheses equal to the plain twins') and on a peaked lattice of the
     row's shape, the beam sets' scores within 1e-4.  Then
     `ConformerTransducer(TransducerConfig(subsample=False))` at its
     default widths on B=8 requests of 10 s (T = T' = 998): phase 16's
     checks on the batch (the loss against the CPU, the gradients through
     K8/K9 against the plain scan's, K8/K9 against their twins and the
     parent kernels), one AdamW step (K8 and K9 once, the GRU kernels
     once a direction) and the greedy
     decode card against CPU (some request emitting and agreeing, scores
     within 1e-3 where the tokens agree);
 34. the multi-GPU slice: 4 gloo ranks on the one card (phase 24's
     spawn), each with its counters: the data-parallel CTC loss at config
     2 (B=32, T=1000, S=200, V=29; 8 rows a rank: the NLL and the gradient
     bit-equal to the unsharded loss's rows), the data-parallel RNN-T loss
     at the bench row (B=8, T=400, U=80, V=256), the data-parallel CTC
     greedy, transducer greedy, ALSD beam-4 and streaming (40-frame
     chunks) decodes at bench.py's `_rnnt_decoder` shapes (B=16; equal to
     the unsharded decodes), the vocabulary-parallel CTC loss at the
     large-vocab row (B=16, T=1000, S=100, V=32768; 8192 columns a rank:
     the NLL and the rank's gradient columns bit-equal to the unsharded
     K1/K2's, zero elsewhere), the vocabulary-parallel greedy decode and
     beam-16 at the beam-16 row (B=32, T=1000, V=1024, K=32: the merged
     top-K bit-equal to the global K3 top-K, the decode to
     `beam_search_from_topk` on it), and the time-parallel loss at B=4,
     T=8000, S=20, V=29 (2000 frames a rank: the NLL within 1e-4
     relative of the unsharded K1's and within 1e-4 of a float64 scan's,
     the gradient within 1e-4 of the float64 scan's max; the float32 K1/K2
     gradient's distance to that scan logged beside it); every rank
     JAX-free; then `dryrun_multichip(4)` on the card.  It runs right
     after phase 3, before the other phases' tensors fill the card (its
     four ranks hold ~25 GB at the large-vocabulary row);
 35. timings: the OCR train step and beam-10 decode at bench.py's OCR row
     (ms, seq/s), K4 and the backtrace at W=10 in device time with their
     bounds, the Dense-front-end transducer step, and each phase-34 path's
     run (the slowest rank, the median of 3 or one run) with the share of
     it spent in collectives (all-reduces and all-gathers);
 36. the utilities: phase 3 builds the kernels and the C++ host runtime
     (g++) inside `utils.profiling.log_compiles`, whose lines must name
     both libraries; under `utils.profiling.trace` phase 6's pipeline
     runs one beam-8 / prune-16 decode of phase 6's batch 0 and one CTC
     loss with its backward (phase 9's targets): the written Chrome trace
     must show K1, K2, the combine, K3, K4 and the backtrace with device
     time (the five longest device operations and the device's idle share
     of the window logged); a fresh full-width pipeline takes 3 AdamW
     steps, `save_checkpoint` writes it with AdamW's state and
     `restore_checkpoint` reads both into a freshly built pipeline and
     AdamW on the card: the greedy and beam-8 decodes bit-equal, then one
     more step's parameters bit-equal (cuDNN deterministic); the host
     runtime must have built: on the serving lattice against
     `native.beam_search_cpu` on its host copy, K4 at prune 16 and K5 (a
     seeded bigram) at prune 24, where its K + 8 repeat window holds all
     32 symbols, and the per-frame scan with the bigram at prune 16 (K4's
     best hypotheses equal for every sequence; with the LM a sequence
     whose best differs must have parted from the host decoder where the
     beams each keeps tie on their search scores at the beam's edge; the
     equal ones' scores within 1e-4 and 1e-3; K5's agreement at prune 16
     logged), and
     `load_arpa` / `parse_arpa_order` with the native parser equal to the
     Python one on phase 29's Kneser-Ney trigram as ARPA text; the
     kernels against the port's float64 oracles: K1/K2 and the combine
     through `ctc_nll` against `ctc_loss_ref` (B=4, T=200, S=40, V=32),
     K8/K9 through `rnnt_nll` against `rnnt_logits_grad_ref` (B=2, T=64,
     U=16, V=32), K4 at prune = V against `beam_search_decode_ref` (B=4,
     T=50, V=8, W=4), each error printed beside its tolerance; the
     serving pipeline's seq/s over 20 beam-8 decodes by
     `utils.profiling.Throughput`; and the five examples
     (`python -m end2end_tpu_torch.examples.<name>`), started together,
     each a process on the card, must exit 0 (steps 25, serving_demo its
     15).  Its launches join every kernel row's;
 37. the transducer predictor's GRU kernels (`csrc/gru_seq.cu`, one
     launch a direction) on the card through tests/test_torch_gru_seq.py's
     `card_errors` at its `CARD_SHAPES` (the transducer cell's widths,
     E = H = 640, V = 1025, at its 36 s, 14 s and 4 s buckets, (N, U) =
     (11, 158), (28, 63), (100, 18); and H = 10): each kernel against its
     plain twin on the same inputs, and `gru_prefix_states` (one launch a
     direction) against autograd through the `gru_step` loop, states and
     every predictor gradient within `CARD_TOL` of each tensor's max;
     then at the three buckets the forward and backward kernels alone
     against `gru_bound` (the float32 FMAs at the CUDA-core rate, or the
     bytes at HBM's) and against their step chain (the same kernels on
     two rows: 2U barriers and each phase's least work), the predictor's
     forward + backward through `gru_prefix_states` against the step loop
     it replaced, and the plain twins once each;
 38. the encoder's valid-frame packing: the serving cells' Conformer-CTC
     Large encoder (d 512, 18 blocks, 8 heads, conv kernel 31, 129
     outputs, seeded random weights) at testclean-b32-greedy's longest
     batch and its median one (e2e_bench's traffic generator; noise
     waveforms): every batch of the mix through `forward` must pack (the
     packing counter), with its share of rows computed; then at the two
     batches `forward` (packed on the card) against `forward_padded`,
     valid logits within 1e-4 of their largest and padded frames zeros,
     the packing counter's share of rows computed, and the two forwards
     timed in turns (padded, packed, packed, padded; CUDA events, median
     of 5 after a warm-up).
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
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from end2end_tpu_torch import (ConformerCTCPipeline, ConformerTransducer,
                               PipelineConfig, StreamingBeamDecoder,
                               StreamingGreedyDecoder,
                               StreamingRNNTBeamDecoder,
                               StreamingRNNTGreedyDecoder, TransducerConfig,
                               ctc_forced_alignment, greedy_decode,
                               greedy_decode_with_confidence, mwer_loss,
                               mwer_loss_from_nbest, rnnt_beam_decode,
                               rnnt_mwer_loss, word_confidences)
from end2end_tpu_torch.models.conformer import ConformerEncoder
from end2end_tpu_torch.models.frontend import log_mel_spectrogram, num_frames
from end2end_tpu_torch.models.ocr import OCRRecognizer
from end2end_tpu_torch.models.streaming import (_rnnt_encoded_chunks,
                                                transcribe_long_form_rnnt)
from end2end_tpu_torch.ops import (alignment, beam_chunked, beam_search_cuda,
                                   ctc_common, ctc_loss_cuda, ctc_loss_plain,
                                   gru_cuda, mwer, neural_lm, rnnt_decode,
                                   rnnt_joint_cuda, rnnt_joint_plain,
                                   rnnt_loss_cuda, rnnt_loss_plain,
                                   topk_cuda)
from end2end_tpu_torch.ops.beam_search import (beam_search_decode,
                                               beam_search_from_topk)
from end2end_tpu_torch.ops.ctc_loss import ctc_loss, ctc_nll
from end2end_tpu_torch.ops.decode_utils import (blank_collapse,
                                                collapse_and_bucket)
from end2end_tpu_torch.ops.mwer import word_id_hashes
from end2end_tpu_torch.ops.rnnt_decode import (FactoredAdditiveJoint,
                                               additive_joint,
                                               rnnt_greedy_decode)
from end2end_tpu_torch.ops.rnnt_joint import (
    rnnt_nll_fused_pallas, rnnt_nll_fused_pallas_vocab_parallel)
from end2end_tpu_torch.ops.rnnt_loss import (fused_additive_joint, rnnt_loss,
                                             rnnt_nll, rnnt_nll_from_planes,
                                             rnnt_nll_fused)
from end2end_tpu_torch.ops.indexing import compact_rows
from end2end_tpu_torch.ops.lm import (CompositeLM, HashedNGramLM,
                                      HashedWordNGramLM, HotwordBoostLM,
                                      NGramLM, QuantizedBigramGuide,
                                      WordNGramLM, bigram_from_counts)
from end2end_tpu_torch.ops.neural_lm import (NeuralLM, gru_step,
                                             random_gru_params)
from end2end_tpu_torch.ops.rescore import rescore_nbest
from end2end_tpu_torch.utils.lm_train import render_arpa, train_ngram_lm
from end2end_tpu_torch.tools import (beam_step_breakdown, ctc_alpha_breakdown,
                                     ctc_beta_breakdown, joint_fwd_breakdown,
                                     rnnt_wavefront_breakdown, topk_breakdown)
from end2end_tpu_torch.tools.joint_dw_breakdown import (
    N_SMS, device_ms, max_sm_mhz, tensor_ops_per_s, under_load)
from end2end_tpu_torch.parallel import (DataParallelStreamingRNNT,
                                        beam_search_decode_vocab_parallel,
                                        beam_topk_prep_vocab_parallel,
                                        ctc_loss_data_parallel,
                                        ctc_nll_time_parallel,
                                        ctc_nll_vocab_parallel,
                                        greedy_decode_data_parallel,
                                        greedy_decode_vocab_parallel,
                                        group_rank,
                                        rnnt_beam_decode_data_parallel,
                                        rnnt_greedy_decode_data_parallel,
                                        rnnt_loss_data_parallel, shard_batch)
from end2end_tpu_torch.parallel.dryrun import dryrun_multichip
from end2end_tpu_torch.utils import cuda_build, native, profiling
from end2end_tpu_torch.utils.arpa import load_arpa, parse_arpa_order
from end2end_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from end2end_tpu_torch.utils.metrics import batch_edit_distance
from end2end_tpu_torch.utils.reference_impl import (beam_search_decode_ref,
                                                    ctc_loss_ref)
from end2end_tpu_torch.utils.rnnt_reference import rnnt_logits_grad_ref
from end2end_tpu_torch.utils.subtitles import group_word_spans, to_srt
from end2end_tpu_torch.utils.text import asr_alphabet
from tests.test_torch_gru_seq import (CARD_SHAPES, CARD_TOL, card_errors,
                                      gru_case)

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
# the MWER term through K1/K2 vs the plain scan on the same N-best: the
# loss (relative) and the posterior (absolute), float32 CTC scores of
# ~1e3 whose differences are libm's last bits
MWER_RTOL = 1e-5
CONF_TOL = 1e-6  # confidences in [0, 1], card vs CPU libm
# a greedy transcript's forced-alignment score vs the float32 sum of its
# frames' maxima in frame order: the same adds in the same order
ALIGN_SUM_TOL = 1e-4
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
# the hashed-LM slice's weights: bench.py's word-trigram rows
HLM_ALPHA, HLM_BETA = 0.8, 0.4
# N-best rescoring, card vs CPU and per-token vs score_chunk: the same
# float32 adds in the same order for the n-gram LMs; the GRU's matmuls
# round differently on the card (absolute plus relative, of sums of up
# to 512 tokens' log-probs)
RESCORE_TOL = 1e-5
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
# The predictor's GRU kernels (phase 37): the shapes, limits and the
# comparison are tests/test_torch_gru_seq.py's (`CARD_SHAPES`, `CARD_TOL`,
# `card_errors`); the first three shapes are the transducer cell's buckets
GRU_ROW = "n11_u158"  # the kernels line's shape
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
                 "launches_resume", "launches_backtrace", "launches_walk")
# K3 against the K3 it replaced, torch.topk and its plain version: name:
# (T, B, V, k), the serving slice's top-k, the LM decode's at B=128, the
# beam decoder's reference shape and bench.py's beam-16 row (k = K + 8)
TOPK_SHAPES = {"main": (750, 8, 32, 24), "b128": (1000, 128, 29, 24),
               "ref": (1000, 32, 1024, 24), "beam16": (1000, 32, 1024, 40)}


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


def backtrace_bound(bp, out):
    """The backtrace kernel on this run's data: the codes and scores read
    once, the top-k id of each emission on the best paths read once, the
    token and time rows, lengths and scores written once (the scratch row
    of emissions is neither input nor output); no arithmetic to speak
    of."""
    t_max, w, n = bp.shape
    tokens, lens = out[:2]
    nbytes = (bp.numel() * 4 + w * n * 4 + int(lens.long().sum()) * 4
              + 2 * tokens.numel() * 4 + 2 * lens.numel() * 4)
    return bound(nbytes)


def lane_walk_bound(bp, out):
    """The lane-walk kernel on this run's data: the codes read once, the
    top-k id of each emission on the final beams' paths read once, lane0,
    the int64 token rows and their counts written once (the scratch of
    slots is neither input nor output); no arithmetic to speak of."""
    lane0, toks, n_emit = out
    nbytes = (bp.numel() * 4 + int(n_emit.sum()) * 4
              + (lane0.numel() + toks.numel() + n_emit.numel()) * 8)
    return bound(nbytes)


def check_walk(bp, ck, W, K, what):
    """The lane-walk kernel equal to the host walk on the card: lane0, the
    frame-aligned tokens and their counts; its launch is not counted.
    Returns the max abs difference (0)."""
    before = beam_search_cuda.launches_walk
    got = beam_search_cuda.lane_walk_cuda(bp, ck, W, K)
    beam_search_cuda.launches_walk = before
    want = beam_search_cuda.lane_walk_plain(bp, ck, W, K)
    torch.cuda.synchronize()
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want)):
        raise AssertionError(f"lane walk kernel != host walk ({what})")
    log(f"{what}: the lane walk equals the host walk (T={bp.shape[0]}, "
        f"W={W}, N={bp.shape[2]}: lane0, tokens, counts)")
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def check_backtrace(bp, ck, score, W, K, s_cap, what):
    """The backtrace kernel equal to backtrace_plain (the host walk) on the
    card: tokens, lengths, times and the scores' bits; its launch is not
    counted.  Also the lane walk on the same codes (check_walk).  Returns
    the max abs differences (0) of the two: (backtrace, lane walk)."""
    before = beam_search_cuda.launches_backtrace
    got = beam_search_cuda.backtrace_cuda(bp, ck, score, W, K, s_cap)
    beam_search_cuda.launches_backtrace = before
    want = beam_search_cuda.backtrace_plain(bp, ck, score, W, K, s_cap)
    torch.cuda.synchronize()
    if not all(a.dtype == b.dtype and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got, want)):
        raise AssertionError(f"backtrace kernel != backtrace_plain ({what})")
    log(f"{what}: the backtrace kernel equals backtrace_plain with the host "
        f"walk (T={bp.shape[0]}, W={W}, N={bp.shape[2]}, s_cap={s_cap}: "
        f"tokens, lengths, scores, times)")
    err = max(float((a.float() - b.float()).nan_to_num().abs().max())
              for a, b in zip(got, want))
    return err, check_walk(bp, ck, W, K, what)


def time_walk(name, bp, ck, score, W, K, s_cap):
    """The backtrace kernel's device time and one call beside
    backtrace_plain's (the host walk, then the torch compaction: before
    this kernel), and the lane-walk kernel's on the same codes beside
    lane_walk_plain's; into the ms dict returned, logged.  Returns (ms,
    the backtrace kernel's bound)."""
    ms = {f"backtrace_{name}": time_both(
        f"backtrace_{name}", lambda: beam_search_cuda.backtrace_cuda(
            bp, ck, score, W, K, s_cap)),
        f"backtrace_plain_{name}": time_ms(
            lambda: beam_search_cuda.backtrace_plain(bp, ck, score, W, K,
                                                     s_cap)),
        f"lane_walk_{name}": time_both(
            f"lane_walk_{name}", lambda: beam_search_cuda.lane_walk_cuda(
                bp, ck, W, K)),
        f"lane_walk_plain_{name}": time_ms(
            lambda: beam_search_cuda.lane_walk_plain(bp, ck, W, K))}
    b = backtrace_bound(bp, beam_search_cuda.backtrace_cuda(
        bp, ck, score, W, K, s_cap))
    wb = lane_walk_bound(bp, beam_search_cuda.lane_walk_cuda(bp, ck, W, K))
    frames = bp.shape[0]
    log(f"backtrace ({name}: T={frames}, W={W}, N={bp.shape[2]}, "
        f"s_cap={s_cap}): the kernel {DEVICE_MS[f'backtrace_{name}'][0]:.4f}"
        f" ms device, one call {ms[f'backtrace_{name}']:.4f}, with the host "
        f"walk and the torch compaction {ms[f'backtrace_plain_{name}']:.3f}"
        f" ms; bound {b[0]:.4f} ms ({b[1]}); the lane walk "
        f"{DEVICE_MS[f'lane_walk_{name}'][0]:.4f} ms device "
        f"({1e6 * DEVICE_MS[f'lane_walk_{name}'][0] / frames:.1f} ns a "
        f"frame), one call {ms[f'lane_walk_{name}']:.4f}, the host walk "
        f"{ms[f'lane_walk_plain_{name}']:.3f} ms; bound {wb[0]:.4f} ms "
        f"({wb[1]})")
    return ms, b


def topk_turns(name, x, k, ref_lib):
    """K3, the K3 it replaced and torch.topk in device time, in turns (A B
    B A), after checking K3's values and indices bit-equal to the parent's
    and to topk_plain's; logged with the plan and the bound."""
    t, b, v = x.shape
    parent = topk_breakdown.runner(ref_lib, x, k)
    got = topk_cuda.topk_cuda(x, k)
    for what, want in (("the parent K3", parent()),
                       ("topk_plain", topk_cuda.topk_plain(x, k))):
        if not topk_breakdown.same_bits(got, want):
            raise AssertionError(f"K3 != {what} at {name} {(t, b, v, k)}")
    plan = topk_cuda.topk_plan(v, k)
    out = in_turns(f"phase 7 K3 vs the parent K3 and torch.topk ({name}: "
                   f"T={t}, B={b}, V={v}, k={k}; plan {plan}; bit-equal to "
                   f"the parent and to topk_plain)",
                   {"K3": lambda: topk_cuda.topk_cuda(x, k),
                    "parent": parent,
                    "torch.topk": lambda: torch.topk(x, k)}, 50)
    tb = topk_bound(x, k)
    log(f"phase 7 K3 ({name}) bound {tb[0]:.5f} ms ({tb[1]}): K3 at "
        f"{100 * tb[0] / min(out['K3']):.1f}% of it")
    return out


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
    return beam_search_cuda.backtrace_plain(bp, ck, score, W, K, s_cap)[:3]


def parent_step(lib):
    """`beam_step`'s contract on the warp-per-sequence beam kernel that the
    beam step replaced (tools/beam_step_reference.cu, built in phase 3)."""
    def step(lpk, ck, lpb, il, W, K, s_cap, blank, inc=None, cls_map=None,
             state_in=None):
        kw = {k: x for k, x in (("inc", inc), ("cls_map", cls_map),
                                ("state_in", state_in)) if x is not None}
        bp, score, packed = beam_step_breakdown.runner(
            lib, (lpk, ck, lpb, il, W, K, s_cap, blank), kw)()
        state = tuple(x.view(torch.float32)
                      if i in beam_search_cuda._FLOAT_FIELDS else x
                      for i, x in enumerate(packed.unbind(0)))
        return bp, score, state[6], state
    return step


def assert_same_bits(got, want, what):
    """Backpointer codes, scores and the 10-field state bit for bit;
    returns the number of codes compared."""
    differing = int((got[0] != want[0]).sum())
    same = all(x.dtype == y.dtype and torch.equal(
        x.view(torch.int32), y.view(torch.int32))
        for x, y in zip((got[1], *got[3]), (want[1], *want[3])))
    if differing or not same:
        raise AssertionError(f"{what}: {differing} codes differ, or the "
                             "scores or the state do")
    return got[0].numel()


def beam_turns(what, args, kw, lib):
    """The beam step vs the parent kernel in device time, in turns (A B B
    A), logged with microseconds a frame (over the longest sequence)."""
    out = in_turns(what, {
        "beam step": lambda: beam_search_cuda.beam_step_cuda(*args, **kw),
        "parent": beam_step_breakdown.runner(lib, args, kw)}, 20)
    frames = max(min(int(args[3].max()), args[0].shape[0]), 1)
    log(f"{what}: microseconds a frame ({frames} frames): " + "; ".join(
        f"{k} {1e3 * v[0] / frames:.3f}, {1e3 * v[1] / frames:.3f}"
        for k, v in out.items()))
    return out


def check_beam_lm(rng, dev, t, b, v, W, K, parent):
    """K5 vs its plain twin and the parent kernel on the card.  Returns
    (score err, inputs)."""
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
    assert_same_bits(kern, plain, "K5 vs plain")
    assert_same_bits(kern, parent(*args, inc=inc), "K5 vs the parent kernel")

    def sets(bp, score, last):
        eos = lm._eos[last.long().clamp(0, v - 1)]
        score = score + torch.where(last >= 0, LM_ALPHA * eos, 0.0)
        return beam_sets(*beam_search_cuda.backtrace(bp, ck, score, W, K,
                                                     s_cap)[:3])

    err = compare_beams(sets(*kern[:3]), sets(*plain[:3]), "K5 vs plain")
    log(f"phase 11 K5 (B={b}, T={t}, V={v}, W={W}, K={K}): 0 of "
        f"{kern[0].numel()} codes differ from the plain twin's and the "
        f"parent kernel's, scores and state bit-identical, best hypotheses "
        f"equal, max score err {err:.3g}")
    return err, (lpk, ck, lpb, il, inc, lm)


def chunked_inputs(lp, il, guide, W, K):
    lpk, ck = topk_cuda.topk_cuda(lp, K)
    inc, cls_map = beam_chunked._resolve_guide(guide, lp.shape[-1], W,
                                               LM_ALPHA, LM_BETA)
    return lpk, ck, lp[:, :, 0].contiguous(), il, inc, cls_map


def run_chunks(inputs, lm, W, step, walk=None, s_cap=512, alpha=LM_ALPHA,
               beta=LM_BETA):
    """The chunk loop of beam_search_decode(implementation='chunked') on
    chunked_inputs, with `step` as the beam step and `walk` as the lane
    walk (None: the routed one)."""
    lpk, ck, lpb, il, inc, cls_map = inputs
    return beam_chunked.decode_chunks(lpk, ck, lpb, il, W,
                                      min(lpk.shape[0], s_cap), 0, lm,
                                      alpha, beta, CHUNK_T, inc, cls_map,
                                      step=step, walk=walk)


def check_chunked(name, inputs, lm, main_out, W, K, parent):
    """The chunked decode with the kernels vs with the plain twin and with
    the parent kernel, all on the card: every code and the final state
    identical; the hypotheses equal to the main path's run.  Returns the
    max score error."""
    lpk, ck = inputs[:2]
    s_cap = min(lpk.shape[0], 512)
    kern = run_chunks(inputs, lm, W, beam_search_cuda.beam_step_cuda)
    plain = run_chunks(inputs, lm, W, beam_search_cuda.beam_step_plain)
    old = run_chunks(inputs, lm, W, parent)
    torch.cuda.synchronize()
    for what, want in (("plain", plain), ("the parent kernel", old)):
        differing = int((kern[0] != want[0]).sum())
        if differing or not all(
                x.dtype == y.dtype and torch.equal(x.view(torch.int32),
                                                   y.view(torch.int32))
                for x, y in zip(kern[2], want[2])):
            raise AssertionError(f"{name} vs {what}: {differing} codes "
                                 "differ, or the state does")
    got = beam_search_cuda.backtrace(kern[0], ck, kern[1], W, K, s_cap)[:3]
    want = beam_search_cuda.backtrace_plain(plain[0], ck, plain[1], W, K,
                                            s_cap)
    err = compare_beams(beam_sets(*got), beam_sets(*want[:3]), name)
    if not all(torch.equal(a, b) for a, b in zip(got, main_out)):
        raise AssertionError(f"{name}: beam_search_decode differs from the "
                             "chunk loop")
    log(f"phase 12 {name}: 0 of {kern[0].numel()} codes differ from the "
        f"plain twin's and the parent kernel's, state bit-identical, "
        f"hypotheses equal, max score err {err:.3g}")
    return err


def check_topk(rng, dev, shapes, ref_lib):
    """K3 against topk_plain and the K3 it replaced: values and indices
    bit for bit."""
    err = 0.0
    for t, b, v, ks in shapes:
        x = torch.from_numpy(
            rng.standard_normal((t, b, v)).astype(np.float32)).to(dev)
        vals, idx = topk_cuda.topk_cuda(x, ks)
        pv, pi = topk_cuda.topk_plain(x, ks)
        parent = topk_breakdown.runner(ref_lib, x, ks)()
        torch.cuda.synchronize()
        if not topk_breakdown.same_bits((vals, idx), (pv, pi)):
            raise AssertionError(f"top-k kernel != plain at {(t, b, v, ks)}")
        if not topk_breakdown.same_bits((vals, idx), parent):
            raise AssertionError(f"top-k kernel != the parent K3 at "
                                 f"{(t, b, v, ks)}")
        err = max(err, float((vals - pv).abs().max()))
        log(f"phase 4 top-k (T={t}, B={b}, V={v}, ks={ks}): bit-equal to "
            f"topk_plain and to the parent K3")
    return err


def check_beam(rng, dev, t, b, v, W, K, parent):
    """The beam step vs its plain twin and vs the parent kernel (`parent`,
    a parent_step): bits and beam sets.  Returns (score err, inputs)."""
    lp = torch.from_numpy(peaked_lattice(rng, t, b, v)).to(dev)
    il = torch.from_numpy(
        rng.integers(t // 2, t + 1, b).astype(np.int32)).to(dev)
    ks = min(K + 8, v)
    s_cap = min(t, 512)
    lpk, ck = topk_cuda.topk_plain(lp, ks)
    lpb = lp[:, :, 0].contiguous()
    args = (lpk, ck, lpb, il, W, K, s_cap, 0)
    kern = beam_search_cuda.beam_step_cuda(*args)
    plain = beam_search_cuda.beam_step_plain(*args)
    torch.cuda.synchronize()
    n_codes = assert_same_bits(kern, plain, "beam step vs plain")
    assert_same_bits(kern, parent(*args), "beam step vs the parent kernel")
    got = beam_sets(*beam_search_cuda.backtrace(kern[0], ck, kern[1], W, K,
                                                s_cap)[:3])
    want = beam_sets(*beam_search_cuda.backtrace_plain(
        plain[0], ck, plain[1], W, K, s_cap)[:3])
    err = compare_beams(got, want, "beam kernel vs plain")
    log(f"phase 5 beam step (B={b}, T={t}, V={v}, W={W}, K={K}): 0 of "
        f"{n_codes} codes differ from the plain twin's and the parent "
        f"kernel's, scores and state bit-identical, best hypotheses equal, "
        f"max score err {err:.3g}")
    return err, (lpk, ck, lpb, il, s_cap)


def check_scan(rng, dev):
    """The prefix-beam scan on the card, outside the kernel's envelope
    (V=1024 with the default prune_k): no beam kernel, finite best
    scores, 'auto' equal to 'xla'."""
    lp = torch.from_numpy(peaked_lattice(rng, 100, 4, 1024)).to(dev)
    il = torch.tensor([100, 80, 60, 40], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    auto = beam_search_decode(lp, il, beam_width=8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {"topk": topk_cuda.launches, **beam_counts()}
    if any(launched.values()):
        raise AssertionError(f"the scan launched kernels: {launched}")
    if not torch.isfinite(auto[2][:, 0]).all():
        raise AssertionError("the scan's best scores are not finite")
    xla = beam_search_decode(lp, il, beam_width=8, implementation="xla")
    if not all(torch.equal(a, b) for a, b in zip(auto, xla)):
        raise AssertionError("the scan differs between 'auto' and 'xla'")
    log(f"phase 5 the prefix-beam scan on the card (B=4, T=100, V=1024, "
        f"W=8, K=V): {seconds:.2f} s, no kernel launched, 'auto' == 'xla', "
        f"mean best length {float(auto[1][:, 0].float().mean()):.1f}")


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


def check_beta_ab(lp, tgt, il, tl, k2_lib, what):
    """K2 vs the two-barrier K2 it replaced (tools/ctc_beta_reference.cu)
    on the same K1 outputs: gamma bit-equal in the tape mode and in
    checkpoint mode (64 frames)."""
    for every in (0, 64):
        z, ne, a, an = ctc_loss_cuda.alpha_cuda(lp, tgt, il, tl, 0, every)
        got = ctc_loss_cuda.beta_cuda(lp, tgt, il, tl, a, an, z, ne, 0, every)
        want = ctc_beta_breakdown.runner(k2_lib, False, (lp, tgt, il, tl),
                                         every)()
        torch.cuda.synchronize()
        if not ctc_alpha_breakdown.equal_outputs([got], [want]):
            raise AssertionError(f"{what}: K2's gamma (every={every}) "
                                 "differs from the two-barrier K2's")
    log(f"{what}: K2 == the two-barrier K2 bit for bit (gamma, tape and "
        "checkpoint modes)")


def check_ctc(lp, tgt, il, tl, what, ref_lib, k2_lib):
    """K1/K2 (through ctc_nll) vs the plain float32 and float64 scans on
    the card, and the kernels' tape and checkpoint modes against each other
    (bit-identical outputs and gradients); K1 and K2 vs the two-barrier K1
    and K2 (bit for bit).  Returns (loss err, grad err)."""
    check_alpha_ab(lp, tgt, il, tl, ref_lib, what)
    check_beta_ab(lp, tgt, il, tl, k2_lib, what)
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


def check_training_batch(pipe, batch, ref_lib, k2_lib):
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
                     f"B=8, S={tgt.shape[1]}", ref_lib, k2_lib)


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
        f"ctc_library_bwd_{name}": time_both(
            f"ctc_library_bwd_{name}", library_ctc_bwd(lp, *lib_args)),
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


def library_ctc_bwd(lp, tgt, il, tl):
    """torch's own CTC loss backward alone (the yardstick of K2 and the
    combine): the forward once, then a function that runs its backward
    (autograd.grad, the graph kept) on the same inputs."""
    x = lp.detach().requires_grad_(True)
    loss = torch.nn.functional.ctc_loss(x, tgt, il, tl, reduction="sum",
                                        zero_infinity=True)
    return lambda: torch.autograd.grad(loss, x, retain_graph=True)


def k2_vs_parent(args, name, k2_lib):
    """K2 against the two-barrier K2 in device time, in turns (A B B A),
    in the tape mode and in checkpoint mode (64 frames), with cycles a
    frame (the better turn x the SM clock under K2, over the longest
    sequence's frames), and the card's SM clock and power under each."""
    lp, tgt, il, tl = args
    what = f"{name}: B={lp.shape[1]}, T={lp.shape[0]}, S={tgt.shape[1]}"
    frames = ctc_beta_breakdown.frames_of(args)
    clock = {}
    for label, lib, new in (("K2", None, True),
                            ("two-barrier K2", k2_lib, False)):
        fn = ctc_beta_breakdown.runner(lib or cuda_build.library()[0], new,
                                       args)
        mhz, watts, temp = under_load(fn, seconds=1.5)
        clock[label] = mhz
        log(f"phase 10 the card running {label} back to back ({name}): SM "
            f"clock {mhz:.0f} MHz, {watts:.1f} W, {temp:.0f} C")
    for every in (0, 64):
        mode = "checkpoint 64" if every else "tape"
        turns = in_turns(f"phase 10 K2 vs the two-barrier K2 ({what}, "
                         f"{mode})", {
                             "K2": ctc_beta_breakdown.runner(
                                 cuda_build.library()[0], True, args, every),
                             "two-barrier K2": ctc_beta_breakdown.runner(
                                 k2_lib, False, args, every)}, 20)
        log(f"phase 10 K2 vs the two-barrier K2 ({name}, {mode}), cycles a "
            "frame: " + "; ".join(
                f"{k} {min(v) * 1e3 * clock[k] / frames:.0f}"
                for k, v in turns.items()))


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


def time_chunk_split(inputs, lm, W, reps=5, tag="b128", **kw):
    """The chunk loop of a chunked decode (`run_chunks`'s keywords in kw)
    with CUDA events around it, each
    kernel launch and each piece of the chunk boundary: the lane walk back
    through the chunk's codes (`lane_walk`), the left-justification
    of the emitted tokens (`compact_rows`) and the LM replay
    (`score_chunk`); the rest of the boundary is the LM-state re-homing and
    the bonus update.  Returns the ms of the median rep after a warm-up."""
    pieces = {"lane_walk": (beam_chunked, "lane_walk"),
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
                   timed(beam_search_cuda.beam_step_cuda, events["kernels"]),
                   **kw)
        end.record()
        end.synchronize()
        setattr(beam_chunked, "lane_walk", originals["lane_walk"])
        setattr(beam_chunked, "compact_rows", originals["compact"])
        del lm.score_chunk  # the class's method again
        if rep:
            rows.append((start.elapsed_time(end),
                         *(sum(a.elapsed_time(b) for a, b in ev)
                           for ev in events.values())))
    loop, kern, walk, compact, replay = sorted(rows)[reps // 2]
    return {f"chunk_loop_{tag}": loop, f"chunk_kernels_{tag}": kern,
            f"chunk_boundary_{tag}": loop - kern,
            f"boundary_lane_walk_{tag}": walk,
            f"boundary_compact_{tag}": compact,
            f"boundary_score_chunk_{tag}": replay,
            f"boundary_other_{tag}": loop - kern - walk - compact - replay}


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


def rnnt_parent_data(dp):
    """The DP inputs `dp` (rnnt_dp_inputs') as the parent kernels' runner
    takes them (rnnt_wavefront_breakdown.runner)."""
    b_pl, l_pl, tape, rcum, il, ul, zs, zo = dp
    return (b_pl.contiguous(), l_pl.contiguous(), il, ul,
            (tape, rcum, il.int(), ul.int(), zs, zo))


def check_rnnt_parent(dp, ref_lib, what):
    """K8's tape and offsets and K9's posteriors bit-equal to the
    block-per-sequence kernels' they replaced (tools/rnnt_loss_reference.cu)
    on the same inputs."""
    data = rnnt_parent_data(dp)
    got = (dp[2], dp[3]), rnnt_loss_cuda.posteriors(*dp)
    for post, kernel in ((0, "K8"), (1, "K9")):
        want = rnnt_wavefront_breakdown.runner(ref_lib, False, data, post)()
        if not rnnt_wavefront_breakdown.equal_outputs(got[post], want):
            raise AssertionError(f"{what}: {kernel} differs from the parent "
                                 "kernel's bits")
    log(f"{what}: K8's tape and offsets and K9's posteriors bit-equal to the "
        "parent kernels'")


def check_rnnt(x, tgt, il, ul, blank, what, ref_lib):
    """K8/K9 (through rnnt_nll, from logits) vs the plain float32 and
    float64 scans on the card, K9 alone vs its plain twin on the same
    residuals, and both bit-equal to the parent kernels.  Returns (nll err,
    posterior err)."""
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
    check_rnnt_parent((b_pl, l_pl, tape, rcum, *rest), ref_lib, what)
    return nll_err, post_err


def rnnt_vs_parent(dp, name, ref_lib):
    """K8 and K9 against the parent kernels in device time, in turns (A B B
    A, on contiguous planes), their outputs compared bit for bit, and the
    cycles a diagonal of each at the SM clock sampled under it."""
    data = rnnt_parent_data(dp)
    n, t, up = data[0].shape
    diagonals = t + up - 1
    kernels = {"K8": lambda: rnnt_loss_cuda.alpha(*data[:2]),
               "K9": lambda: rnnt_loss_cuda.posteriors(*data[:2], *dp[2:])}
    for post, (kernel, fn) in enumerate(kernels.items()):
        fns = {kernel: fn, "parent": rnnt_wavefront_breakdown.runner(
            ref_lib, False, data, post)}
        if not rnnt_wavefront_breakdown.equal_outputs(fn(), fns["parent"]()):
            raise AssertionError(f"phase 17 {kernel} ({name}) differs from "
                                 "the parent kernel's bits")
        turns = in_turns(f"phase 17 {kernel} vs the parent ({name}: B={n}, "
                         f"T={t}, U+1={up}; outputs bit-equal)", fns, 20)
        for k, f in fns.items():
            mhz = under_load(f, seconds=1.0)[0]
            log(f"phase 17 {kernel} ({name}) {k}: "
                f"{min(turns[k]) * 1e3 * mhz / diagonals:.0f} cycles a "
                f"diagonal ({diagonals} diagonals) at {mhz:.0f} MHz")


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


def check_transducer_batch(model, batch, ref_lib, what="phase 16"):
    """First batch: CUDA vs CPU loss, kernel vs plain gradients of every
    parameter, and K8/K9 vs plain at this shape.  Returns (nll err,
    posterior err, the DP inputs of this batch, the model on the CPU)."""
    k_loss, k_grads = transducer_grads(model, batch, "auto")
    p_loss, p_grads = transducer_grads(model, batch, "xla")
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        c_loss = cpu.loss(*batch).item()
    rel = abs(k_loss.item() - c_loss) / abs(c_loss)
    log(f"{what} first batch: CUDA loss {k_loss.item():.6f}, CPU loss "
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
    log(f"{what} gradients of {len(k_grads)} tensors, kernels vs plain: "
        f"max err {worst:.3g} of each tensor's max")
    if worst > TRAIN_GRAD_RTOL or set(k_grads) != set(p_grads):
        raise AssertionError(f"transducer grads differ: {worst}")
    with torch.no_grad():
        enc, enc_len = model.encode(batch[0], batch[1])
        x = model.joint_logits(enc, model._pred_states(batch[2]))
    tgt, tl = (torch.as_tensor(a, device=x.device) for a in batch[2:])
    errs = check_rnnt(x, tgt, enc_len, tl, 0,
                      f"{what} K8/K9 at the training shape {tuple(x.shape)}",
                      ref_lib)
    return (*errs, rnnt_dp_inputs(x, tgt, enc_len, tl, 0), cpu)


TRANSDUCER_PARTS = ("tr_encoder_fwd_bwd", "tr_predictor_fwd_bwd",
                    "tr_joint_fwd_bwd", "tr_loss_grad", "tr_adamw")


def time_transducer_parts(model, batch):
    """The train step's pieces, each forward + backward on its own (the
    backward seeded with ones): the encoder, the predictor's states
    (`gru_prefix_states`: on the card one GRU kernel launch a direction),
    the joint logits, the loss + gradient wrt the logits (K8, K9 and
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


def align_bound(lp, tgt, il, tl, blank=0):
    """The alignment on this run's data: each frame it runs (t < il, and
    frame 0 where il = 0) needs the log-probs of its sample's distinct
    target labels and blank once (at most a row of V floats); the target
    labels, the lengths, and labels, positions (T, N) int32 and the
    scores once.  The choices need no memory traffic: a sequence's tape
    fits on the chip.  About 8 operations a lattice cell (three maxes, two
    compares, an add, a floor)."""
    t_max, n, _ = lp.shape
    il, tl = il.long().cpu(), tl.long().cpu()
    rows = tgt.long().cpu()
    labels = sum(max(int(i), 1) * len(set(rows[k, :int(tl[k])].tolist())
                                      | {blank})
                 for k, i in enumerate(il))
    nbytes = (labels * 4 + int(tl.sum()) * 4 + n * 8 + 2 * t_max * n * 4
              + n * 4)
    return bound(nbytes, 8 * int((il * (2 * tl + 1)).sum()))


def check_align(lp, tgt, il, tl, blank, what):
    """The alignment kernel against align_plain on the card: labels,
    positions and the scores' bits equal, one launch (not counted on the
    main path).  Returns the kernel's output and the largest difference
    (|kernel - plain| over the finite scores, 1 for a label or position
    that differs)."""
    before = alignment.launches
    got = alignment.ctc_forced_alignment(lp, tgt, il, tl, blank=blank)
    if alignment.launches != before + 1:
        raise AssertionError(f"{what}: the alignment kernel launched "
                             f"{alignment.launches - before} times")
    alignment.launches = before
    want = alignment.align_plain(lp, tgt.long(), il.long(), tl.long(), blank)
    torch.cuda.synchronize()
    fin = torch.isfinite(want.scores)
    err = max(float((got.scores - want.scores)[fin].abs().max())
              if fin.any() else 0.0,
              float(not torch.equal(got.labels, want.labels)),
              float(not torch.equal(got.positions, want.positions)))
    if not (torch.equal(got.labels, want.labels)
            and torch.equal(got.positions, want.positions)
            and torch.equal(got.scores.view(torch.int32),
                            want.scores.view(torch.int32))):
        raise AssertionError(f"{what}: alignment kernel != align_plain "
                             f"(max err {err})")
    log(f"{what}: the alignment kernel equals align_plain (labels, "
        f"positions, scores' bits; T={lp.shape[0]}, N={lp.shape[1]}, "
        f"S={tgt.shape[1]}, plan {alignment.align_plan(2 * tgt.shape[1] + 1)}"
        f"); scores {[round(x, 3) for x in got.scores.tolist()[:8]]}")
    return got, err


def sequential_sum(x, il):
    """Each column's sum of x (T, N) over its first il frames, added in
    frame order in float32 (the order the Viterbi forward adds them)."""
    total = x[0].clone()
    for t in range(1, x.shape[0]):
        total = torch.where(t < il, total + x[t], total)
    return total


def check_greedy_alignment(lp, il, what):
    """Each request's greedy transcript, force-aligned by the kernel and
    by align_plain, scores that request's per-frame maxima summed over its
    frames (the argmax path is the best of all and collapses to that
    transcript): within ALIGN_SUM_TOL of the float32 sum in frame order
    (the Viterbi's own order of adds; torch's sum takes another and
    differs by ~1e-3 at T'=750); the float64 sum beside it.  Returns the
    largest difference."""
    tokens, lengths, _ = greedy_decode(lp, il)
    s = max(int(lengths.max()), 1)
    live = il > 0  # il = 0 scores frame 0's blank, as the JAX package's
    tgt = tokens[:, :s].clamp(min=0)
    best = lp.max(dim=-1).values
    want = sequential_sum(best, il.long())
    want64 = torch.where(torch.arange(lp.shape[0], device=lp.device)[:, None]
                         < il.long(), best.double(), 0.0).sum(0)
    before = alignment.launches
    kern = alignment.ctc_forced_alignment(lp, tgt, il, lengths).scores
    alignment.launches = before
    plain = alignment.align_plain(lp, tgt.long(), il.long(), lengths.long(),
                                  0).scores
    err = max(float((kern - want)[live].abs().max()),
              float((plain - want)[live].abs().max()))
    log(f"{what}: greedy transcripts (lengths {lengths.tolist()}) "
        f"force-aligned score their per-frame maxima: max err {err:.3g} "
        f"(kernel and align_plain against the float32 sum in frame "
        f"order), {float((kern.double() - want64)[live].abs().max()):.3g} "
        f"against the float64 sum; requests with il = 0 left out")
    if err > ALIGN_SUM_TOL:
        raise AssertionError(f"{what}: greedy alignment score err {err}")
    return err


def mwer_term(log_probs, il, tgt, tl, score_implementation="auto",
              nbest=None):
    """0.5 * mwer_loss of the slice (beam 4, prune 16), or of a given
    N-best through mwer_loss_from_nbest; returns (loss, aux)."""
    if nbest is None:
        loss, aux = mwer_loss(log_probs, tgt, il, tl, beam_width=4,
                              prune_k=16, return_aux=True,
                              score_implementation=score_implementation)
    else:
        loss, aux = mwer_loss_from_nbest(
            log_probs, il, nbest[0], nbest[1], tgt, tl, hyp_valid=nbest[2],
            return_aux=True, score_implementation=score_implementation)
    return 0.5 * loss, aux


def mwer_counts():
    return {"topk": topk_cuda.launches, "beam_step": beam_search_cuda.launches,
            "backtrace": beam_search_cuda.launches_backtrace,
            **ctc_loss_cuda.launches}


def check_mwer_step1(pipe, batch):
    """Step 1's MWER term on the card's N-best through the kernels and
    through the plain scan, on the same log-probs: loss, posterior,
    errors, and the encoder's gradients of the term.  Returns (loss rel
    err, grad err)."""
    wav, ns, tgt, tl = batch
    with torch.no_grad():
        logits, out_len = pipe.encode(wav, ns)
        lp = torch.log_softmax(logits, -1).transpose(0, 1)
        tok, lens, sc = beam_search_decode(lp, out_len, beam_width=4,
                                           prune_k=16)
    nbest = (tok, lens, torch.isfinite(sc))
    out = {}
    for impl in ("auto", "xla"):
        pipe.zero_grad()
        logits, out_len = pipe.encode(wav, ns)
        lp = torch.log_softmax(logits, -1).transpose(0, 1)
        loss, aux = mwer_term(lp, out_len, tgt, tl, impl, nbest)
        loss.backward()
        out[impl] = (loss.item(), aux, {k: p.grad.clone() for k, p in
                                        pipe.named_parameters()})
    (lk, ak, gk), (lp_, ap, gp) = out["auto"], out["xla"]
    rel = abs(lk - lp_) / max(abs(lp_), 1e-12)
    post = float((ak["posterior"] - ap["posterior"]).detach().abs().max())
    worst = 0.0
    for name, g in gk.items():
        scale = max(float(gp[name].abs().max()), 1e-4)
        worst = max(worst, float((g - gp[name]).abs().max()) / scale)
    log(f"phase 27 step 1 on the card's N-best (N=8, W=4, hypothesis "
        f"lengths {lens.min().item()}-{lens.max().item()}): 0.5 * MWER "
        f"through K1/K2 {lk:.6f}, through the plain scan {lp_:.6f} (rel err "
        f"{rel:.3g}); posterior max err {post:.3g}; errors equal: "
        f"{torch.equal(ak['errors'], ap['errors'])}; encoder gradients max "
        f"err {worst:.3g} of each tensor's max; errors per hypothesis "
        f"{ak['errors'][0].tolist()}")
    if not (rel <= MWER_RTOL and post <= MWER_RTOL
            and torch.equal(ak["errors"], ap["errors"])
            and worst <= TRAIN_GRAD_RTOL and np.isfinite(lk)):
        raise AssertionError(f"MWER step 1, kernels vs plain: loss {rel}, "
                             f"posterior {post}, gradients {worst}")
    return rel, worst


def mwer_parts(pipe, batch, space_id):
    """The MWER step's parts at the slice's shape, with CUDA events (median
    of 5 after warm-up): the N-best decode, the hypotheses' scoring on N*W
    rows forward and backward, batch_edit_distance, word_id_hashes, the
    whole term forward and backward; logged, into a dict returned."""
    wav, ns, tgt, tl = batch
    dev = pipe.device
    with torch.no_grad():
        logits, out_len = pipe.encode(wav, ns)
        lp0 = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    tgt_t = torch.as_tensor(tgt, device=dev).long()
    tl_t = torch.as_tensor(tl, device=dev).long()
    with torch.no_grad():
        tok, lens, _ = beam_search_decode(lp0, out_len, beam_width=4,
                                          prune_k=16)
    n, w = lens.shape
    hyp = mwer._trim_nbest(tok.long(), lens.long())
    s = hyp.shape[-1]
    hl = lens.long()

    def scoring():
        lp = lp0.clone().requires_grad_()
        mwer._score_nbest(lp, out_len.long(), hyp, hl, 0,
                          "auto").sum().backward()

    def whole():
        lp = lp0.clone().requires_grad_()
        mwer_term(lp, out_len, tgt, tl)[0].backward()

    out = {
        "mwer_decode": time_ms(lambda: beam_search_decode(
            lp0, out_len, beam_width=4, prune_k=16)),
        "mwer_scoring_fwd_bwd": time_ms(scoring),
        "mwer_edit_distance": time_ms(lambda: batch_edit_distance(
            hyp.reshape(n * w, s), hl.reshape(n * w),
            tgt_t.repeat_interleave(w, 0), tl_t.repeat_interleave(w, 0))),
        "mwer_word_hashes": time_ms(lambda: word_id_hashes(
            tok[..., :s], lens, space_id)),
        "mwer_term_fwd_bwd": time_ms(whole)}
    # the term less its decode, scoring and edit distances (host loops
    # spread by a few ms between calls, so this can come out below 0)
    out["mwer_rest"] = out["mwer_term_fwd_bwd"] - (
        out["mwer_decode"] + out["mwer_scoring_fwd_bwd"]
        + out["mwer_edit_distance"])
    log(f"phase 28 MWER parts (T'={lp0.shape[0]}, N={n}, W={w}, S'={s}, "
        f"S_ref={tgt_t.shape[1]}, N*W={n * w} scoring rows): "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in out.items())
        + f"; batch_edit_distance's loop {s + tgt_t.shape[1] - 1} steps, "
        f"word_id_hashes' {s}")
    return out


def word_trigram_lm(rng, spellings, v, dev):
    """A hashed word trigram over the lexicon (separator v - 1), its
    n-grams drawn as bench.py's word-trigram LM draws them: a unigram and
    a backoff per word, 6 * Wv bigram and 8 * Wv trigram draws with
    duplicates merged, <unk> at -6; built on `dev` and on the CPU."""
    wv = len(spellings)
    ng = {1: [], 2: [], 3: [], "unk": -6.0}
    for w in range(wv):
        ng[1].append(((w,), float(rng.uniform(-6, -1)),
                      float(rng.uniform(-1, 0))))
    for g in {tuple(int(x) for x in rng.integers(0, wv, 2))
              for _ in range(6 * wv)}:
        ng[2].append((g, float(rng.uniform(-4, -0.5)),
                      float(rng.uniform(-1, 0))))
    for g in {tuple(int(x) for x in rng.integers(0, wv, 3))
              for _ in range(8 * wv)}:
        ng[3].append((g, float(rng.uniform(-3, -0.3)), 0.0))
    return tuple(HashedWordNGramLM(spellings, 3, ng, v - 1, device=d)
                 for d in (dev, "cpu"))


class ProtocolOnly:
    """An LM with the protocol's score/select/final and no score_chunk:
    rescore_nbest folds it token by token (its per-token route)."""

    def __init__(self, lm):
        self._lm = lm

    def __getattr__(self, name):
        if name == "score_chunk":
            raise AttributeError(name)
        return getattr(self._lm, name)


def close_scores(got, want, what, tol=RESCORE_TOL):
    """Finite scores of (N, W) tensors alike, within tol absolute plus tol
    relative; returns the largest difference relative to max(1, |want|)."""
    got, want = got.cpu(), want.cpu()
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{what}: dead beams differ")
    fin = torch.isfinite(got)
    diff = (got[fin] - want[fin]).abs()
    if bool((diff > tol + tol * want[fin].abs()).any()):
        raise AssertionError(f"{what}: max score diff {float(diff.max())}")
    return float((diff / want[fin].abs().clamp(min=1)).max()) if (
        diff.numel()) else 0.0


def hashed_lm_slice(lps, v, dev):
    """Phase 29: the pipeline's log-probs `lps` [(lp, il)] through the
    chunked decode with a CompositeLM (a 2000-word hashed word trigram and
    a hotword booster) steered by a 15-class guide, checked against the
    plain twins on the card and against the CPU; N-best rescoring of a
    no-LM decode by three LMs (score_chunk, a GRU, the per-token route),
    card against CPU; a Kneser-Ney token trigram trained from a seeded
    corpus through the per-frame scan, card against CPU.  Returns the
    launch counts, the largest errors and what phase 30 times."""
    rng = np.random.default_rng(SEED + 29)
    spellings = seeded_lexicon(rng, v)
    tri, tri_cpu = word_trigram_lm(rng, spellings, v, dev)
    phrases = [spellings[i] for i in rng.choice(len(spellings), 5,
                                                replace=False)]
    hot, hot_cpu = (HotwordBoostLM(phrases, 1.0, 2.0, device=d)
                    for d in (dev, "cpu"))
    lm, lm_cpu = CompositeLM([tri, hot]), CompositeLM([tri_cpu, hot_cpu])
    guide = QuantizedBigramGuide.from_bigram(seeded_bigram(rng, v, dev),
                                             n_classes=15)
    guide_cpu = QuantizedBigramGuide(guide._cls_map.cpu(),
                                     guide._table.cpu(), device="cpu")
    kw = dict(beam_width=8, prune_k=16, lm_alpha=HLM_ALPHA,
              lm_beta=HLM_BETA, implementation="chunked",
              lm_chunk_t=CHUNK_T)
    torch.cuda.synchronize()
    reset_counts()
    outs = [beam_search_decode(lp, il, lm=lm, guide_lm=guide, **kw)
            for lp, il in lps]
    torch.cuda.synchronize()
    counts = {"topk": topk_cuda.launches, **beam_counts()}
    n_chunks = sum(-(-lp.shape[0] // CHUNK_T) for lp, _ in lps)
    log(f"phase 29 the pipeline's chunked decodes with a CompositeLM (2000-"
        f"word hashed trigram + 5 hotwords) and a 15-class guide "
        f"({len(lps)} batches x 8 requests, T'={lps[0][0].shape[0]}): "
        f"launches {counts}")
    if counts != {"topk": len(lps), "launches": n_chunks, "launches_lm": 0,
                  "launches_cls": n_chunks, "launches_resume": n_chunks,
                  "launches_backtrace": len(lps), "launches_walk": n_chunks}:
        raise AssertionError(f"kernels missed on the hashed-LM path: "
                             f"{counts}")
    for tok, lens, sc in outs:
        if tok.shape[:2] != (8, 8) or not torch.isfinite(sc[:, 0]).all():
            raise AssertionError("bad hashed-LM decode output")
    # one batch: the plain top-k, beam step, walk and backtrace on the card
    lp0, il0 = lps[0]
    s_cap = min(lp0.shape[0], 512)
    lpk, ck = topk_cuda.topk_plain(lp0, 16)
    inc, cls_map = beam_chunked._resolve_guide(guide, v, 8, HLM_ALPHA,
                                               HLM_BETA)
    bp, score, _ = beam_chunked.decode_chunks(
        lpk, ck, lp0[:, :, 0].contiguous(), il0, 8, s_cap, 0, lm, HLM_ALPHA,
        HLM_BETA, CHUNK_T, inc, cls_map,
        step=beam_search_cuda.beam_step_plain,
        walk=beam_search_cuda.lane_walk_plain)
    plain = beam_search_cuda.backtrace_plain(bp, ck, score, 8, 16, s_cap)
    err = compare_beams(beam_sets(*outs[0]), beam_sets(*plain[:3]),
                        "phase 29 kernels vs plain")
    cpu = beam_search_decode(lp0.cpu(), il0.cpu(), lm=lm_cpu,
                             guide_lm=guide_cpu, **kw)
    err = max(err, compare_beams(beam_sets(*outs[0]), beam_sets(*cpu),
                                 "phase 29 card vs CPU"))
    log(f"phase 29 batch 0: the kernels' hypotheses == the plain twins' on "
        f"the card and the CPU decode's, max score err {err:.3g}; best "
        f"lengths {outs[0][1][:, 0].tolist()}")
    # N-best rescoring of the no-LM decode: K3, K4, the backtrace
    reset_counts()
    nolm = [beam_search_decode(lp, il, beam_width=8, prune_k=16)
            for lp, il in lps]
    torch.cuda.synchronize()
    nolm_counts = {"topk": topk_cuda.launches, **beam_counts()}
    if (nolm_counts["topk"], nolm_counts["launches"],
            nolm_counts["launches_backtrace"]) != (len(lps),) * 3:
        raise AssertionError(f"the no-LM decode missed its kernels: "
                             f"{nolm_counts}")
    gru_params = random_gru_params(rng, v)
    gru, gru_cpu = (NeuralLM.gru(gru_params, eos_id=v - 1, device=d)
                    for d in (dev, "cpu"))
    rescorers = {"word trigram": (tri, tri_cpu),
                 "GRU": (gru, gru_cpu),
                 "word trigram, per token": (ProtocolOnly(tri),
                                             ProtocolOnly(tri_cpu))}
    rescored, resc_err = {}, 0.0
    for name, (lm_d, lm_c) in rescorers.items():
        got = [rescore_nbest(*out, lm_d, HLM_ALPHA, HLM_BETA,
                             resort=False)[2] for out in nolm]
        want = [rescore_nbest(*(x.cpu() for x in out), lm_c, HLM_ALPHA,
                              HLM_BETA, resort=False)[2] for out in nolm]
        resc_err = max([resc_err] + [close_scores(
            g, w, f"phase 29 rescoring by the {name}, card vs CPU")
            for g, w in zip(got, want)])
        rescored[name] = got
    route_err = max(close_scores(a, b, "phase 29 per-token vs score_chunk")
                    for a, b in zip(rescored["word trigram, per token"],
                                    rescored["word trigram"]))
    log(f"phase 29 rescore_nbest of the no-LM beam-8 decodes (launches "
        f"{nolm_counts}) by {list(rescorers)}: card vs CPU max diff "
        f"{resc_err:.3g} of max(1, |score|), per-token route vs score_chunk "
        f"{route_err:.3g}")
    # a Kneser-Ney token trigram from a seeded corpus, fused per frame
    p = np.arange(1, v) ** -1.0
    corpus = [[str(t) for t in rng.choice(np.arange(1, v), int(
        rng.integers(5, 40)), p=p / p.sum())] for _ in range(400)]
    order, ngrams, vocab = train_ngram_lm(corpus, order=3,
                                          vocab=[str(i) for i in range(v)])
    kn, kn_cpu = (HashedNGramLM(order, ngrams, len(vocab), device=d)
                  for d in (dev, "cpu"))
    kwx = dict(beam_width=8, prune_k=16, lm_alpha=HLM_ALPHA,
               lm_beta=HLM_BETA, implementation="xla")
    t0 = time.perf_counter()
    got = beam_search_decode(lp0, il0, lm=kn, **kwx)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    kn_err = compare_beams(beam_sets(*got), beam_sets(*beam_search_decode(
        lp0.cpu(), il0.cpu(), lm=kn_cpu, **kwx)), "phase 29 KN trigram scan")
    n_grams = sum(len(ngrams[k]) for k in (1, 2, 3))
    log(f"phase 29 train_ngram_lm trigram ({n_grams} n-grams from 400 "
        f"sentences) through HashedNGramLM and the "
        f"per-frame scan on batch 0: card == CPU, max score err "
        f"{kn_err:.3g}; the scan took {t_card:.2f} s on the card")
    return {"launches": counts, "err": max(err, kn_err), "lm": lm,
            "guide": guide, "kw": kw, "kn": (order, ngrams, vocab)}


def hashed_lm_timings(dev, slice29, lps):
    """Phase 30: bench.py's word-trigram chunked and rescore rows (B=128,
    T=1000, V=29, beam 8, prune 16, max_symbols 256, chunk 128, no guide),
    the chunk loop split into its kernels and its boundary (score_chunk
    alone), score_chunk on one chunk's tokens, phase 29's decode; the
    plain chunk loop once.  Returns ms entries."""
    ms = {}
    brng = np.random.default_rng(1)  # bench.py's draws
    blm, _ = word_trigram_lm(brng, seeded_lexicon(brng, 29), 29, dev)
    x = np.random.default_rng(0).standard_normal((1000, 128, 29))
    lp = torch.log_softmax(torch.from_numpy(x.astype(np.float32) * 2.0)
                           .to(dev), -1)
    il = torch.full((128,), 1000, dtype=torch.int32, device=dev)
    kw = dict(beam_width=8, prune_k=16, max_symbols=256, lm_alpha=HLM_ALPHA,
              lm_beta=HLM_BETA)
    ms["decode_word3_chunked_b128"] = time_ms(lambda: beam_search_decode(
        lp, il, lm=blm, implementation="chunked", lm_chunk_t=CHUNK_T, **kw))
    inputs = chunked_inputs(lp, il, None, 8, 16)
    loop_kw = dict(s_cap=256, alpha=HLM_ALPHA, beta=HLM_BETA)
    ms.update(time_chunk_split(inputs, blm, 8, tag="word3_b128", **loop_kw))
    ms["chunk_loop_plain_word3_b128"] = time_plain(lambda: run_chunks(
        inputs, blm, 8, beam_search_cuda.beam_step_plain,
        walk=beam_search_cuda.lane_walk_plain, **loop_kw))

    def nolm():
        return beam_search_decode(lp, il, beam_width=8, prune_k=16,
                                  max_symbols=256)

    nbest = nolm()
    ms["decode_nolm_b128_s256"] = time_ms(nolm)
    ms["rescore_word3_b128"] = time_ms(lambda: rescore_nbest(
        *nbest, blm, HLM_ALPHA, HLM_BETA))
    ms["decode_word3_rescore_b128"] = time_ms(lambda: rescore_nbest(
        *nolm(), blm, HLM_ALPHA, HLM_BETA))
    # score_chunk alone on the first chunk's emitted tokens
    lpk, ck, lpb = inputs[:3]
    bp_c = beam_search_cuda.beam_step_cuda(
        lpk[:CHUNK_T], ck[:CHUNK_T], lpb[:CHUNK_T], il, 8, 16, 256, 0,
        state_in=beam_search_cuda.beam_state_init(8, 128, dev))[0]
    toks = beam_search_cuda.lane_walk_cuda(bp_c, ck[:CHUNK_T], 8, 16)[1]
    toks = compact_rows(toks.transpose(0, 1).reshape(8 * 128, CHUNK_T))
    st0 = blm.init_state(8 * 128)
    ms["score_chunk_word3"] = time_both(
        "score_chunk_word3", lambda: blm.score_chunk(st0, toks))
    lp0, il0 = lps[0]
    ms["decode_composite_pipeline_b8"] = time_ms(lambda: beam_search_decode(
        lp0, il0, lm=slice29["lm"], guide_lm=slice29["guide"],
        **slice29["kw"]))
    for k, val in ms.items():
        log(f"phase 30 time {k}: {val:.3f} ms")
    log(f"phase 30 score_chunk on one chunk's tokens ({int((toks >= 0).sum())}"
        f" emitted in {toks.shape[0]} rows of {CHUNK_T}): "
        f"{DEVICE_MS['score_chunk_word3'][0]:.3f} ms device "
        f"({DEVICE_MS['score_chunk_word3'][1]}), one call "
        f"{ms['score_chunk_word3']:.3f}")
    for k, b in (("decode_word3_chunked_b128", 128),
                 ("decode_word3_rescore_b128", 128),
                 ("decode_composite_pipeline_b8", 8)):
        log(f"phase 30 {k}: {b * 1e3 / ms[k]:.1f} seq/s")
    return ms


# the transducer decoding slice (phases 31, 32): the ALSD beam's scores
# card vs CPU where the best hypotheses agree (float32 sums of ~T + S
# per-step log-probs in other orders); the transducer MWER term on the
# card and on the CPU in float32, each against a float64 witness on the
# same N-best: its loss relative, each hypothesis's score relative
# (well-conditioned float32 sums; also the long form's score against its
# one-shot decode); the loss's gradient sum_w c_w grad s_w (c = dloss /
# ds, sum_w c_w = 0) cancels, so float32 errors of the score gradients
# grow by kappa = |sum_w |c_w| grad s_w| / |gradient| (22 to 4,430 per
# tensor on an H100 at these seeds: 256-token hypotheses differing in a
# token or two, T'=750): each gradient's error is measured against
# |sum_w |c_w| grad s_w| (the witness's; ~1e-6 of it on the card and the
# CPU there), and that well-conditioned sum itself against its norm
ALSD_SCORE_TOL = 1e-3
RNNT_MWER_TOL = 1e-3
RNNT_MWER_SCORE_RTOL = 1e-5
RNNT_SCORE_GRAD_TOL = 1e-4
RNNT_MWER_GRAD_TOL = 1e-3
STREAM_CHUNK = 40  # encoder frames a streamed transducer chunk (1.6 s)
S_CAP = 256  # the model decodes' symbol cap (the streaming decoders')
# the blank logit's bias of phase 31's freshly seeded model: unbiased it
# emits at nearly every step and fills every hypothesis on its first
# frames; at 1.7 its greedy and beam-4 decodes emit ~0.2-0.45 tokens a
# frame across the utterance (on 6 s of noise, the CPU), so a beam-4
# hypothesis reaches the cap ~3/4 of the way through 30 s
DECODE_BLANK_BIAS = 1.7
CTC_STREAM_CHUNK = 64  # frames a streamed CTC lattice chunk


def bench_decoder(dev, n=16, t=400, v=256, blank_bias=0.0, seed=0,
                  h_enc=256, emb=128, hid=256, jdim=256):
    """bench.py's `_rnnt_decoder` draw: (N, T, 256) encoder outputs, a
    GRU-256 predictor, a factored 256-wide joint (blank_bias on the blank
    logit) on `dev`: (enc, lengths, predictor_step, h0, joint)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, t, h_enc)).astype(np.float32)
    p = {k: torch.from_numpy(a).to(dev) for k, a in random_gru_params(
        rng, v, emb_dim=emb, hidden_dim=hid).items()}

    def w(*shape):
        return (rng.standard_normal(shape) * 0.5
                / np.sqrt(shape[0])).astype(np.float32)

    ws = [w(h_enc, jdim), w(hid, jdim), 0.1 * w(jdim), w(jdim, v)]
    ws.append(0.1 * w(v))
    ws[4][0] += blank_bias
    return (torch.from_numpy(enc).to(dev),
            torch.full((n,), t, dtype=torch.int32, device=dev),
            partial(gru_step, p), torch.zeros(hid, device=dev),
            FactoredAdditiveJoint(*(torch.from_numpy(a).to(dev)
                                    for a in ws)))


def bench_bigram(dev, v=256):
    """bench.py's `bench_rnnt_beam_lm` bigram: a log-normalised random
    (V, V) table from seed 1."""
    tbl = np.random.default_rng(1).normal(size=(v, v)).astype(np.float32)
    tbl = tbl - np.log(np.exp(tbl).sum(1, keepdims=True))
    return NGramLM(tbl, device=dev)


def joint_calls(fn, joint):
    """(fn(counting joint), how many times the per-step joint ran): the
    sequential steps of a greedy or ALSD decode (plus one for a blank
    tail's batched pass)."""
    calls = [0]

    def counted(f, h):
        calls[0] += 1
        return joint.from_projected(f, h)

    counting = copy.copy(joint)
    counting.from_projected = counted
    out = fn(counting)
    return out, calls[0]


def same_decode(got, want, what):
    """Tokens, lengths (and times) equal; the largest score difference
    among live hypotheses, logged and returned."""
    for i in ((0, 1, 3) if len(got) == 4 else (0, 1)):
        if not torch.equal(got[i].cpu(), want[i].cpu()):
            raise AssertionError(f"{what}: output {i} differs")
    live = want[2] > -1e29
    err = float((got[2] - want[2].to(got[2].device))[live].abs().max())
    log(f"{what}: tokens, lengths and times equal; max score diff "
        f"{err:.3g}")
    return err


def best_agree(card, cpu, what):
    """Card vs CPU decodes: requests whose best hypotheses agree and the
    largest score difference among them (asserted <= ALSD_SCORE_TOL)."""
    tc, lc, sc = (x.cpu() for x in card[:3])
    tp, lp, sp = cpu[:3]
    same = [i for i in range(tc.shape[0])
            if torch.equal(tc[i, 0, :lc[i, 0]], tp[i, 0, :lp[i, 0]])]
    err = max((abs(float(sc[i, 0]) - float(sp[i, 0])) for i in same),
              default=float("nan"))
    log(f"{what}: {len(same)} of {tc.shape[0]} best hypotheses equal on "
        f"the card and the CPU, their max score diff {err:.3g}")
    if not same or err > ALSD_SCORE_TOL:
        raise AssertionError(f"{what}: card vs CPU {len(same)} equal, "
                             f"score diff {err}")
    return len(same), err


def kernel_vs_plain_alsd(args, kw, what):
    """The same ALSD decode with `topk` (K3) and with `topk_plain` on the
    card: every output bit-equal."""
    want = rnnt_beam_decode(*args, return_timestamps=True, **kw)
    rnnt_decode.topk = topk_cuda.topk_plain
    try:
        plain = rnnt_beam_decode(*args, return_timestamps=True, **kw)
    finally:
        rnnt_decode.topk = topk_cuda.topk
    if not all(torch.equal(a, b) for a, b in zip(want, plain)):
        raise AssertionError(f"{what}: K3 and topk_plain beams differ")
    return want


def stream_rnnt(dec, state, enc, il, chunk):
    """Step a streaming transducer decoder through enc in chunks."""
    for lo in range(0, enc.shape[1], chunk):
        hi = min(lo + chunk, enc.shape[1])
        state = dec.step(state, enc[:, lo:hi], (il - lo).clamp(0, hi - lo))
    return state


def stream_ctc(dec, state, lp, il, chunk):
    for lo in range(0, lp.shape[0], chunk):
        hi = min(lo + chunk, lp.shape[0])
        state = dec.step(state, lp[lo:hi], (il - lo).clamp(0, hi - lo))
    return state


def rnnt_mwer_step(model, enc, enc_len, tgt, tl, max_symbols=None):
    """The transducer MWER term (beam 4) on `enc`, backward through it
    and the model's predictor and joint; (loss, aux)."""
    pred, h0, joint = model.decoder_fns()
    loss, aux = rnnt_mwer_loss(enc, enc_len, tgt, tl, pred, h0, joint,
                               beam_width=4, max_symbols=max_symbols,
                               return_aux=True)
    loss.backward()
    return loss, aux


def mwer_witness(model, model_cpu, enc, enc_len, pred, h0, joint):
    """The transducer MWER term after its decode (`_rnnt_mwer_from_nbest`,
    what `rnnt_mwer_loss` runs on its N-best) on the card, on the CPU in
    float32 and, as the witness, on the CPU in float64 (a float64 copy of
    the predictor and the unfactored joint), all three on the card's
    beam-4 N-best of `enc`, each request's best hypothesis as its
    reference (errors 0 for it, > 0 for the others, so the gradients are
    not all 0).  Logs and checks each float32 run against the witness."""
    hyp = rnnt_beam_decode(enc, enc_len, pred, h0, joint, beam_width=4,
                           max_symbols=S_CAP)
    hyp_cpu = rnnt_beam_decode(enc.cpu(), enc_len.cpu(),
                               *model_cpu.decoder_fns(), beam_width=4,
                               max_symbols=S_CAP)
    nbest_same = sum(torch.equal(hyp[0][i].cpu(), hyp_cpu[0][i])
                     and torch.equal(hyp[1][i].cpu(), hyp_cpu[1][i])
                     for i in range(enc.shape[0]))
    valid = torch.isfinite(hyp[2]) & (hyp[2] > -1e29)
    m64 = copy.deepcopy(model_cpu).double()
    j64 = m64.joint
    runs = (("card", model, torch.float32, enc.device,
             (pred, h0, joint)),
            ("cpu", model_cpu, torch.float32, "cpu",
             model_cpu.decoder_fns()),
            ("float64", m64, torch.float64, "cpu",
             (partial(gru_step, m64.pred),
              torch.zeros(m64.config.pred_hidden, dtype=torch.float64),
              additive_joint(j64["w_enc"], j64["w_pred"], j64["b"],
                             j64["w_out"], j64["b_out"]))))
    def leaf_grads(m, e):
        g = {k: p.grad.cpu().double() for k, p in m.named_parameters()
             if p.grad is not None}
        g["encoder_out"] = e.grad.cpu().double()
        m.zero_grad()
        e.grad = None
        return g

    # the float64 witness first: its |dloss/dscore| weight the scores'
    # gradients of every run
    out, c64 = {}, None
    for name, m, dt, d, fns in runs[::-1]:
        m.zero_grad()
        e = enc.detach().to(d, dt).requires_grad_()
        loss, aux = mwer._rnnt_mwer_from_nbest(
            e, enc_len.to(d).long(), hyp[0].to(d), hyp[1].to(d),
            valid.to(d), hyp[0][:, 0].to(d), hyp[1][:, 0].to(d), *fns, 0,
            "token", None, 1.0, "mean", "auto", True)
        score, vd = aux["scores"], valid.to(d)
        if c64 is None:
            c64 = torch.autograd.grad(loss, score, retain_graph=True)[0]
            c64 = c64.abs().cpu()
        loss.backward(retain_graph=True)
        grads = leaf_grads(m, e)
        (score[vd] * c64.to(d, dt)[vd]).sum().backward()
        out[name] = (loss.item(), grads, leaf_grads(m, e),
                     aux["errors"].cpu().double(),
                     score.detach().cpu().double())
    l64, g64, wg64, err64, s64 = out["float64"]
    hl = hyp[1].long()
    # kappa: how much the loss's gradient cancels, per tensor
    scale = {k: float(g.norm()) for k, g in wg64.items()}
    kappa = {k: scale[k] / max(float(g64[k].norm()), 1e-30) for k in g64}
    log(f"phase 31 rnnt_mwer_loss after its decode, on the card's beam-4 "
        f"N-best of 4 requests (hypothesis lengths {hl.min().item()}-"
        f"{hl.max().item()}, T'={enc.shape[1]}; the CPU's N-best equal for "
        f"{nbest_same} of 4), the best hypotheses as references: errors "
        f"{err64.tolist()}, float64 loss {l64:.9f}; kappa = |sum |c| grad "
        f"s| / |grad loss| (float64) per tensor: "
        + ", ".join(f"{k} {v:.3g}" for k, v in kappa.items()))

    def norm_errs(grads, want, by):
        return {k: float((grads[k] - g).norm()) / max(by[k], 1e-30)
                for k, g in want.items()}

    for name in ("card", "cpu"):
        loss, grads, wgrads, e_cnt, sc = out[name]
        rel = abs(loss - l64) / max(abs(l64), 1e-12)
        score_rel = float(((sc - s64).abs() / s64.abs().clamp(min=1.0))[
            valid.cpu()].max())
        w_err = norm_errs(wgrads, wg64, scale)
        c_err = norm_errs(grads, g64, scale)
        g_err = norm_errs(grads, g64, {k: float(g.norm())
                                       for k, g in g64.items()})
        w_top, c_top, g_top = (max(x, key=x.get)
                               for x in (w_err, c_err, g_err))
        log(f"phase 31 MWER {name} float32 vs the float64 witness: loss "
            f"{loss:.9f} (rel err {rel:.3g}); hypothesis scores rel err "
            f"{score_rel:.3g}; the |c|-weighted score gradient sum |c| "
            f"grad s: largest error {w_err[w_top]:.3g} of its norm "
            f"({w_top}); the loss's gradients (the encoder output and "
            f"{len(g64) - 1} predictor and joint tensors): largest error "
            f"{c_err[c_top]:.3g} of |sum |c| grad s| ({c_top}), "
            f"{g_err[g_top]:.3g} of their own norm ({g_top}); each, of "
            f"|sum |c| grad s|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in c_err.items()))
        if (rel > RNNT_MWER_TOL or score_rel > RNNT_MWER_SCORE_RTOL
                or w_err[w_top] > RNNT_SCORE_GRAD_TOL
                or c_err[c_top] > RNNT_MWER_GRAD_TOL
                or set(grads) != set(g64) or not torch.equal(e_cnt, err64)):
            raise AssertionError(
                f"phase 31 MWER {name} vs float64: loss {rel}, scores "
                f"{score_rel}, weighted {w_err}, gradients {c_err}, "
                f"errors {e_cnt.tolist()}")


def rnnt_counts():
    return {"topk": topk_cuda.launches, **rnnt_loss_cuda.launches}


def reset_rnnt_counts():
    topk_cuda.launches = 0
    for k in rnnt_loss_cuda.launches:
        rnnt_loss_cuda.launches[k] = 0


def transducer_decode_slice(model, model_cpu, batch, ctc_lps, dev):
    """Phase 31: the transducer decoding slice at full width (docstring at
    the top).  Returns (launches of the main path, of the MWER step, the
    largest kernel-vs-plain and card-vs-CPU errors, the inputs phase 32
    times)."""
    feats, lens, tgt, tl = batch
    model_cpu.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    lm = seeded_bigram(np.random.default_rng(SEED + 31), 32, dev)
    bench = bench_decoder(dev)
    bench_rt = bench_decoder(dev, blank_bias=1.1)
    blm = bench_bigram(dev)
    long_feats = log_mel_spectrogram(torch.from_numpy(
        0.1 * np.random.default_rng(SEED + 60).standard_normal(
            60 * 16000).astype(np.float32)).to(dev)[None])[0]
    partials = []
    torch.cuda.synchronize()
    reset_rnnt_counts()
    # the main path: the model's beam-4 decodes (and with the bigram), the
    # bench rows, the streaming transducer decoders, the long form
    m_out = model.decode(feats, lens, beam_width=4, max_symbols=S_CAP,
                         return_timestamps=True)
    m_lm = model.decode(feats, lens, beam_width=4, max_symbols=S_CAP, lm=lm,
                        lm_alpha=0.5, lm_beta=0.2, return_timestamps=True)
    b_out = rnnt_beam_decode(*bench, beam_width=4, max_symbols=128,
                             return_timestamps=True)
    b_lm = rnnt_beam_decode(*bench, beam_width=4, max_symbols=128, lm=blm,
                            lm_alpha=0.5, lm_beta=0.2,
                            return_timestamps=True)
    g8 = rnnt_greedy_decode(*bench_rt, max_symbols=128, lookahead=8,
                            return_timestamps=True)
    with torch.no_grad():
        enc, enc_len = model.encode(feats, lens)
    pred, h0, joint = model.decoder_fns()
    sg = StreamingRNNTGreedyDecoder(pred, h0, joint, max_symbols=S_CAP)
    sg_out = sg.finish(stream_rnnt(sg, sg.init(8), enc, enc_len,
                                   STREAM_CHUNK), return_timestamps=True)
    sb = StreamingRNNTBeamDecoder(pred, h0, joint, beam_width=4,
                                  max_symbols=S_CAP)
    sb_out = sb.finish(stream_rnnt(sb, sb.init(8, enc.shape[2]), enc,
                                   enc_len, STREAM_CHUNK),
                       return_timestamps=True)
    lf = {bw: transcribe_long_form_rnnt(
        model, long_feats.cpu().numpy(), beam_width=bw,
        partial_cb=lambda t, n, i: partials.append((bw, i)))
        for bw in (0, 4)}
    torch.cuda.synchronize()
    launches = rnnt_counts()
    log(f"phase 31 the transducer decoding slice: model beam-4 decodes "
        f"(B=8 x 30 s, T'={enc.shape[1]}; + bigram LM alpha 0.5 beta 0.2), "
        f"bench rows rnnt_beam4 and +bigramLM (B=16, T=400, V=256, GRU-256, "
        f"joint 256, s_cap 128), greedy lookahead 8 (blank bias 1.1), the "
        f"streaming greedy and beam-4 decoders ({STREAM_CHUNK}-frame "
        f"chunks), transcribe_long_form_rnnt on 60 s ({long_feats.shape[0]}"
        f" feature frames, greedy and beam 4): launches {launches}")
    if launches["topk"] < 1:
        raise AssertionError(f"K3 never ran on the ALSD path: {launches}")
    for name, out in (("model", m_out), ("model+LM", m_lm),
                      ("rnnt_beam4", b_out), ("rnnt_beam4+bigramLM", b_lm)):
        best = out[2][:, 0]
        if not (torch.isfinite(best).all() and (best > -1e29).all()
                and (out[1] <= out[0].shape[-1]).all()):
            raise AssertionError(f"phase 31 {name}: bad beam")
        log(f"phase 31 {name}: best lengths {out[1][:, 0].tolist()}, best "
            f"scores {[round(x, 3) for x in best.tolist()]}")
    # the long form against the one-shot decodes of its chunks' trimmed
    # encoder outputs stitched along time
    n_lf = {bw: sum(1 for b, _ in partials if b == bw) for bw in (0, 4)}
    stitch = torch.cat(list(_rnnt_encoded_chunks(
        model, long_feats.cpu().numpy())), 1)
    one_shot = {0: rnnt_greedy_decode(stitch, None, pred, h0, joint,
                                      max_symbols=512),
                4: [x[:, 0] for x in rnnt_beam_decode(
                    stitch, None, pred, h0, joint, beam_width=4,
                    max_symbols=512)]}
    for bw, (tok, n, sc) in lf.items():
        o_tok, o_len, o_score = (x[0].cpu() for x in one_shot[bw])
        same = n == int(o_len) and torch.equal(tok[:n].cpu(), o_tok[:n])
        diff = abs(sc - float(o_score))
        log(f"phase 31 transcribe_long_form_rnnt beam {bw}: length {n}, "
            f"score {sc:.3f}, {n_lf[bw]} partial results; the one-shot "
            f"decode of the stitched encoder output ({stitch.shape[1]} "
            f"frames): tokens and length equal {same}, score diff "
            f"{diff:.3g}")
        if not (same and n > 0 and n_lf[bw] > 1
                and diff <= RNNT_MWER_SCORE_RTOL * max(abs(sc), 1.0)):
            raise AssertionError(f"phase 31 long form beam {bw}: {n}, "
                                 f"{int(o_len)}, {same}, {diff}")
    # K3 against topk_plain on the card, every ALSD output bit-equal
    kvp = [kernel_vs_plain_alsd((enc, enc_len, pred, h0, joint),
                                dict(beam_width=4, max_symbols=S_CAP),
                                "phase 31 model"),
           kernel_vs_plain_alsd((enc, enc_len, pred, h0, joint),
                                dict(beam_width=4, max_symbols=S_CAP, lm=lm,
                                     lm_alpha=0.5, lm_beta=0.2),
                                "phase 31 model+LM"),
           kernel_vs_plain_alsd(bench, dict(beam_width=4, max_symbols=128),
                                "phase 31 rnnt_beam4"),
           kernel_vs_plain_alsd(bench, dict(beam_width=4, max_symbols=128,
                                            lm=blm, lm_alpha=0.5,
                                            lm_beta=0.2),
                                "phase 31 rnnt_beam4+bigramLM")]
    log("phase 31 ALSD with K3 == with topk_plain on the card (tokens, "
        "lengths, scores, times bit-equal) for the model, model+LM and the "
        "two bench rows")
    same_decode(kvp[2], b_out, "phase 31 rnnt_beam4 again")
    log(f"phase 31 model.decode (its own encoder pass) == rnnt_beam_decode "
        f"on model.encode's output: "
        f"{all(torch.equal(a, b) for a, b in zip(m_out, kvp[0]))}")
    # lookahead: the same greedy decode as lookahead 1
    g1 = rnnt_greedy_decode(*bench_rt, max_symbols=128,
                            return_timestamps=True)
    same_decode(g8, g1, "phase 31 greedy lookahead 8 vs 1 (bench, blank "
                        "bias 1.1)")
    # the card against the CPU on the same encoder outputs
    cpu_fns = model_cpu.decoder_fns()
    enc_c, len_c = enc.cpu(), enc_len.cpu()
    best_agree(kvp[0], rnnt_beam_decode(
        enc_c, len_c, *cpu_fns, beam_width=4, max_symbols=S_CAP),
        "phase 31 model beam-4")
    best_agree(kvp[2], rnnt_beam_decode(
        *bench_decoder("cpu"), beam_width=4, max_symbols=128),
        "phase 31 rnnt_beam4")
    # streaming against one-shot on the card
    lp, il = ctc_lps[0]
    gdec = StreamingGreedyDecoder(max_symbols=lp.shape[0])
    bdec = StreamingBeamDecoder(beam_width=8, prune_k=16)
    for got, want, what in (
            (sg_out, rnnt_greedy_decode(enc, enc_len, pred, h0, joint,
                                        max_symbols=S_CAP,
                                        return_timestamps=True),
             f"streaming greedy ({STREAM_CHUNK}-frame chunks) vs one-shot"),
            (sb_out, kvp[0],
             f"streaming beam-4 ({STREAM_CHUNK}-frame chunks) vs one-shot"),
            (gdec.finish(stream_ctc(gdec, gdec.init(8, device=dev), lp, il,
                                    CTC_STREAM_CHUNK)),
             greedy_decode(lp, il),
             f"CTC streaming greedy ({CTC_STREAM_CHUNK}-frame chunks) vs "
             "greedy_decode"),
            (bdec.finish(stream_ctc(bdec, bdec.init(8, device=dev), lp, il,
                                    CTC_STREAM_CHUNK),
                         return_timestamps=True),
             beam_search_decode(lp, il, beam_width=8, prune_k=16,
                                max_symbols=512, implementation="xla",
                                return_timestamps=True),
             "CTC streaming beam-8 vs the one-shot prefix-beam scan")):
        same_decode(got, want, f"phase 31 {what}")
    # one transducer MWER step through the model (encoder included)
    torch.cuda.synchronize()
    reset_rnnt_counts()
    model.zero_grad()
    enc_g, len_g = model.encode(feats, lens)
    loss, aux = rnnt_mwer_step(model, enc_g, len_g, tgt, tl)
    torch.cuda.synchronize()
    mwer_launches = rnnt_counts()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    finite = np.isfinite(loss.item()) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    log(f"phase 31 rnnt_mwer_loss step (B=8 x 30 s, beam 4, targets of "
        f"T'/5 labels): loss {loss.item():.6f}, {len(grads)} parameter "
        f"gradients, all finite: {finite}; launches {mwer_launches}; "
        f"errors {aux['errors'][0].tolist()}")
    w = 4
    if not finite or mwer_launches["rnnt_alpha"] != w or \
            mwer_launches["rnnt_posteriors"] != w:
        raise AssertionError(f"phase 31 MWER step: finite {finite}, "
                             f"launches {mwer_launches}")
    mwer_witness(model, model_cpu, enc[:4], enc_len[:4], pred, h0, joint)
    return {"launches": launches, "mwer_launches": mwer_launches,
            "bench": bench, "bench_rt": bench_rt, "blm": blm,
            "enc": (enc, enc_len)}


def decode_profile(fn):
    """One call of fn under torch.profiler: the device time of its
    kernels and of K3's, in ms, and their launch counts."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    k3 = [e for e in rows if "topk_" in e.key]
    return {"kernels": sum(e.self_device_time_total for e in rows) / 1e3,
            "launches": sum(e.count for e in rows),
            "k3": sum(e.self_device_time_total for e in k3) / 1e3,
            "k3_launches": sum(e.count for e in k3)}


def transducer_decode_timings(model, batch, s31):
    """Phase 32: CUDA-event medians of 5 of the slice's decodes, with
    seq/s and the sequential steps of the bench rows."""
    feats, lens, tgt, tl = batch
    bench, bench_rt, blm = s31["bench"], s31["bench_rt"], s31["blm"]
    enc, enc_len = s31["enc"]
    ms, steps = {}, {}
    b_args, joint = bench[:4], bench[4]
    for key, kw in (("rnnt_beam4_bench", {}),
                    ("rnnt_beam4_lm_bench", dict(lm=blm, lm_alpha=0.5,
                                                 lm_beta=0.2))):
        ms[key] = time_ms(lambda: rnnt_beam_decode(
            *b_args, joint, beam_width=4, max_symbols=128, **kw))
        steps[key] = joint_calls(lambda j: rnnt_beam_decode(
            *b_args[:4], j, beam_width=4, max_symbols=128, **kw), joint)[1]
    rt_args, rt_joint = bench_rt[:4], bench_rt[4]
    for f in (8, 1):
        key = f"rnnt_greedy_rt{f}_bench"
        ms[key] = time_ms(lambda: rnnt_greedy_decode(
            *rt_args, rt_joint, max_symbols=128, lookahead=f))
        steps[key] = joint_calls(lambda j: rnnt_greedy_decode(
            *rt_args, j, max_symbols=128, lookahead=f), rt_joint)[1]
    ms["transducer_beam4_b8_30s"] = time_ms(
        lambda: model.decode(feats, lens, beam_width=4))
    pred, h0, j = model.decoder_fns()
    steps["transducer_beam4_b8_30s"] = joint_calls(
        lambda jj: rnnt_beam_decode(enc, enc_len, pred, h0, jj,
                                    beam_width=4), j)[1]
    # one streamed chunk: the decoders' step on frames 200-239 of the
    # blank-dominated bench decoder (B=16, ~5% emissions), from the state
    # after frames 0-199 (a step is pure, so it repeats)
    rt_enc, rt_len = bench_rt[:2]
    lo = 200
    chunk = rt_enc[:, lo:lo + STREAM_CHUNK]
    cl = (rt_len - lo).clamp(0, STREAM_CHUNK)
    for key, dec, st in (
            ("stream_greedy_chunk_bench", StreamingRNNTGreedyDecoder(
                *bench_rt[2:], max_symbols=128), None),
            ("stream_beam4_chunk_bench", StreamingRNNTBeamDecoder(
                *bench_rt[2:], beam_width=4, max_symbols=128),
             rt_enc.shape[2])):
        n_rt = rt_enc.shape[0]
        st = dec.init(n_rt) if st is None else dec.init(n_rt, st)
        st = stream_rnnt(dec, st, rt_enc[:, :lo], rt_len.clamp(max=lo),
                         STREAM_CHUNK)
        ms[key] = time_ms(lambda: dec.step(st, chunk, cl))
    # where the ALSD bench row's time goes: its kernels' device time (and
    # K3's) under torch.profiler against the row's CUDA-event time
    prof_ms = decode_profile(lambda: rnnt_beam_decode(
        *bench, beam_width=4, max_symbols=128))
    if prof_ms["launches"]:
        log(f"phase 32 rnnt_beam4 under torch.profiler: "
            f"{prof_ms['launches']} kernel launches, {prof_ms['kernels']:.3f}"
            f" ms of device time (K3 {prof_ms['k3']:.3f} ms in "
            f"{prof_ms['k3_launches']} launches), against "
            f"{ms['rnnt_beam4_bench']:.3f} ms a call: the device idle "
            f"{1 - prof_ms['kernels'] / ms['rnnt_beam4_bench']:.3f} of it")
    else:
        log("phase 32 rnnt_beam4 under torch.profiler: no kernel traced, "
            "its device time not measured")
    # the MWER step and its parts
    hyp = rnnt_beam_decode(enc, enc_len, pred, h0, j, beam_width=4)
    tok, hl = mwer._trim_nbest(hyp[0].long(), hyp[1].long()), hyp[1].long()
    tgt_t = torch.as_tensor(tgt, device=enc.device).long()
    tl_t = torch.as_tensor(tl, device=enc.device).long()

    def whole():
        model.zero_grad()
        e, el = model.encode(feats, lens)
        rnnt_mwer_step(model, e, el, tgt, tl)

    def scoring():
        e = enc.detach().requires_grad_()
        mwer._rnnt_score_nbest(e, enc_len, tok, hl, pred, h0, j, 0,
                               "auto").sum().backward()

    ms["rnnt_mwer_step_b8_30s"] = time_ms(whole)
    ms["rnnt_mwer_decode"] = time_ms(lambda: rnnt_beam_decode(
        enc, enc_len, pred, h0, j, beam_width=4))
    ms["rnnt_mwer_scoring_fwd_bwd"] = time_ms(scoring)
    ms["rnnt_mwer_errors"] = time_ms(lambda: mwer._nbest_errors(
        tok, hl, tgt_t, tl_t, "token", None))
    for k, v in ms.items():
        extra = ""
        if k in steps:
            extra = (f", {steps[k]} sequential steps, "
                     f"{v / steps[k]:.3f} ms each")
        if "chunk" not in k:
            extra += f"; {(16 if 'bench' in k else 8) * 1e3 / v:.1f} seq/s"
        log(f"phase 32 time {k}: {v:.3f} ms{extra}")
    log(f"phase 32 the MWER step's N-best: hypothesis lengths "
        f"{hl.min().item()}-{hl.max().item()}, S'={tok.shape[-1]}, "
        f"S_ref={tgt_t.shape[1]}; lattices (8, {enc.shape[1]}, "
        f"{tok.shape[-1] + 1}, {model.config.vocab_size}) one hypothesis at "
        f"a time")
    return ms



# --------------------------------------------------------------------------
# 33-35: the OCR recognizer, the Dense-front-end transducer and the
# multi-GPU slice
# --------------------------------------------------------------------------

# BASELINE config 3 (bench.py's OCR row): B, image height, the widest
# line (T' = W/4 = 256 columns), S, V; beam 10, prune 16
OCR_ROW = (64, 32, 1024, 64, 96)
OCR_BEAM, OCR_PRUNE = 10, 16
GLYPH_W = 16  # pixels a character (examples/ocr_demo.py's glyphs)
DENSE_SECS = 10  # the Dense-front-end transducer's requests (T = 1000)
MG_RANKS = 4
# the multi-GPU slice's problems: config 2 (B, T, S, V); bench.py's RNN-T
# row (B, T, U, V); its large-vocab row (B, T, S, V); its beam-16 row
# (B, T, V, W, K); the time-parallel loss (B, T, S, V)
MG_DP_CTC = (32, 1000, 200, 29)
MG_DP_RNNT = (8, 400, 80, 256)
MG_VP_CTC = (16, 1000, 100, 32768)
MG_VP_BEAM = (32, 1000, 1024, 16, 32)
MG_TP_CTC = (4, 8000, 20, 29)
# the time-parallel loss (float64 inside) against the float64 plain scan,
# and its NLL against the unsharded float32 K1's: the NLL relative, the
# gradient of the witness's max (JAX's bound at T=64; the float32 scan's
# own log-domain rounding grows with T, so the float32 K1/K2 gradient is
# held to the witness beside it, not the time-parallel one to it)
TP_CTC_TOL = 1e-4
# the data-parallel greedy scores against the unsharded decode's: float32
# sums of up to 1000 frames' maxima, reduced over rows of another batch
# size and so in another order
DP_SCORE_RTOL = 1e-5


def ocr_batch(rng, dev):
    """B seeded text lines: targets of S/4..S characters, each drawn as
    examples/ocr_demo.py's glyph (a sine pattern keyed by its id) GLYPH_W
    pixels wide, plus noise; the line's width is its text's, the padding
    zero.  Returns images (N, H, W) on the card, widths, targets and
    target lengths."""
    b, h, w_max, s_max, v = OCR_ROW
    tl = rng.integers(s_max // 4, s_max + 1, b).astype(np.int32)
    tl[0] = s_max  # one line fills the bucket: T' = 256
    tgt = rng.integers(1, v, (b, s_max)).astype(np.int32)
    gy, gx = np.mgrid[0:h, 0:GLYPH_W]
    cid = np.arange(v)[:, None, None]
    glyphs = np.sin(0.7 * cid * gx + gy * 0.31 * (cid % 5 + 1))
    img = glyphs[tgt].transpose(0, 2, 1, 3).reshape(b, h, w_max)
    img = img + 0.05 * rng.standard_normal(img.shape)
    widths = tl * GLYPH_W
    img = np.where(np.arange(w_max) < widths[:, None, None], img, 0.0)
    return (torch.from_numpy(img.astype(np.float32)).to(dev),
            torch.from_numpy(widths).to(dev), tgt, tl)


def zero_ctc_counts():
    for k in ctc_loss_cuda.launches:
        ctc_loss_cuda.launches[k] = 0


def ocr_log_probs(model, images, widths):
    logits, ow = model(images, widths)
    return torch.log_softmax(logits, -1).transpose(0, 1).contiguous(), ow


def blank_shift(lp, ow):
    """The median margin by which the blank leads the best other label over
    the valid frames: taking it off the blank's bias leaves about half the
    frames' best label a character (a freshly stepped recognizer's blank
    leads everywhere, and its beams would be empty)."""
    valid = torch.arange(lp.shape[0], device=lp.device)[:, None] < ow[None]
    margin = lp[:, :, 0] - lp[:, :, 1:].amax(-1)
    return float(margin[valid].median())


def check_beam_w10(args, what):
    """K4 at W=10 against its plain twin on the card (codes, scores and
    state bit for bit), and the backtrace kernel and the lane walk on its
    codes against theirs.  Returns (the kernel's output, the plain twin's,
    the number of codes, the largest |kernel - plain| of the beam scores,
    of the backtrace)."""
    lpk, ck, _, _, W, K, s_cap, _ = args
    kern = beam_search_cuda.beam_step_cuda(*args)
    plain = beam_search_cuda.beam_step_plain(*args)
    torch.cuda.synchronize()
    n_codes = assert_same_bits(kern, plain, f"{what}: K4 at W=10 vs plain")
    score_err = float((kern[1] - plain[1]).nan_to_num().abs().max())
    bt_err, walk_err = check_backtrace(kern[0], ck, kern[1], W, K, s_cap,
                                       f"{what}: the backtrace at W=10")
    got = beam_sets(*beam_search_cuda.backtrace(kern[0], ck, kern[1], W, K,
                                                s_cap)[:3])
    want = beam_sets(*beam_search_cuda.backtrace_plain(
        plain[0], ck, plain[1], W, K, s_cap)[:3])
    set_err = compare_beams(got, want, f"{what}: beam sets at W=10")
    return (kern, plain, n_codes, max(score_err, set_err),
            max(bt_err, walk_err))


def ocr_slice(rng, dev):
    """Phase 33's OCR part: the recognizer built on the card by default, 3
    AdamW steps on the CTC loss (K1, K2 and the combine each step; step
    1's loss against the same model on the CPU), the beam-10 decode of the
    stepped model with its blank's bias lowered by `blank_shift` (K3, K4
    and the backtrace once; every line's best hypothesis non-empty), and
    K4 and the backtrace at W=10 against their plain twins on the card, on
    that decode's candidates and on a peaked lattice of the OCR row.
    Returns what phase 35 times and the kernels line reads."""
    b, h, w_max, s_max, v = OCR_ROW
    model = OCRRecognizer(v, generator=torch.Generator().manual_seed(SEED))
    if model.device != dev:
        raise AssertionError(f"the OCR model was built on {model.device}")
    images, widths, tgt, tl = ocr_batch(rng, dev)
    cpu = copy.deepcopy(model).cpu()
    with torch.no_grad():
        lp_c, ow_c = ocr_log_probs(cpu, images.cpu(), widths.cpu())
        c_loss = ctc_loss(lp_c, tgt, ow_c, tl).item()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)

    def step():
        opt.zero_grad()
        lp, ow = ocr_log_probs(model, images, widths)
        loss = ctc_loss(lp, tgt, ow, tl)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    zero_ctc_counts()
    losses = [step().item() for _ in range(3)]
    train = dict(ctc_loss_cuda.launches)
    rel = abs(losses[0] - c_loss) / abs(c_loss)
    log(f"phase 33 OCR training: OCRRecognizer(V={v}, d 128, 2 layers, 4 "
        f"heads) built on {model.device} by default, B={b} lines of H={h}, "
        f"widths {int(widths.min())}-{int(widths.max())} (T' up to "
        f"{w_max // 4}), targets of {int(tl.min())}-{int(tl.max())}; 3 AdamW "
        f"steps, losses {[round(x, 6) for x in losses]}, launches {train}; "
        f"step 1 CUDA {losses[0]:.6f} vs CPU {c_loss:.6f} (rel err "
        f"{rel:.3g})")
    if train != {"ctc_alpha": 3, "ctc_beta": 3, "ctc_grad": 3}:
        raise AssertionError(f"kernels missed on the OCR training path: "
                             f"{train}")
    if not all(np.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"bad OCR loss: {losses}")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"OCR CUDA loss vs CPU: rel err {rel}")
    with torch.no_grad():
        lp, ow = ocr_log_probs(model, images, widths)
        shift = blank_shift(lp, ow)
        model.out.bias[0] -= shift
        lp, ow = ocr_log_probs(model, images, widths)
    torch.cuda.synchronize()
    reset_counts()
    out = beam_search_decode(lp, ow, beam_width=OCR_BEAM, prune_k=OCR_PRUNE)
    torch.cuda.synchronize()
    decode = {"topk": topk_cuda.launches,
              "beam_step": beam_search_cuda.launches,
              "backtrace": beam_search_cuda.launches_backtrace}
    if decode != {"topk": 1, "beam_step": 1, "backtrace": 1}:
        raise AssertionError(f"kernels missed on the OCR decode: {decode}")
    if not torch.isfinite(out[2][:, 0]).all():
        raise AssertionError("OCR beam-10: a best score is not finite")
    lens = out[1][:, 0]
    if not (lens > 0).all():
        raise AssertionError(f"OCR beam-10: {int((lens == 0).sum())} of {b} "
                             "best hypotheses are empty")
    # K4 and the backtrace at W=10 against their plain twins on the card:
    # on the decode's own candidates, then on a peaked lattice of the row
    W, K = OCR_BEAM, min(OCR_PRUNE, v)
    s_cap = min(lp.shape[0], 512)
    il = ow.to(torch.int32)
    lpk, ck = topk_cuda.topk_plain(lp, min(K + 8, v))
    args = (lpk, ck, lp[:, :, 0].contiguous(), il, W, K, s_cap, 0)
    kern, plain, n_codes, score_err, bt_err = check_beam_w10(
        args, "phase 33 OCR")
    hyps = beam_search_cuda.backtrace_plain(plain[0], ck, plain[1], W, K,
                                            s_cap)[:3]
    if not all(torch.equal(a, c) for a, c in zip(out, hyps)):
        raise AssertionError("phase 33: the OCR decode differs from the "
                             "plain twins' hypotheses")
    lp_pk = torch.from_numpy(peaked_lattice(rng, lp.shape[0], b, v)).to(dev)
    lpk_pk, ck_pk = topk_cuda.topk_plain(lp_pk, min(K + 8, v))
    pk = check_beam_w10((lpk_pk, ck_pk, lp_pk[:, :, 0].contiguous(), il, W,
                         K, s_cap, 0), "phase 33 peaked lattice")
    pk_lens = beam_search_cuda.backtrace_plain(pk[1][0], ck_pk, pk[1][1], W,
                                               K, s_cap)[1][:, 0]
    score_err, bt_err = max(score_err, pk[3]), max(bt_err, pk[4])
    log(f"phase 33 OCR beam-10 / prune 16 (T'={lp.shape[0]}, B={b}): the "
        f"blank's bias lowered by {shift:.4f}; launches {decode}; best "
        f"lengths {int(lens.min())}-{int(lens.max())} (targets "
        f"{int(tl.min())}-{int(tl.max())}), the decode's hypotheses equal to "
        f"the plain twins'; K4 at W=10: 0 of {n_codes} codes differ from the "
        f"plain twin's (0 of {pk[2]} on a peaked lattice, best lengths "
        f"{int(pk_lens.min())}-{int(pk_lens.max())}), scores and state "
        f"bit-identical, max score err {score_err:.3g}")
    return {"step": step, "lp": lp, "ow": ow, "train": train,
            "decode": decode, "args": args, "kern": kern, "ck": ck,
            "beam_err": score_err, "err": bt_err}


def dense_batch(rng, dev, vocab):
    """8 requests of DENSE_SECS s (T = 1000 log-mel frames, which the
    model does not subsample) with random targets of T/5 labels."""
    n = DENSE_SECS * 16000
    wav = 0.1 * rng.standard_normal((8, n)).astype(np.float32)
    feats = log_mel_spectrogram(torch.from_numpy(wav).to(dev))
    lens = num_frames(torch.from_numpy(np.full(8, n, np.int64)))
    tl = (lens // 5).numpy().astype(np.int32)
    tgt = rng.integers(1, vocab, (8, int(tl.max()))).astype(np.int32)
    return feats, lens, tgt, tl


def dense_transducer_slice(rng, dev, ref_lib):
    """Phase 33's Dense-front-end transducer: ConformerTransducer(
    subsample=False) at its default widths on B=8 x 10 s (T = T' =
    1000): phase 16's checks on one batch (the loss against the CPU, the
    gradients through K8/K9 against the plain scan's, K8/K9 against their
    plain twins and the parent kernels at this shape), one AdamW step (K8
    and K9 once), and the greedy decode (the fresh weights, the blank
    biased by DECODE_BLANK_BIAS) on the card against the CPU.
    Returns what phase 35 times and the kernels line reads."""
    cfg = TransducerConfig(subsample=False)
    model = ConformerTransducer(cfg, seed=SEED + 33)
    if model.device != dev:
        raise AssertionError(f"the transducer was built on {model.device}")
    batch = dense_batch(rng, dev, cfg.vocab_size)
    *errs, dp, cpu = check_transducer_batch(model, batch, ref_lib,
                                            "phase 33 Dense front end")
    # the decode, on the fresh weights with the blank biased as phase 31's
    # (the trained step's model emits blanks only), card against CPU
    dmodel = copy.deepcopy(model)
    with torch.no_grad():
        dmodel.joint["b_out"][0] += DECODE_BLANK_BIAS
        cpu.load_state_dict({k: x.cpu() for k, x in
                             dmodel.state_dict().items()})
        feats, lens = batch[:2]
        tok, tlen, tsc = dmodel.decode(feats, lens)
        c_tok, c_len, c_sc = cpu.decode(feats.cpu(), lens)
    del dmodel
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)

    def step():
        opt.zero_grad()
        loss = model.loss(*batch)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    for c in (rnnt_loss_cuda.launches, gru_cuda.launches):
        for k in c:
            c[k] = 0
    loss = step().item()
    torch.cuda.synchronize()
    launches = dict(rnnt_loss_cuda.launches)
    gru_launches = dict(gru_cuda.launches)
    if launches != {"rnnt_alpha": 1, "rnnt_posteriors": 1} or \
            gru_launches != {"gru_forward": 1, "gru_backward": 1}:
        raise AssertionError(f"kernels missed on the Dense transducer step: "
                             f"{launches}, {gru_launches}")
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError(f"bad Dense transducer loss {loss}")
    same = [i for i in range(8)
            if torch.equal(tok[i, :int(tlen[i])].cpu(),
                           c_tok[i, :int(c_len[i])])]
    if not same or int(tlen.max()) == 0:
        raise AssertionError(f"Dense transducer greedy decode: {len(same)} "
                             f"of 8 alike card vs CPU, lengths "
                             f"{tlen.tolist()}")
    sc_err = max(abs(float(tsc[i]) - float(c_sc[i]))
                 / max(abs(float(c_sc[i])), 1.0) for i in same)
    log(f"phase 33 Dense-front-end transducer (d 144, 2 layers, 80 mels, "
        f"subsample=False): lattice {tuple(dp[0].shape)} x "
        f"V={cfg.vocab_size}; one AdamW step, loss {loss:.6f}, launches "
        f"{launches}, the predictor's {gru_launches}; greedy decode (blank "
        f"bias {DECODE_BLANK_BIAS}) "
        f"lengths {tlen.tolist()}, {len(same)} of "
        f"8 requests decode alike on the card and the CPU, their scores "
        f"within {sc_err:.3g} relative")
    if sc_err > ALSD_SCORE_TOL or not torch.isfinite(tsc).all():
        raise AssertionError(f"Dense transducer greedy decode card vs CPU: "
                             f"score err {sc_err}")
    return {"step": step, "launches": launches, "gru_launches": gru_launches,
            "errs": errs}


class CollectiveClock:
    """Inside the block every `dist.all_reduce` and `dist.all_gather` is
    timed (the card synchronised before and after), the seconds summed in
    `seconds`."""

    NAMES = ("all_reduce", "all_gather")

    def __enter__(self):
        self.seconds = 0.0
        self._orig = {k: getattr(dist, k) for k in self.NAMES}

        def timer(fn):
            def timed(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                return out
            return timed

        for k, fn in self._orig.items():
            setattr(dist, k, timer(fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(dist, k, fn)


def mg_time(fn, reps=3):
    """(median ms of fn over reps, the share of that run spent in
    collectives); the ranks start each run together."""
    runs = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        with CollectiveClock() as clock:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs.append((1e3 * wall, clock.seconds / wall))
    return sorted(runs)[len(runs) // 2]


def all_counts():
    """Every launch counter of the port's kernels, by kernel row name."""
    beam = beam_counts()
    return {**ctc_loss_cuda.launches, **rnnt_loss_cuda.launches,
            **rnnt_joint_cuda.launches, **gru_cuda.launches,
            "topk": topk_cuda.launches,
            "beam_step": beam["launches"], "beam_step_lm": beam["launches_lm"],
            "beam_step_cls": beam["launches_cls"],
            "beam_step_resume": beam["launches_resume"],
            "backtrace": beam["launches_backtrace"],
            "lane_walk": beam["launches_walk"], "ctc_align":
            alignment.launches}


def zero_all_counts():
    zero_ctc_counts()
    for c in (rnnt_loss_cuda.launches, rnnt_joint_cuda.launches,
              gru_cuda.launches):
        for k in c:
            c[k] = 0
    reset_counts()
    alignment.launches = 0


def counted(fn):
    """(fn(), the kernels it launched, those that ran)."""
    torch.cuda.synchronize()
    zero_all_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in all_counts().items() if n}


def mg_ctc_problem(seed, shape, dev, min_frac=0.5):
    """tests/conftest.py's CTC draw on the card: log-softmaxed 2x normal
    logits, lengths from min_frac T (sample 0 all T), targets of S/2..S
    labels and at most a third of the frames (sample 0 S)."""
    b, t, s, v = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, b, v)).astype(np.float32))
    lp = torch.log_softmax(2.0 * x.to(dev), -1)
    il = rng.integers(int(t * min_frac), t + 1, b).astype(np.int32)
    il[0] = t
    tl = np.minimum(rng.integers(s // 2, s + 1, b), il // 3).astype(np.int32)
    tl[0] = s
    tgt = rng.integers(1, v, (b, s)).astype(np.int32)
    return (lp, *(torch.from_numpy(a).to(dev) for a in (tgt, il, tl)))


def mg_dp(rank, dev):
    """The data-parallel paths on this rank's rows, each against the
    unsharded call on the whole batch (computed here, not counted)."""
    res = {}
    lp, tgt, il, tl = mg_ctc_problem(SEED + 341, MG_DP_CTC, dev)
    x, t_, i_, l_ = shard_batch(None, lp, tgt, il, tl)
    x = x.detach().clone().requires_grad_()

    def ctc_step():
        x.grad = None
        nll = ctc_loss_data_parallel(x.detach(), t_, i_, l_,
                                     reduction="none")
        ctc_loss_data_parallel(x, t_, i_, l_).backward()
        return nll

    nll, res["dp_ctc_launches"] = counted(ctc_step)
    y = lp.detach().clone().requires_grad_()
    ctc_loss(y, tgt, il, tl).backward()
    ref = ctc_nll(lp, tgt, il, tl)
    n = lp.shape[1] // MG_RANKS
    rows = slice(rank * n, (rank + 1) * n)
    res["dp_ctc"] = (torch.equal(nll, ref[rows]),
                     torch.equal(x.grad, y.grad[:, rows]),
                     float((nll - ref[rows]).abs().max()),
                     float((x.grad - y.grad[:, rows]).abs().max()))
    greedy, res["dp_greedy_launches"] = counted(
        lambda: greedy_decode_data_parallel(x.detach(), i_))
    want = [w[rows] for w in greedy_decode(lp, il)]
    # the scores' frame sums reduce (N, T) rows of another batch size, in
    # another order: their last bits may differ
    res["dp_greedy"] = (torch.equal(greedy[0], want[0])
                        and torch.equal(greedy[1], want[1]),
                        float(((greedy[2] - want[2]).abs()
                               / want[2].abs()).max()))
    res["dp_ctc_ms"] = mg_time(ctc_step)
    res["dp_greedy_ms"] = mg_time(
        lambda: greedy_decode_data_parallel(x.detach(), i_))
    del lp, x, y
    b, t, u, v = MG_DP_RNNT
    xr, tgt, il, ul = rnnt_problem(np.random.default_rng(SEED + 342), dev,
                                   b, t, u, v)
    n = b // MG_RANKS
    rows = slice(rank * n, (rank + 1) * n)
    mine = xr[rows].clone().requires_grad_()

    def rnnt_step():
        mine.grad = None
        nll = rnnt_loss_data_parallel(mine.detach(), tgt[rows], il[rows],
                                      ul[rows], reduction="none")
        rnnt_loss_data_parallel(mine, tgt[rows], il[rows],
                                ul[rows]).backward()
        return nll

    nll, res["dp_rnnt_launches"] = counted(rnnt_step)
    y = xr.clone().requires_grad_()
    rnnt_loss(y, tgt, il, ul).backward()
    ref = rnnt_nll(xr, tgt, il, ul)
    res["dp_rnnt"] = (torch.equal(nll, ref[rows]),
                      torch.equal(mine.grad, y.grad[rows]),
                      float((nll - ref[rows]).abs().max()),
                      float((mine.grad - y.grad[rows]).abs().max()))
    res["dp_rnnt_ms"] = mg_time(rnnt_step)
    del xr, mine, y
    enc, il, pred, h0, joint = bench_decoder(dev)
    n = enc.shape[0] // MG_RANKS
    enc_r, il_r = enc[rank * n:(rank + 1) * n], il[rank * n:(rank + 1) * n]

    def stream():
        dp = DataParallelStreamingRNNT(StreamingRNNTBeamDecoder(
            pred, h0, joint, beam_width=4, max_symbols=S_CAP))
        st = dp.init(enc.shape[0], enc.shape[2])
        st = stream_rnnt(dp, st, enc_r, il_r, STREAM_CHUNK)
        return dp.finish(st, return_timestamps=True)

    calls = {
        "dp_rnnt_greedy": lambda: rnnt_greedy_decode_data_parallel(
            enc_r, il_r, pred, h0, joint, max_symbols=S_CAP,
            return_timestamps=True),
        "dp_rnnt_beam4": lambda: rnnt_beam_decode_data_parallel(
            enc_r, il_r, pred, h0, joint, beam_width=4, max_symbols=S_CAP,
            return_timestamps=True),
        "dp_rnnt_stream": stream}
    for key, fn in calls.items():
        out, res[f"{key}_launches"] = counted(fn)
        res[key] = [o.cpu() for o in out]
        res[f"{key}_ms"] = mg_time(fn, reps=3 if key == "dp_rnnt_greedy"
                                   else 1)
    return res


def mg_vp(rank, dev):
    """The vocabulary-parallel paths (every rank the global values, its
    8192 or 256 columns), each against the unsharded call."""
    res = {}
    v = MG_VP_CTC[3]
    lp, tgt, il, tl = mg_ctc_problem(SEED + 343, MG_VP_CTC, dev)
    lp.requires_grad_()
    vl = v // MG_RANKS
    own = slice(rank * vl, (rank + 1) * vl)

    def vp_step():
        lp.grad = None
        nll = ctc_nll_vocab_parallel(lp, tgt, il, tl)
        nll.sum().backward()
        return nll.detach()

    nll, res["vp_ctc_launches"] = counted(vp_step)
    outside = (not lp.grad[:, :, :own.start].any()
               and not lp.grad[:, :, own.stop:].any())
    g_vp = lp.grad[:, :, own].clone()  # the rest freed before the reference
    lp.grad = None
    ref = ctc_nll(lp, tgt, il, tl)
    ref.sum().backward()
    g_ref = lp.grad[:, :, own]
    res["vp_ctc"] = (torch.equal(nll, ref.detach()), torch.equal(g_vp, g_ref),
                     outside, float((nll - ref.detach()).abs().max()),
                     float((g_vp - g_ref).abs().max()))
    del g_vp, g_ref
    lp.grad = None
    res["vp_ctc_ms"] = mg_time(vp_step)
    del lp
    torch.cuda.empty_cache()
    b, t, v, W, K = MG_VP_BEAM
    rng = np.random.default_rng(SEED + 344)
    lp = torch.from_numpy(peaked_lattice(rng, t, b, v)).to(dev)
    il = torch.from_numpy(rng.integers(t // 2, t + 1, b).astype(np.int32)
                          ).to(dev)
    prep, res["vp_prep_launches"] = counted(
        lambda: beam_topk_prep_vocab_parallel(lp, None, K))
    g_k = topk_cuda.topk(lp, K)
    res["vp_prep"] = (topk_breakdown.same_bits(prep[:2], g_k)
                      and torch.equal(prep[2], lp[:, :, 0]))
    out, res["vp_beam_launches"] = counted(
        lambda: beam_search_decode_vocab_parallel(lp, il, beam_width=W,
                                                  prune_k=K))
    want = beam_search_from_topk(g_k[0], g_k[1], lp[:, :, 0].contiguous(),
                                 il, W, 0, min(t, 512))
    res["vp_beam"] = all(a.dtype == c.dtype and torch.equal(a, c)
                         for a, c in zip(out, want))
    greedy, res["vp_greedy_launches"] = counted(
        lambda: greedy_decode_vocab_parallel(lp, il))
    res["vp_greedy"] = all(torch.equal(a, c) for a, c in
                           zip(greedy, greedy_decode(lp, il)))
    res["vp_beam_ms"] = mg_time(lambda: beam_search_decode_vocab_parallel(
        lp, il, beam_width=W, prune_k=K))
    res["vp_greedy_ms"] = mg_time(
        lambda: greedy_decode_vocab_parallel(lp, il))
    return res


def mg_tp_problem(dev):
    return mg_ctc_problem(SEED + 345, MG_TP_CTC, dev, min_frac=0.75)


def mg_tp(rank, dev):
    """The time-parallel loss (every rank the global lattice, its 2000
    frames): the NLL and the gradient of the rank's frames (the parent
    holds them against the unsharded K1/K2 and a float64 witness)."""
    lp, tgt, il, tl = mg_tp_problem(dev)
    lp.requires_grad_()
    tc = lp.shape[0] // MG_RANKS
    own = slice(rank * tc, (rank + 1) * tc)

    def tp_step():
        lp.grad = None
        nll = ctc_nll_time_parallel(lp, tgt, il, tl)
        nll.sum().backward()
        return nll.detach()

    nll, launches = counted(tp_step)
    outside = not lp.grad[:own.start].any() and not lp.grad[own.stop:].any()
    return {"tp_ctc": (nll.cpu(), lp.grad[own].cpu(), outside),
            "tp_ctc_launches": launches, "tp_ctc_ms": mg_time(tp_step)}


def check_tp(res, dev):
    """The ranks' time-parallel NLL and gradients against the unsharded
    K1/K2 loss and against the float64 plain scan (the witness): the
    largest NLL error relative, the gradient's of the witness's max."""
    lp, tgt, il, tl = mg_tp_problem(dev)
    nll = res[0]["tp_ctc"][0]
    if not all(torch.equal(x["tp_ctc"][0], nll) for x in res):
        raise AssertionError("the ranks' time-parallel NLLs differ")
    grad = torch.cat([x["tp_ctc"][1] for x in res])
    out = {}
    for name, x in (("k1k2", lp), ("f64", lp.double())):
        x = x.detach().requires_grad_()
        ref = ctc_nll(x, tgt, il, tl)
        ref.sum().backward()
        out[name] = (ref.detach().cpu().double(), x.grad.cpu().double())
    wit_nll, wit_g = out["f64"]
    scale = float(wit_g.abs().max())

    def errs(n, g):
        return (float(((n.double() - wit_nll).abs() / wit_nll.abs()).max()),
                float((g.double() - wit_g).abs().max()) / scale)

    got = {"tp_vs_f64": errs(nll, grad),
           "k1k2_vs_f64": errs(*out["k1k2"]),
           "tp_vs_k1k2": (float(((nll.double() - out["k1k2"][0]).abs()
                                 / out["k1k2"][0].abs()).max()),
                          float((grad.double() - out["k1k2"][1]).abs().max())
                          / float(out["k1k2"][1].abs().max()))}
    log(f"phase 34 the time-parallel loss (B={MG_TP_CTC[0]}, "
        f"T={MG_TP_CTC[1]}, S={MG_TP_CTC[2]}, V={MG_TP_CTC[3]}; "
        f"{MG_TP_CTC[1] // MG_RANKS} frames a rank), (NLL relative, "
        f"gradient of the max): against the float64 scan "
        f"{got['tp_vs_f64']}; the unsharded float32 K1/K2 against it "
        f"{got['k1k2_vs_f64']}; the two against each other "
        f"{got['tp_vs_k1k2']}")
    if max(got["tp_vs_f64"]) > TP_CTC_TOL or got["tp_vs_k1k2"][0] > \
            TP_CTC_TOL or not all(x["tp_ctc"][2] for x in res):
        raise AssertionError(f"the time-parallel loss: {got}")
    return got


def mg_rank(rank, tmp):
    """One rank of phase 34 (a spawned process on the one card): every
    path's launches, checks and times to tmp/mg{rank}.pt."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=MG_RANKS, rank=rank,
                            timeout=TP_TIMEOUT)
    try:
        dev = torch.device("cuda", 0)
        res = {"place": group_rank(), **mg_dp(rank, dev)}
        torch.cuda.empty_cache()
        res.update(mg_vp(rank, dev))
        torch.cuda.empty_cache()
        res.update(mg_tp(rank, dev))
        res["jax_free"] = not any(
            m.split(".")[0] in ("jax", "flax", "end2end_tpu")
            for m in sys.modules)
        torch.save(res, f"{tmp}/mg{rank}.pt")
    finally:
        dist.destroy_process_group()


MG_WANT = {  # the kernels each rank's path must launch, exactly
    "dp_ctc_launches": {"ctc_alpha": 2, "ctc_beta": 1, "ctc_grad": 1},
    "dp_rnnt_launches": {"rnnt_alpha": 2, "rnnt_posteriors": 1},
    "vp_ctc_launches": {"ctc_alpha": 1, "ctc_beta": 1, "ctc_grad": 1},
    "vp_prep_launches": {"topk": 2},
    "vp_beam_launches": {"topk": 2, "beam_step": 1, "backtrace": 1},
    "dp_greedy_launches": {}, "vp_greedy_launches": {},
    "tp_ctc_launches": {},  # host loops over plain torch, no kernel
}


def multi_gpu_slice(dev):
    """Phase 34: MG_RANKS gloo ranks on the one card run the data-,
    vocabulary- and time-parallel paths; the decodes' rows against the
    unsharded decodes here; then dryrun_multichip(4).  Returns the ranks'
    results."""
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        mp.spawn(mg_rank, args=(tmp,), nprocs=MG_RANKS, join=True)
        wall = time.perf_counter() - t0
        res = [torch.load(f"{tmp}/mg{r}.pt") for r in range(MG_RANKS)]
    log(f"phase 34 {MG_RANKS} gloo ranks on one card, spawned and joined in "
        f"{wall:.1f} s")
    for r, x in enumerate(res):
        if x["place"] != (r, MG_RANKS) or not x["jax_free"]:
            raise AssertionError(f"rank {r}: place {x['place']}, JAX-free "
                                 f"{x['jax_free']}")
        dp_nll_eq, dp_g_eq, dp_nll_err, dp_g_err = x["dp_ctc"]
        r_nll_eq, r_g_eq, r_nll_err, r_g_err = x["dp_rnnt"]
        vp_nll_eq, vp_g_eq, vp_out, vp_nll_err, vp_g_err = x["vp_ctc"]
        log(f"phase 34 rank {r}: DP CTC (config 2, {MG_DP_CTC[0] // MG_RANKS}"
            f" rows) NLL bit-equal to the unsharded ctc_nll's rows "
            f"{dp_nll_eq} (max diff {dp_nll_err:.3g}), gradient {dp_g_eq} "
            f"({dp_g_err:.3g}); DP RNN-T (bench row) NLL {r_nll_eq} "
            f"({r_nll_err:.3g}), gradient {r_g_eq} ({r_g_err:.3g}); DP greedy"
            f" tokens and lengths equal {x['dp_greedy'][0]}, scores within "
            f"{x['dp_greedy'][1]:.3g} relative; VP CTC (V={MG_VP_CTC[3]}) NLL "
            f"bit-equal {vp_nll_eq} ({vp_nll_err:.3g}), its columns' "
            f"gradient {vp_g_eq} ({vp_g_err:.3g}), zero elsewhere {vp_out}; "
            f"VP prep == topk {x['vp_prep']}, VP beam-16 == "
            f"beam_search_from_topk {x['vp_beam']}, VP greedy equal "
            f"{x['vp_greedy']}; TP gradient zero outside its frames "
            f"{x['tp_ctc'][2]}; launches DP CTC {x['dp_ctc_launches']}, "
            f"DP RNN-T {x['dp_rnnt_launches']}, DP beam-4 "
            f"{x['dp_rnnt_beam4_launches']}, VP CTC {x['vp_ctc_launches']}, "
            f"VP beam {x['vp_beam_launches']}")
        for key, want in MG_WANT.items():
            if x[key] != want:
                raise AssertionError(f"rank {r}: {key} {x[key]}, want {want}")
        if not x["dp_rnnt_beam4_launches"].get("topk"):
            raise AssertionError(f"rank {r}: K3 missed on the DP ALSD beam")
        if not (vp_nll_eq and vp_g_eq and vp_out and x["vp_prep"]
                and x["vp_beam"] and x["vp_greedy"] and x["dp_greedy"][0]
                and x["dp_greedy"][1] <= DP_SCORE_RTOL):
            raise AssertionError(f"rank {r}: a vocabulary-parallel path or "
                                 "the DP greedy differs from unsharded")
        if (not (dp_nll_eq and r_nll_eq)
                or max(dp_g_err, r_g_err) > CTC_GRAD_TOL):
            raise AssertionError(f"rank {r}: a data-parallel loss differs "
                                 "from unsharded")
    res[0]["tp_check"] = check_tp(res, dev)
    enc, il, pred, h0, joint = bench_decoder(dev)
    want = {"dp_rnnt_greedy": rnnt_greedy_decode(
                enc, il, pred, h0, joint, max_symbols=S_CAP,
                return_timestamps=True),
            "dp_rnnt_beam4": rnnt_beam_decode(
                enc, il, pred, h0, joint, beam_width=4, max_symbols=S_CAP,
                return_timestamps=True)}
    want["dp_rnnt_stream"] = want["dp_rnnt_beam4"]
    for key, w in want.items():
        got = [torch.cat(p).to(dev) for p in zip(*(x[key] for x in res))]
        same_decode(got, w, f"phase 34 {key} (B={enc.shape[0]}, the ranks' "
                            "rows) vs the unsharded decode")
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, tmpdir=cuda_build.BUILD_DIR)
    log(f"phase 34 {dry['line']} ({time.perf_counter() - t0:.1f} s, "
        f"ranks on {sorted({r['device'] for r in dry['ranks']})})")
    if not all(r["device"].startswith("cuda") for r in dry["ranks"]):
        raise AssertionError("a dry-run rank ran off the card")
    return res


def new_slice_timings(s_ocr, s_dense, mg):
    """Phase 35: the OCR train step and beam-10 decode (ms, seq/s), K4 and
    the backtrace at W=10 (device ms, bounds), the Dense transducer step,
    and each multi-GPU path's step (the slowest rank, the median of its
    runs) with the share in collectives.  Returns (ms, bounds)."""
    b = OCR_ROW[0]
    lp, ow = s_ocr["lp"], s_ocr["ow"]
    ms = {"ocr_train_step_bench": time_ms(s_ocr["step"]),
          "ocr_beam10_bench": time_ms(lambda: beam_search_decode(
              lp, ow, beam_width=OCR_BEAM, prune_k=OCR_PRUNE))}
    args, (bp, score), ck = s_ocr["args"], s_ocr["kern"][:2], s_ocr["ck"]
    W, K, s_cap = args[4:7]
    ms["beam_w10_bench"] = time_both(
        "beam_w10_bench", lambda: beam_search_cuda.beam_step_cuda(*args))
    ms["beam_w10_plain_bench"] = time_plain(
        lambda: beam_search_cuda.beam_step_plain(*args))
    ms["backtrace_w10_bench"] = time_both(
        "backtrace_w10_bench", lambda: beam_search_cuda.backtrace_cuda(
            bp, ck, score, W, K, s_cap))
    ms["backtrace_w10_plain_bench"] = time_ms(
        lambda: beam_search_cuda.backtrace_plain(bp, ck, score, W, K,
                                                 s_cap))
    bounds = {"beam_w10": beam_bound(args[0], args[3], W, K),
              "backtrace_w10": backtrace_bound(
                  bp, beam_search_cuda.backtrace_cuda(bp, ck, score, W, K,
                                                      s_cap))}
    ms["dense_transducer_step_b8_10s"] = time_ms(s_dense["step"])
    log(f"phase 35 OCR (B={b}, T'={lp.shape[0]}, V={OCR_ROW[4]}): train "
        f"step {ms['ocr_train_step_bench']:.3f} ms "
        f"({b * 1e3 / ms['ocr_train_step_bench']:.1f} seq/s), beam-10 / "
        f"prune 16 decode {ms['ocr_beam10_bench']:.3f} ms "
        f"({b * 1e3 / ms['ocr_beam10_bench']:.1f} seq/s)")
    for k in ("beam_w10", "backtrace_w10"):
        log(f"phase 35 {k} (OCR row): {DEVICE_MS[k + '_bench'][0]:.4f} ms "
            f"device ({DEVICE_MS[k + '_bench'][1]}), one call "
            f"{ms[k + '_bench']:.4f}, plain twin "
            f"{ms[k + '_plain_bench']:.3f}; bound {bounds[k][0]:.4f} ms "
            f"({bounds[k][1]})")
    log(f"phase 35 Dense-front-end transducer train step (B=8 x 10 s, "
        f"T'=1000): {ms['dense_transducer_step_b8_10s']:.3f} ms")
    for key in [k for k in mg[0] if k.endswith("_ms")]:
        wall = max(x[key][0] for x in mg)
        share = max(x[key][1] for x in mg)
        ms[f"mg_{key[:-3]}"] = wall
        log(f"phase 35 {key[:-3]} ({MG_RANKS} ranks sharing the card, the "
            f"slowest rank): {wall:.3f} ms, collectives up to "
            f"{100 * share:.1f}% of a rank's run")
    return ms, bounds


# --------------------------------------------------------------------------
# 36: the last slice's utilities on the card: a trace of the serving and
# training paths, the build log, a checkpoint round trip, the C++ host
# runtime, the float64 oracles, the examples and a throughput meter
# --------------------------------------------------------------------------

# the kernels a traced beam-8 decode and CTC loss + backward must show with
# device time: label -> a piece of the kernel's symbol
TRACE_KERNELS = {"K1": "ctc_alpha_kernel", "K2": "ctc_beta_kernel",
                 "combine": "ctc_grad_kernel", "K3": "topk_",
                 "K4": "beam_step_kernel", "backtrace": "backtrace_kernel"}
# K4 and K5 against the C++ host decoder on the serving lattice: the best
# hypotheses equal, their scores within tests/test_torch_beam_native.py's
# tolerances (absolute and relative; float32 sums of 750 frames in other
# orders, and with the LM's terms)
NATIVE_TOL = {"K4": 1e-4, "K5": 1e-3}
# the float32 kernels against the float64 oracles, (rtol, atol): the CTC
# loss and gradient to tests/test_ctc_loss_xla.py's float32 bar (the JAX
# scan against torch's loss, whose float64 twin tests/test_reference_impl.py
# holds the oracle to), the RNN-T NLL and logits gradient to
# tests/test_rnnt.py's, the beam sets' scores to tests/test_beam_pallas.py's
ORACLE_TOL = {"ctc loss": (1e-5, 1e-4), "ctc grad": (1e-3, 3e-4),
              "rnnt nll": (4e-6, 1e-4), "rnnt grad": (0.0, 1e-4),
              "beam scores": (2e-4, 5e-4)}
# the JAX package's examples' step counts in tests/test_examples.py
EXAMPLE_STEPS = {"alignment_demo": None, "asr_demo": 25, "ocr_demo": 25,
                 "lm_decode_demo": 25, "serving_demo": None}


class BuildLog(logging.Handler):
    """The lines `log_compiles` logs, kept to be printed and checked."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def check_close(got, want, tol, what):
    """max |got - want| with every element within atol + rtol |want|
    (infinities equal), else raise; returns the largest error."""
    rtol, atol = tol
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    inf = ~np.isfinite(want)
    if not np.array_equal(got[inf], want[inf]):
        raise AssertionError(f"phase 36 {what}: the infinities differ")
    err = np.abs(got[~inf] - want[~inf])
    if np.any(err > atol + rtol * np.abs(want[~inf])):
        raise AssertionError(f"phase 36 {what}: error {err.max():.3g} "
                             f"beyond rtol {rtol}, atol {atol}")
    return float(err.max()) if err.size else 0.0


def traced_serving(pipe, batch, logdir):
    """One beam-8 / prune-16 decode and one CTC loss with its backward
    through the serving pipeline under `profiling.trace`: the written
    Chrome trace must show each of TRACE_KERNELS with device time; logs
    the five longest device operations and the device's idle share of the
    traced window."""
    wav, ns, tgt, tl = batch
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        pipe.decode(wav, ns, beam_width=8, prune_k=16)
        pipe.loss(wav, ns, tgt, tl).backward()
    seconds = time.perf_counter() - t0
    files = sorted(Path(logdir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"phase 36 trace: {len(files)} trace files")
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = sorted((e for e in spans if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")), key=lambda e: e["ts"])
    per_op = {}
    for e in device:
        row = per_op.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    found = {}
    for label, piece in TRACE_KERNELS.items():
        found[label] = sum(us for name, (us, _) in per_op.items()
                           if piece in name)
        if found[label] <= 0:
            raise AssertionError(f"phase 36 trace: {label} ({piece}) has no "
                                 f"device time in {files[0].name}")
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    busy, end = 0.0, lo
    for e in device:  # the union of the device's intervals
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
        end = max(end, b)
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"phase 36 trace: a beam-8 decode and a loss + backward (phase "
        f"6's batch 0, phase 9's targets) under trace() in "
        f"{seconds:.2f} s, {files[0].name} ({files[0].stat().st_size:,} B, "
        f"{len(events):,} events, {sum(r[1] for r in per_op.values()):,} "
        f"device operations); the traced kernels' device ms: "
        + ", ".join(f"{k} {v / 1e3:.4f}" for k, v in found.items()))
    for name, (us, n) in top:
        log(f"phase 36 trace top device op: {us / 1e3:.4f} ms in {n} "
            f"({name[:90]})")
    idle = 1 - busy / (hi - lo)
    log(f"phase 36 trace: the device busy {busy / 1e3:.3f} ms of the "
        f"{(hi - lo) / 1e3:.3f} ms traced window, idle {idle:.3f}")
    return {"kernel_ms": {k: v / 1e3 for k, v in found.items()},
            "idle": idle, "window_ms": (hi - lo) / 1e3}


def checkpoint_round_trip(cfg, dev, tbatches, batch, tmp):
    """A full-width pipeline trained 3 AdamW steps, saved with its
    optimizer and restored into a freshly built pipeline and optimizer on
    the card: the greedy and beam-8 decodes bit-equal, then one more step
    bit-equal.  cuDNN's deterministic algorithms are asked for, as bit
    equality of two training steps needs."""
    def build(seed):
        return ConformerCTCPipeline(
            cfg, device=dev, generator=torch.Generator().manual_seed(seed))

    def step(pipe, opt, b):
        opt.zero_grad()
        pipe.loss(*b).backward()
        opt.step()

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = build(SEED + 36)
        opt_a = torch.optim.AdamW(a.parameters(), lr=1e-3, weight_decay=1e-4)
        for b in tbatches:
            step(a, opt_a, b)
        path = str(Path(tmp) / "pipeline.ckpt")
        t0 = time.perf_counter()
        save_checkpoint(path, {"model": a.state_dict(),
                               "opt": opt_a.state_dict()})
        save_s = time.perf_counter() - t0
        fresh = build(SEED + 37)
        opt_f = torch.optim.AdamW(fresh.parameters(), lr=1e-3,
                                  weight_decay=1e-4)
        for p in fresh.parameters():  # AdamW's state exists after a step
            p.grad = torch.zeros_like(p)
        opt_f.step()
        like = {"model": fresh.state_dict(), "opt": opt_f.state_dict()}
        t0 = time.perf_counter()
        state = restore_checkpoint(path, like)
        restore_s = time.perf_counter() - t0
        if any(v.device != dev for v in state["model"].values()):
            raise AssertionError("phase 36 checkpoint: a weight restored "
                                 "off the card")
        fresh.load_state_dict(state["model"])
        opt_f.load_state_dict(state["opt"])
        wav, ns = batch
        for kw in (dict(beam_width=0), dict(beam_width=8, prune_k=16)):
            got, want = fresh.decode(wav, ns, **kw), a.decode(wav, ns, **kw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"phase 36 checkpoint: the decode "
                                     f"{kw} differs after the restore")
        step(a, opt_a, tbatches[0])
        step(fresh, opt_f, tbatches[0])
        differ = sum(not torch.equal(p, q) for p, q in
                     zip(a.parameters(), fresh.parameters()))
        if differ:
            raise AssertionError(f"phase 36 checkpoint: {differ} parameters "
                                 "differ after one more AdamW step")
    finally:
        torch.backends.cudnn.deterministic = was
    n_params = sum(p.numel() for p in a.parameters())
    log(f"phase 36 checkpoint: 3 AdamW steps at full width ({n_params:,} "
        f"parameters), save_checkpoint {save_s:.3f} s "
        f"({Path(path).stat().st_size:,} B with AdamW's state), "
        f"restore_checkpoint into a fresh pipeline and AdamW {restore_s:.3f} "
        f"s; greedy and beam-8 decodes bit-equal, one more step bit-equal")
    return {"save_s": save_s, "restore_s": restore_s}


def best_agree_native(kern, nat):
    """Which sequences' best hypotheses (beam 0) of a device decode and of
    `native.beam_search_cpu` are equal, and the best scores of both."""
    kt, kl, ks = (x[:, 0].cpu().numpy() for x in kern)
    nt, nl, ns_ = (x[:, 0] for x in nat)
    same = np.array([kl[n] == nl[n] and np.array_equal(kt[n, :kl[n]],
                                                       nt[n, :nl[n]])
                     for n in range(len(kl))])
    return same, ks, ns_, int(kl.sum())


def tie_at_divergence(device_decode, host_decode, lp1, t_len, eos):
    """Where a device decode and the host decoder of one sequence `lp1`
    (T, 1, V) with the bigram LM part: the first frame count t after which
    their beams (the sets and the scores, to 1e-5 relative) differ, by a
    binary search over decodes of the first t frames.  There the sets must
    differ, and the beams one side keeps and the other drops must tie on
    their search scores (the final score less alpha * eos[last], the LM's
    end term) to 1e-5 relative: two decoders that break an exact tie at
    the beam's edge differently carry other beams, and other masses, from
    there on.  Returns (t, the tied scores' spread)."""
    def sets(t):
        i = torch.tensor([t], dtype=torch.int32)
        dev = beam_sets(*device_decode(lp1, i.to(lp1.device)))[0]
        host = beam_sets(*(torch.from_numpy(x) for x in host_decode(
            lp1.cpu(), i)))[0]
        return dev, host

    def differ(dev, host):
        return set(dev) != set(host) or any(
            abs(dev[p] - host[p]) > 1e-5 * max(1.0, abs(host[p]))
            for p in host)

    lo, hi = 1, t_len
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if differ(*sets(mid)) else (mid + 1, hi)
    dev, host = sets(lo)
    if not differ(dev, host) or lo > 1 and differ(*sets(lo - 1)):
        raise AssertionError(f"phase 36: no first divergence found ({lo})")
    if set(dev) == set(host):
        raise AssertionError(f"phase 36: after frame {lo} the same beams "
                             "carry other scores")

    def search(prefix, score):
        return score - (LM_ALPHA * float(eos[prefix[-1]]) if prefix else 0.0)

    edge = ([search(p, dev[p]) for p in set(dev) - set(host)]
            + [search(p, host[p]) for p in set(host) - set(dev)])
    spread = max(edge) - min(edge)
    if spread > 1e-5 * max(1.0, abs(max(edge))):
        raise AssertionError(f"phase 36: the beams part after frame {lo} "
                             f"without a tie (search scores {edge})")
    return lo, spread


def native_slice(lp, il, dev, kn_arpa, tmp):
    """The C++ host runtime on the card's machine: K4 (no LM) and K5 (the
    dense bigram) against `native.beam_search_cpu` on the serving lattice
    copied to the host; `load_arpa` and `parse_arpa_order` with the native
    parser against the Python one on phase 29's Kneser-Ney trigram.

    K4 and K5 read a beam's repeated last symbol from the frame's K + 8
    best (the JAX kernel's window; tests/test_prune_divergence.py bounds
    what it costs), the host decoder from the whole row.  At prune 16
    (a window of 24 of 32 symbols) the bigram pulls beams onto symbols
    outside the window, so K5 is held to the host decoder at prune 24
    (the window holds all 32), and at prune 16 the card's per-frame scan
    (`implementation='xla'`, the whole row, no kernel), with K5's
    agreement at prune 16 logged.  K4 must give the host decoder's best
    hypothesis for every sequence; with the LM, every sequence whose best
    differs must have parted from the host decoder at an exact tie at the
    beam's edge (`tie_at_divergence`): the two break ties by other rules
    (the device by candidate order, the host by its hash map's)."""
    if not native.available():
        raise AssertionError("phase 36: the C++ host runtime did not build")
    lm = seeded_bigram(np.random.default_rng(SEED + 361), lp.shape[2], dev)
    lm_kw = dict(lm=lm, lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
    host_kw = dict(lm_table=lm._table.cpu(), lm_eos=lm._eos.cpu(),
                   lm_alpha=LM_ALPHA, lm_beta=LM_BETA)
    errs = {}
    for name, k, kw, nkw, counter in (
            ("K4", 16, {}, {}, "launches"),
            ("K5", 24, lm_kw, host_kw, "launches_lm"),
            ("the scan + bigram", 16, dict(lm_kw, implementation="xla"),
             host_kw, None),
            ("K5 at prune 16", 16, lm_kw, host_kw, "launches_lm")):
        before = beam_counts()
        kern = beam_search_decode(lp, il, beam_width=8, prune_k=k, **kw)
        torch.cuda.synchronize()
        launched = {c: v - before[c] for c, v in beam_counts().items()}
        if counter and launched[counter] != 1 or not counter and any(
                launched.values()):
            raise AssertionError(f"phase 36 {name}: launches {launched}")
        t0 = time.perf_counter()
        nat = native.beam_search_cpu(lp.cpu(), il.cpu(), beam_width=8,
                                     prune_k=k, **nkw)
        host_s = time.perf_counter() - t0
        same, ks, ns_, n_tok = best_agree_native(kern, nat)
        what = (f"phase 36 {name} (T'={lp.shape[0]}, B={lp.shape[1]}, "
                f"V={lp.shape[2]}, W=8, prune {k}) vs beam_search_cpu")
        if name == "K5 at prune 16":
            log(f"{what}: best hypotheses equal in {int(same.sum())} of "
                f"{len(same)} sequences, best scores "
                + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in zip(ks, ns_))
                + " (kernel/host): the repeat window")
            errs["K5 prune 16 agree"] = int(same.sum())
            continue
        tol = NATIVE_TOL["K4" if name == "K4" else "K5"]
        for n in np.flatnonzero(~same):
            if name == "K4":
                raise AssertionError(f"{what}: best hypotheses differ in "
                                     f"sequence {n}")
            t_tie, spread = tie_at_divergence(
                lambda x, i, k=k, kw=kw: beam_search_decode(
                    x, i, beam_width=8, prune_k=k, **kw),
                lambda x, i, k=k: native.beam_search_cpu(
                    x, i, beam_width=8, prune_k=k, **host_kw),
                lp[:, n:n + 1], int(il[n]), lm._eos.cpu().numpy())
            log(f"{what}: sequence {n}'s best hypotheses differ (best "
                f"scores {ks[n]:.4f} device, {ns_[n]:.4f} host); the beams "
                f"first part after frame {t_tie} of {int(il[n])}, where the "
                f"beams each keeps and the other drops tie at the beam's "
                f"edge (search scores within {spread:.3g})")
        errs[name] = check_close(ks[same], ns_[same], (tol, tol),
                                 f"{name} vs native")
        log(f"{what}: best hypotheses equal in {int(same.sum())} of "
            f"{len(same)} sequences ({n_tok} tokens), their scores max err "
            f"{errs[name]:.3g} (tol {tol}); the host decoder "
            f"{1e3 * host_s:.1f} ms")
    path = str(Path(tmp) / "kn_trigram.arpa")
    Path(path).write_text(render_arpa(*kn_arpa))
    vocab = kn_arpa[2]
    secs = {}
    for nat_ in (True, False):
        t0 = time.perf_counter()
        tables = load_arpa(path, vocab, prefer_native=nat_)
        order = parse_arpa_order(path, vocab, prefer_native=nat_)
        secs[nat_] = (tables, order, time.perf_counter() - t0)
    arpa_err = max(check_close(a, b, (1e-5, 1e-5), "load_arpa native")
                   for a, b in zip(secs[True][0], secs[False][0]))
    (o_n, ng_n), (o_p, ng_p) = secs[True][1], secs[False][1]
    if o_n != o_p or any(sorted(g for g, _, _ in ng_n[k])
                         != sorted(g for g, _, _ in ng_p[k])
                         for k in range(1, o_p + 1)):
        raise AssertionError("phase 36 parse_arpa_order: the native and "
                             "Python parsers read other n-grams")
    for k in range(1, o_p + 1):
        a, b = sorted(ng_n[k]), sorted(ng_p[k])
        arpa_err = max(arpa_err, check_close(
            [(x[1], x[2]) for x in a], [(x[1], x[2]) for x in b],
            (1e-5, 1e-6), "parse_arpa_order native"))
    n_grams = sum(len(ng_p[k]) for k in range(1, o_p + 1))
    log(f"phase 36 phase 29's Kneser-Ney trigram as ARPA ({n_grams:,} "
        f"n-grams): load_arpa + parse_arpa_order native {secs[True][2]:.3f}"
        f" s, Python {secs[False][2]:.3f} s, equal (max err "
        f"{arpa_err:.3g})")
    return {"errs": errs, "arpa_err": arpa_err}


def oracle_slice(dev):
    """The kernels against the port's float64 NumPy oracles at shapes
    their Python loops reach: K1/K2 and the combine through `ctc_nll`
    against `ctc_loss_ref`, K8/K9 through `rnnt_nll` against
    `rnnt_logits_grad_ref`, K4 at prune = V against
    `beam_search_decode_ref`."""
    rng = np.random.default_rng(SEED + 36)
    errs = {}
    lp_np, tgt, il, tl = ctc_problem(rng, 4, 200, 40, 32)  # 1 infeasible
    lp = torch.from_numpy(lp_np).to(dev).requires_grad_()
    nll = ctc_nll(lp, *(torch.from_numpy(a).to(dev) for a in (tgt, il, tl)))
    nll.sum().backward()
    t0 = time.perf_counter()
    ref_loss, ref_grad = ctc_loss_ref(lp_np.astype(np.float64), tgt, il, tl)
    ctc_s = time.perf_counter() - t0
    errs["ctc loss"] = check_close(nll.detach().cpu(), ref_loss,
                                   ORACLE_TOL["ctc loss"], "ctc loss")
    errs["ctc grad"] = check_close(lp.grad.cpu(), ref_grad,
                                   ORACLE_TOL["ctc grad"], "ctc grad")
    x, y, xil, xul = rnnt_problem(rng, dev, 2, 64, 16, 32, variable=True)
    nll_r, g_r = rnnt_nll_and_grad(x, y, xil, xul, 0, "auto")
    t0 = time.perf_counter()
    ref_r, ref_g = rnnt_logits_grad_ref(
        x.double().cpu().numpy(), *(a.cpu().numpy() for a in (y, xil, xul)))
    rnnt_s = time.perf_counter() - t0
    errs["rnnt nll"] = check_close(nll_r.cpu(), ref_r,
                                   ORACLE_TOL["rnnt nll"], "rnnt nll")
    errs["rnnt grad"] = check_close(g_r.cpu(), ref_g,
                                    ORACLE_TOL["rnnt grad"], "rnnt grad")
    t, b, v, w = 50, 4, 8, 4
    x_b = rng.standard_normal((t, b, v)) * 1.5
    lp_b = (x_b - np.log(np.exp(x_b).sum(-1, keepdims=True))).astype(
        np.float32)
    il_b = rng.integers(t // 2, t + 1, b).astype(np.int32)
    il_b[0] = t
    before = beam_counts()["launches"]
    got = beam_sets(*beam_search_decode(
        torch.from_numpy(lp_b).to(dev), torch.from_numpy(il_b).to(dev),
        beam_width=w, prune_k=v))
    if beam_counts()["launches"] != before + 1:
        raise AssertionError("phase 36: K4 did not run at prune = V")
    t0 = time.perf_counter()
    want = beam_search_decode_ref(lp_b.astype(np.float64), il_b,
                                  beam_width=w)
    beam_s = time.perf_counter() - t0
    errs["beam scores"] = 0.0
    for n, (g, ref) in enumerate(zip(got, want)):
        ref = dict(ref)
        if set(g) != set(ref):
            raise AssertionError(f"phase 36 K4 vs beam_search_decode_ref: "
                                 f"beam sets differ, seq {n}")
        errs["beam scores"] = max(errs["beam scores"], check_close(
            [g[p] for p in ref], list(ref.values()),
            ORACLE_TOL["beam scores"], "K4 vs the oracle"))
    log(f"phase 36 oracles: K1/K2 + combine (B=4, T=200, S=40, V=32, one "
        f"infeasible) vs ctc_loss_ref ({ctc_s:.2f} s): loss err "
        f"{errs['ctc loss']:.3g} (rtol, atol {ORACLE_TOL['ctc loss']}), "
        f"gradient {errs['ctc grad']:.3g} ({ORACLE_TOL['ctc grad']}); "
        f"K8/K9 (B=2, T=64, U=16, V=32, an empty target) vs "
        f"rnnt_logits_grad_ref ({rnnt_s:.2f} s): NLL {errs['rnnt nll']:.3g} "
        f"({ORACLE_TOL['rnnt nll']}), gradient {errs['rnnt grad']:.3g} "
        f"({ORACLE_TOL['rnnt grad']}); K4 at prune = V (B=4, T=50, V=8, "
        f"W=4) vs beam_search_decode_ref ({beam_s:.2f} s): beam sets equal, "
        f"scores {errs['beam scores']:.3g} ({ORACLE_TOL['beam scores']})")
    return errs


def run_example(name):
    """One example as a subprocess on the card: (rc, its output, s)."""
    env = dict(os.environ)
    env.pop("E2E_DEMO_DEVICE", None)
    if EXAMPLE_STEPS[name]:
        env["E2E_DEMO_STEPS"] = str(EXAMPLE_STEPS[name])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"end2end_tpu_torch.examples.{name}"],
        cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    return proc.returncode, proc.stdout + proc.stderr, seconds


def examples_slice():
    """The five examples, each a process on the card, all started
    together: each must exit 0."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(EXAMPLE_STEPS)) as pool:
        runs = dict(zip(EXAMPLE_STEPS, pool.map(run_example, EXAMPLE_STEPS)))
    wall = time.perf_counter() - t0
    for name, (rc, out, secs) in runs.items():
        last = out.strip().splitlines()[-1] if out.strip() else ""
        log(f"phase 36 example {name} (steps "
            f"{EXAMPLE_STEPS[name] or 'its own'}): exit {rc} in {secs:.1f} s;"
            f" last line: {last[:100]}")
        if rc != 0:
            log(out[-3000:])
            raise AssertionError(f"phase 36 example {name} failed: {rc}")
    log(f"phase 36 the five examples, run together: {wall:.1f} s")
    return {name: run[2] for name, run in runs.items()}


def utilities_slice(pipe, cfg, dev, batches, tbatches, lp, il, kn_arpa,
                    build_log):
    """Phase 36; returns its launches and results."""
    t_phase = time.perf_counter()
    out = {"build_log": list(build_log.lines)}
    for line in out["build_log"]:
        log(f"phase 36 log_compiles (phase 3's builds): {line}")
    for lib in ("libe2e_kernels_", "libe2e_native_"):
        if not any(lib in line for line in out["build_log"]):
            raise AssertionError(f"phase 36: log_compiles logged no {lib}")
    wav, ns = batches[0]
    torch.cuda.synchronize()
    zero_all_counts()
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        out["trace"] = traced_serving(pipe, (wav, ns, *tbatches[0][2:]),
                                      str(Path(tmp) / "trace"))
        log(f"phase 36 step trace: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["ckpt"] = checkpoint_round_trip(cfg, dev, tbatches, (wav, ns),
                                            tmp)
        log(f"phase 36 step checkpoint: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["native"] = native_slice(lp, il, dev, kn_arpa, tmp)
        log(f"phase 36 step native: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["oracle"] = oracle_slice(dev)
    log(f"phase 36 step oracles: {time.perf_counter() - t0:.1f} s")
    meter = profiling.Throughput(units_per_iter=wav.shape[0])
    for _ in range(20):
        pipe.decode(wav, ns, beam_width=8, prune_k=16)
    torch.cuda.synchronize()
    out["throughput"] = meter.stop(20)
    log(f"phase 36 Throughput: 20 beam-8 decodes of B=8 x 30 s in "
        f"{out['throughput']['seconds']:.3f} s, "
        f"{out['throughput']['units_per_s']:.1f} seq/s")
    torch.cuda.synchronize()
    out["launches"] = {k: n for k, n in all_counts().items() if n}
    log(f"phase 36 launches (the examples' own, in their processes, not "
        f"counted): {out['launches']}")
    t0 = time.perf_counter()
    out["examples"] = examples_slice()
    log(f"phase 36 step examples: {time.perf_counter() - t0:.1f} s; the "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return out


def gru_bound(n, u, h):
    """One direction of the recurrence at the card's peaks: its
    3 N U H^2 float32 FMAs on CUDA cores (the forward's z, r and candidate
    products; the backward's three transposed ones), or its bytes, 7 N U H
    floats each way plus a state or cotangent row a step and the three
    (H, H) weights once: the forward reads gx (3H a row and step) and
    writes the tape (4H: z, r, c, q) and the states; the backward reads
    z, r, c, the states and their cotangent and writes dgx (3H).  Not in
    it: the 2U grid barriers of the step chain, which phase 37 times
    apart, on two rows."""
    nbytes = 4 * (7 * n * u * h + n * (u + 1) * h + 3 * h * h)
    return bound(nbytes, 2 * 3 * n * u * h * h)


def gru_seq_slice(dev):
    """Phase 37: the predictor's GRU kernels against their plain twins
    and the step loop on the card, then timed against their bound, their
    step chain at N = 2 and the loop they replace."""
    t0 = time.perf_counter()
    errs = {"gru_forward": 0.0, "gru_backward": 0.0}
    for n, u, e, h, v in CARD_SHAPES:
        err, ran = card_errors(n, u, e, h, v, dev)
        log(f"phase 37 GRU (N={n}, U={u}, E={e}, H={h}, V={v}): launches "
            f"{ran}, errors (of each tensor's max) "
            + ", ".join(f"{k} {x:.3g}" for k, x in err.items()))
        bad = {k: x for k, x in err.items() if not x < CARD_TOL[k]}
        if bad or ran != {"gru_forward": 1, "gru_backward": 1}:
            raise AssertionError(f"phase 37 GRU kernels: launches {ran}, "
                                 f"errors over CARD_TOL {bad}")
        errs["gru_forward"] = max(errs["gru_forward"], err["states"],
                                  err["tape"])
        errs["gru_backward"] = max(errs["gru_backward"], err["dgx"],
                                   err["dh0"])
    ms, bounds = {}, {}
    for n, u, e, h, v in CARD_SHAPES[:3]:
        tag = f"n{n}_u{u}"
        params, h0, toks, cot = gru_case(n * 1000 + u, v, e, h, n, u,
                                         device=dev)
        with torch.no_grad():
            p = {k: x.detach() for k, x in params.items()}
            h0 = h0.detach()
            wx = torch.cat([p[k][:e] for k in ("wz", "wr", "wh")], 1)
            gx = (p["emb"][toks] @ wx
                  + torch.cat([p["bz"], p["br"], p["bh"]])).contiguous()
            hidden = [p[k][e:] for k in ("wz", "wr", "wh")]
            states, tape = gru_cuda.gru_forward(gx, *hidden, h0)
            # the step chain: the same grid and U steps on two rows
            gx2 = gx[:2].contiguous()
            states2, tape2 = gru_cuda.gru_forward(gx2, *hidden, h0)
        fwd = partial(gru_cuda.gru_forward, gx, *hidden, h0)
        bwd = partial(gru_cuda.gru_backward, cot, states, tape, *hidden)
        step = partial(neural_lm.gru_prefix_states, params, h0, toks)
        loop = partial(rnnt_decode._prefix_states,
                       partial(gru_step, params), h0, toks)
        for key, fn, reps in (
                (f"gru_forward_{tag}_bench", fwd, 20),
                (f"gru_backward_{tag}_bench", bwd, 20),
                (f"gru_forward_{tag}_chain",
                 partial(gru_cuda.gru_forward, gx2, *hidden, h0), 20),
                (f"gru_backward_{tag}_chain",
                 partial(gru_cuda.gru_backward, cot[:2].contiguous(),
                         states2, tape2, *hidden), 20),
                (f"gru_forward_{tag}_plain_bench",
                 partial(neural_lm.gru_seq_forward_plain, gx, *hidden, h0),
                 3),
                (f"gru_backward_{tag}_plain_bench",
                 partial(neural_lm.gru_seq_backward_plain, cot, states,
                         tape, *hidden), 3),
                (f"gru_step_{tag}",
                 lambda: (step() * cot).sum().backward(), 10),
                (f"gru_loop_{tag}",
                 lambda: (loop() * cot).sum().backward(), 3)):
            ms[key] = time_ms(fn, reps=reps)
        for d in ("forward", "backward"):  # one launch: events time it
            DEVICE_MS[f"gru_{d}_{tag}_bench"] = (
                ms[f"gru_{d}_{tag}_bench"], "events")
        bounds[tag] = gru_bound(n, u, h)
        plan = gru_cuda._plan(dev, n, h)
        chain = {d: ms[f"gru_{d}_{tag}_chain"] for d in ("forward",
                                                         "backward")}
        log(f"phase 37 GRU time (N={n}, U={u}, H={h}; plan {plan}): "
            f"forward kernel {ms[f'gru_forward_{tag}_bench']:.4f} ms, "
            f"backward {ms[f'gru_backward_{tag}_bench']:.4f} ms; bound "
            f"{bounds[tag][0]:.4f} ms each ({bounds[tag][1]}); the step "
            f"chain (N = 2, the same grid and U) forward "
            f"{chain['forward']:.4f} ms, backward {chain['backward']:.4f} "
            f"ms ({chain['forward'] * 1e3 / (2 * u):.3f} / "
            f"{chain['backward'] * 1e3 / (2 * u):.3f} us a barrier and its "
            f"phase); the predictor's forward + backward (x-side matmul, "
            f"kernels, weight-gradient matmuls) "
            f"{ms[f'gru_step_{tag}']:.3f} ms against the step loop's "
            f"{ms[f'gru_loop_{tag}']:.3f} ms; plain twins forward "
            f"{ms[f'gru_forward_{tag}_plain_bench']:.3f}, backward "
            f"{ms[f'gru_backward_{tag}_plain_bench']:.3f} ms")
    log(f"phase 37 done in {time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "ms": ms, "bounds": bounds}


def top_device_ops(fn, count: int = 12) -> str:
    """fn() once under torch.profiler: its `count` operations of most
    device time, "name ms (calls)", and the total."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(e.device_time_total / 1e3, e.count, e.key)
           for e in prof.key_averages() if e.device_time_total > 0]
    ops.sort(reverse=True)
    return (f"total {sum(o[0] for o in ops):.3f} ms; " + "; ".join(
        f"{k[:60]} {t:.3f} ({n})" for t, n, k in ops[:count]))


def packing_slice(dev):
    """Phase 38: the serving cells' encoder packed against padded at
    testclean-b32-greedy's longest and median batches."""
    from e2e_bench import traffic

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "e2e_bench"
    cfg = json.loads((root / "configs/conformer-ctc-large.json").read_text())
    mix = json.loads((root / "traffic/testclean-b32-greedy.json").read_text())
    enc = ConformerEncoder(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
        conv_kernel=cfg["conv_kernel_size"], n_mels=cfg["n_mels"],
        device=dev, generator=torch.Generator().manual_seed(SEED)).eval()
    batches = sorted(traffic.batches(mix, cfg), key=lambda b: b.pad_samples)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def features(b):
        wave, n = traffic.materialise(b, cfg, gen, dev)[:2]
        return (log_mel_spectrogram(wave, cfg["sample_rate"], cfg["n_fft"],
                                    cfg["hop_length"], cfg["n_mels"]),
                num_frames(n, cfg["n_fft"], cfg["hop_length"]))

    with torch.no_grad():
        for b in batches:
            enc(*features(b))
    if enc.packing["packed"] != len(batches):
        raise AssertionError(f"phase 38: {enc.packing} over {len(batches)} "
                             f"batches")
    log(f"phase 38 every batch of testclean-b32-greedy ({len(batches)}) "
        f"through the encoder: {enc.packing}, rows computed "
        f"{100 * enc.packing['rows'] / enc.packing['padded_rows']:.2f}% of "
        f"the padded rows")
    ms = {}
    for tag, b in (("longest", batches[-1]),
                   ("median", batches[len(batches) // 2])):
        feats, lens = features(b)
        fns = {"padded": partial(enc.forward_padded, feats, lens),
               "packed": partial(enc, feats, lens)}
        with torch.no_grad():
            before = dict(enc.packing)
            got, out_len = fns["packed"]()
            count = {k: v - before[k] for k, v in enc.packing.items()}
            want = fns["padded"]()[0]
            valid = (torch.arange(got.shape[1], device=dev)[None, :]
                     < out_len[:, None])
            err = float((got - want)[valid].abs().max()
                        / want[valid].abs().max())
            if (count["packed"] != 1 or not err < 1e-4
                    or got[~valid].any()):
                raise AssertionError(f"phase 38 {tag}: counter {count}, "
                                     f"error {err:.3g}")
            del got, want
            times = {k: [] for k in fns}
            for k in ("padded", "packed", "packed", "padded"):
                times[k].append(time_ms(fns[k]))
        for k, v in times.items():
            ms[f"encoder_{k}_{tag}"] = statistics.median(v)
        log(f"phase 38 encoder ({tag} batch: N={len(b.rows)}, "
            f"{b.pad_samples / cfg['sample_rate']:.0f} s padded, T'="
            f"{valid.shape[1]}, {b.audio_s(cfg['sample_rate']):.1f} audio s):"
            f" rows computed {count['rows']} of {count['padded_rows']} "
            f"({100 * count['rows'] / count['padded_rows']:.1f}%), valid "
            f"logits within {err:.3g} of their largest; ms in turns "
            f"(padded, packed, packed, padded) padded "
            + ", ".join(f"{x:.3f}" for x in times["padded"]) + ", packed "
            + ", ".join(f"{x:.3f}" for x in times["packed"])
            + f": {ms[f'encoder_padded_{tag}'] / ms[f'encoder_packed_{tag}']:.3f}x")
        log(f"phase 38 encoder ({tag} batch), packed: the top device "
            f"operations of one forward (torch.profiler): "
            + top_device_ops(fns["packed"]))
    log(f"phase 38 packing counter {enc.packing}; done in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ms": ms}


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
    # and, beside it, the kernels that K1, K10 and the beam step replaced
    # (the A/B baselines)
    # with the host runtime's g++ build beside them, inside log_compiles
    # (its lines are read in phase 36)
    build_log = BuildLog()
    logging.getLogger("end2end_tpu_torch").addHandler(build_log)
    t0 = time.perf_counter()
    with (profiling.log_compiles(),
          concurrent.futures.ThreadPoolExecutor(7) as pool):
        host_build = pool.submit(native.available)
        ref_build = pool.submit(ctc_alpha_breakdown.build_reference,
                                cuda_build.BUILD_DIR / "reference")
        k2_build = pool.submit(ctc_beta_breakdown.build_reference,
                               cuda_build.BUILD_DIR / "reference_k2")
        k10_build = pool.submit(joint_fwd_breakdown.build_reference,
                                cuda_build.BUILD_DIR / "reference_k10")
        beam_build = pool.submit(beam_step_breakdown.build_reference,
                                 cuda_build.BUILD_DIR / "reference_beam")
        rnnt_build = pool.submit(rnnt_wavefront_breakdown.build_reference,
                                 cuda_build.BUILD_DIR / "reference_rnnt")
        topk_build = pool.submit(topk_breakdown.build_reference,
                                 cuda_build.BUILD_DIR / "reference_topk")
        _, info = cuda_build.library()
        ref_lib, ref_ptxas = ref_build.result()
        k2_ref_lib, k2_ref_ptxas = k2_build.result()
        k10_ref_lib, k10_ref_ptxas = k10_build.result()
        beam_ref_lib, beam_ref_ptxas = beam_build.result()
        rnnt_ref_lib, rnnt_ref_ptxas = rnnt_build.result()
        topk_ref_lib, topk_ref_ptxas = topk_build.result()
        host_build.result()
    parent = parent_step(beam_ref_lib)
    log(f"phase 3 build: {info['build_s']:.1f} s nvcc, "
        f"{time.perf_counter() - t0:.1f} s to load ({info['path']})")
    for line in build_log.lines:
        log(f"phase 3 log_compiles: {line}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            log(f"  ptxas {line.strip()}")
    for line in ref_ptxas:
        log(f"  ptxas (the two-barrier K1) {line}")
    for line in k2_ref_ptxas:
        log(f"  ptxas (the two-barrier K2) {line}")
    for line in k10_ref_ptxas:
        log(f"  ptxas (the wmma K10) {line}")
    for line in beam_ref_ptxas:
        log(f"  ptxas (the parent beam kernel) {line}")
    for line in rnnt_ref_ptxas:
        log(f"  ptxas (the parent K8/K9) {line}")
    for line in topk_ref_ptxas:
        log(f"  ptxas (the parent K3) {line}")
    rng = np.random.default_rng(SEED)
    # 34 runs here, before the other phases' tensors fill the card: its
    # four ranks hold ~25 GB at the large-vocabulary row
    mg = multi_gpu_slice(dev)

    # 4. top-k kernel vs plain and vs the parent K3 (the LM decode's B=128
    # shape and the beam-16 row's k from an rng of their own, which leaves
    # rng's draws alone)
    topk_err = check_topk(rng, dev, [(1000, 32, 1024, 24), (750, 8, 32, 24)],
                          topk_ref_lib)
    topk_err = max(topk_err, check_topk(
        np.random.default_rng(SEED + 3), dev,
        [(1000, 128, 29, 24), (1000, 32, 1024, 40)], topk_ref_lib))
    # 5. beam kernel vs plain and vs the parent at the beam decoder's
    # reference shape and at the beam-16 row; the scan outside the envelope
    beam_err, beam_inputs = check_beam(rng, dev, 1000, 32, 1024, 8, 16,
                                       parent)
    w16_rng = np.random.default_rng(SEED + 16)  # leaves rng's draws alone
    w16_err, w16_inputs = check_beam(w16_rng, dev, 1000, 32, 1024, 16, 32,
                                     parent)
    beam_err = max(beam_err, w16_err)
    check_scan(w16_rng, dev)

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
    reset_counts()
    results = []
    for wav, ns in batches:
        greedy = pipe.decode(wav, ns, beam_width=0)
        beam = pipe.decode(wav, ns, beam_width=8, prune_k=16)
        results.append((greedy, beam))
    torch.cuda.synchronize()
    launches = {"topk": topk_cuda.launches,
                "beam_step": beam_search_cuda.launches,
                "backtrace": beam_search_cuda.launches_backtrace}
    log(f"phase 6 serving: pipeline built on {pipe.device} by default; 3 "
        f"batches x 8 requests, launches {launches}")
    if launches != {"topk": 3, "beam_step": 3, "backtrace": 3}:
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
        if name == "main":
            topk_b = topk_bound(x, ks)
    # K3 against the parent K3 and torch.topk in turns at the four shapes
    turns_rng = np.random.default_rng(SEED + 7)
    for name, (t, b, v, k) in TOPK_SHAPES.items():
        topk_turns(name, torch.from_numpy(turns_rng.standard_normal(
            (t, b, v)).astype(np.float32)).to(dev), k, topk_ref_lib)
    lpk, ck, lpb, il_ref, s_cap_ref = beam_inputs
    ms["beam_ref"] = time_ms(lambda: beam_search_cuda.beam_step_cuda(
        lpk, ck, lpb, il_ref, 8, 16, s_cap_ref, 0))
    ms["beam_plain_ref"] = time_plain(
        lambda: beam_search_cuda.beam_step_plain(lpk, ck, lpb, il_ref, 8, 16,
                                                 s_cap_ref, 0))
    bp, score, _, _ = beam_search_cuda.beam_step_cuda(lpk, ck, lpb, il_ref,
                                                      8, 16, s_cap_ref, 0)
    bt_err, walk_err = check_backtrace(bp, ck, score, 8, 16, s_cap_ref,
                                       "phase 7 ref")
    ms.update(time_walk("ref", bp, ck, score, 8, 16, s_cap_ref)[0])
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
    bt_err, walk_err = np.maximum((bt_err, walk_err), check_backtrace(
        bp, mck, score, 8, 16, s_cap, "phase 7 main")).tolist()
    bt_ms, bt_b = time_walk("main", bp, mck, score, 8, 16, s_cap)
    ms.update(bt_ms)
    beam_turns(f"phase 7 K4 vs the parent (main: T'={mlpk.shape[0]}, B=8, "
               f"W=8, K=16)", (mlpk, mck, mlpb, il, 8, 16, s_cap, 0), {},
               beam_ref_lib)
    w16_args = (*w16_inputs[:4], 16, 32, w16_inputs[4], 0)
    beam_turns("phase 7 K4 vs the parent (beam-16 row: T=1000, B=32, "
               "V=1024, W=16, K=32)", w16_args, {}, beam_ref_lib)
    ms["beam_plain_w16"] = time_plain(
        lambda: beam_search_cuda.beam_step_plain(*w16_args))
    ms["beam_w16"] = time_ms(
        lambda: beam_search_cuda.beam_step_cuda(*w16_args))
    w16_b = beam_bound(w16_inputs[0], w16_inputs[3], 16, 32)
    bp16, score16, _, _ = beam_search_cuda.beam_step_cuda(*w16_args)
    bt_err, walk_err = np.maximum((bt_err, walk_err), check_backtrace(
        bp16, w16_inputs[1], score16, 16, 32, w16_inputs[4],
        "phase 7 beam-16 row")).tolist()
    ms.update(time_walk("w16", bp16, w16_inputs[1], score16, 16, 32,
                        w16_inputs[4])[0])
    log(f"phase 7 beam-16 row: plain twin {ms['beam_plain_w16']:.3f} ms, "
        f"bound {w16_b[0]:.5f} ms ({w16_b[1]})")
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

    # 8. CTC kernels vs plain at the loss's reference shapes; K2's
    # branch-free log1p against libm's on every float of its range
    bad = ctc_loss_cuda.log1p_mismatches()
    log(f"phase 8 K2's log1p: {bad} of {0x40800000:,} floats in [0, 4) "
        "differ from libm's log1pf")
    if bad:
        raise AssertionError("K2's log1p differs from libm's log1pf")
    ctc_err = [0.0, 0.0]
    ctc_inputs = {}
    for name, (b, t, s, v) in CTC_SHAPES.items():
        lp_np, tgt_np, il_np, tl_np = ctc_problem(rng, b, t, s, v)
        args = (torch.from_numpy(lp_np).to(dev),
                *(torch.from_numpy(a).to(dev) for a in (tgt_np, il_np,
                                                        tl_np)))
        ctc_inputs[name] = args
        errs = check_ctc(*args, f"phase 8 {name} (B={b}, T={t}, S={s}, "
                                f"V={v})", ref_lib, k2_ref_lib)
        ctc_err = [max(a, e) for a, e in zip(ctc_err, errs)]

    # 9. the training slice
    tpipe = ConformerCTCPipeline(
        cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    tbatches = training_batches(rng, cfg)
    errs = check_training_batch(tpipe, tbatches[0], ref_lib, k2_ref_lib)
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
        k2_vs_parent(args, name, k2_ref_lib)
        cells = b * t * (2 * tgt.shape[1] + 1)
        for k in ("ctc_alpha", "ctc_alpha_plain", "ctc_beta",
                  "ctc_beta_ckpt64", "ctc_beta_plain", "ctc_grad",
                  "ctc_grad_plain",
                  "ctc_loss_grad", "ctc_loss_grad_plain",
                  "ctc_library_fwd", "ctc_library_fwd_bwd",
                  "ctc_library_bwd"):
            log(f"phase 10 {k}_{name} (B={b}, T={t}, S={tgt.shape[1]}): "
                f"{ms[f'{k}_{name}']:.3f} ms, "
                f"{cells / ms[f'{k}_{name}'] / 1e3:.1f} M lattice cells/s")
        k2 = (DEVICE_MS[f"ctc_beta_{name}"][0]
              + DEVICE_MS[f"ctc_grad_{name}"][0])
        bwd = DEVICE_MS[f"ctc_library_bwd_{name}"][0]
        log(f"phase 10 device ms ({name}): K2 + combine {k2:.4f}, F.ctc_loss "
            f"backward alone {bwd:.4f} "
            f"({DEVICE_MS[f'ctc_library_bwd_{name}'][1]}; K2 + combine "
            f"{k2 / bwd:.3f}x it), forward + "
            f"backward {DEVICE_MS[f'ctc_library_fwd_bwd_{name}'][0]:.4f}")
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
    k5_err, _ = check_beam_lm(rng, dev, 1000, 32, 29, W, K, parent)

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
                          "launches_resume": 3 * n_chunks,
                          "launches_backtrace": 3,
                          "launches_walk": 3 * n_chunks}:
        raise AssertionError(f"kernels missed on the chunked path: "
                             f"{chunk_launches}")
    chunk_err, chunk_inputs = 0.0, {}
    for name, (lp, lm, guide) in chunked.items():
        chunk_inputs[name] = chunked_inputs(lp, il32, guide, W, K)
        chunk_err = max(chunk_err, check_chunked(
            name, chunk_inputs[name], lm, main_outs[name], W, K, parent))

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
                       "launches_cls": 0, "launches_resume": 0,
                       "launches_backtrace": 3, "launches_walk": 0}:
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
    beam_turns(f"phase 14 K5 vs the parent (main: T'={mlpk.shape[0]}, B=8, "
               f"W=8, K=16, V={inc32.shape[1]})", margs, {"inc": inc32},
               beam_ref_lib)
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
    for key, name in (("K7", "word LM, V=29"),
                      ("K6", "bigram LM + 63-class guide, V=1024")):
        args, kw = first[name]
        beam_turns(f"phase 14 {key} vs the parent (the first {CHUNK_T}-frame "
                   f"chunk of '{name}', B=32)", args,
                   {k: x for k, x in kw.items() if x is not None},
                   beam_ref_lib)
    args, kw = first["word LM, V=29"]
    resume_b = beam_bound(args[0], args[3], W, K, resume=True)
    for name, (args, kw) in first.items():  # a chunk's walk, W = 8
        bp_c = beam_search_cuda.beam_step_cuda(*args, **kw)[0]
        walk_err = max(walk_err, check_walk(
            bp_c, args[1], W, K, f"phase 14 the first chunk of '{name}'"))
        if name == "word LM, V=29":
            ck_c = args[1]
            ms["lane_walk_chunk"] = time_both(
                "lane_walk_chunk",
                lambda: beam_search_cuda.lane_walk_cuda(bp_c, ck_c, W, K))
            ms["lane_walk_plain_chunk"] = time_ms(
                lambda: beam_search_cuda.lane_walk_plain(bp_c, ck_c, W, K))
            walk_b = lane_walk_bound(
                bp_c, beam_search_cuda.lane_walk_cuda(bp_c, ck_c, W, K))
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
    bt_err, walk_err = np.maximum((bt_err, walk_err), check_backtrace(
        bp, ck, score, W, K, 512, "phase 14 b128")).tolist()
    ms.update(time_walk("b128", bp, ck, score, W, K, 512)[0])
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
              "beam_resume_plain_chunk", "lane_walk_chunk",
              "lane_walk_plain_chunk", "beam_cls_chunk",
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
                                        f"U={u}, V={v}, blank={blank})",
                          rnnt_ref_lib)
        rnnt_err = [max(a, e) for a, e in zip(rnnt_err, errs)]

    # 16. the transducer training slice at full width
    tcfg = TransducerConfig()  # vocab 32, d 144, 2 layers, joint 128
    model = ConformerTransducer(tcfg, seed=SEED)
    if model.device != dev:
        raise AssertionError(f"the transducer was built on {model.device}")
    xbatches = transducer_batches(rng, dev, tcfg.vocab_size)
    *errs, main_dp, model_cpu = check_transducer_batch(model, xbatches[0],
                                                       rnnt_ref_lib)
    rnnt_err = [max(a, e) for a, e in zip(rnnt_err, errs)]
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    torch.cuda.synchronize()
    for c in (rnnt_loss_cuda.launches, gru_cuda.launches):
        for k in c:
            c[k] = 0
    losses = []
    for batch in xbatches:
        opt.zero_grad()
        loss = model.loss(*batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    torch.cuda.synchronize()
    rnnt_launches = dict(rnnt_loss_cuda.launches)
    gru_launches = dict(gru_cuda.launches)
    log(f"phase 16 training: 3 AdamW steps x 8 requests, lattice "
        f"{tuple(main_dp[0].shape)} x V={tcfg.vocab_size}, losses "
        f"{[round(x, 6) for x in losses]}, launches {rnnt_launches}, "
        f"the predictor's {gru_launches}")
    if rnnt_launches != {"rnnt_alpha": 3, "rnnt_posteriors": 3} or \
            gru_launches != {"gru_forward": 3, "gru_backward": 3}:
        raise AssertionError(f"kernels missed on the transducer path: "
                             f"{rnnt_launches}, {gru_launches}")
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
        rnnt_vs_parent(dp, name, rnnt_ref_lib)
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
    # 26. the forced alignment: the kernel against align_plain at the
    # serving pipeline's log-probs (phase 6's first batch, random targets
    # of T'/5 labels; the main path's run, counted) and at BASELINE config
    # 2's shape with edge samples; the greedy transcripts' invariant
    arng = np.random.default_rng(SEED + 26)  # leaves rng's draws alone
    a_tl = (serve_il // 5).to(torch.int32)
    a_tgt = torch.from_numpy(arng.integers(
        1, cfg.vocab_size, (8, int(a_tl.max()))).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    alignment.launches = 0
    main_align = ctc_forced_alignment(lp_gpu, a_tgt, serve_il, a_tl)
    torch.cuda.synchronize()
    align_launches = alignment.launches
    log(f"phase 26 the pipeline's alignment (T'={lp_gpu.shape[0]}, B=8, "
        f"S={a_tgt.shape[1]}): launches {align_launches}, scores "
        f"{[round(x, 3) for x in main_align.scores.tolist()]}")
    if align_launches != 1:
        raise AssertionError(f"alignment kernel launches {align_launches}")
    got, align_err = check_align(lp_gpu, a_tgt, serve_il, a_tl, 0,
                                 "phase 26 the pipeline's log-probs")
    if not all(torch.equal(a, b) for a, b in zip(got, main_align)):
        raise AssertionError("alignment kernel differs run to run")
    b2, t2, s2, v2 = CTC_SHAPES["librispeech-char"]
    lp2 = torch.from_numpy(peaked_lattice(arng, t2, b2, v2)).to(dev)
    il2 = arng.integers(t2 // 2, t2 + 1, b2).astype(np.int32)
    tl2 = arng.integers(s2 // 2, s2 + 1, b2).astype(np.int32)
    il2[1], tl2[1] = s2 - 1, s2  # infeasible: S labels in S - 1 frames
    tl2[2] = 0  # an empty target
    il2[3] = 0  # an input length of 0
    tgt2 = torch.from_numpy(arng.integers(1, v2, (b2, s2)).astype(
        np.int32)).to(dev)
    il2, tl2 = (torch.from_numpy(a).to(dev) for a in (il2, tl2))
    got2, _ = check_align(lp2, tgt2, il2, tl2, 0,
                          f"phase 26 config 2 (B={b2}, T={t2}, S={s2}, "
                          f"V={v2}, peaked; an infeasible sample, an empty "
                          "target, an input length of 0)")
    if not (torch.isneginf(got2.scores[1]) and (got2.labels[:, 3] == -1).all()
            and (got2.positions[:, 2] == -1).all()):
        raise AssertionError("phase 26 edge samples wrong")
    check_greedy_alignment(lp_gpu, serve_il, "phase 26 the pipeline")
    check_greedy_alignment(lp2, il2, "phase 26 config 2")

    # 27. the MWER fine-tuning slice: 3 AdamW steps on pipeline.loss + 0.5
    # * mwer_loss with phase 9's batches
    mpipe = ConformerCTCPipeline(
        cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    check_mwer_step1(mpipe, tbatches[0])
    mopt = torch.optim.AdamW(mpipe.parameters(), lr=1e-3, weight_decay=1e-4)

    def mwer_objective(batch):
        """(pipeline.loss, 0.5 * mwer_loss) of a batch, differentiable."""
        wav_, ns_, tgt_, tl_ = batch
        logits_, out_len_ = mpipe.encode(wav_, ns_)
        lp_ = torch.log_softmax(logits_, -1).transpose(0, 1)
        return mpipe.loss(*batch), mwer_term(lp_, out_len_, tgt_, tl_)[0]

    def mwer_step(batch):
        mopt.zero_grad()
        ctc_term, mwer_t = mwer_objective(batch)
        (ctc_term + mwer_t).backward()
        mopt.step()
        return ctc_term.item(), mwer_t.item()

    torch.cuda.synchronize()
    reset_counts()
    for k in ctc_loss_cuda.launches:
        ctc_loss_cuda.launches[k] = 0
    mwer_losses = [mwer_step(batch) for batch in tbatches]
    torch.cuda.synchronize()
    mwer_launches = mwer_counts()
    log(f"phase 27 MWER fine-tuning: 3 AdamW steps x 8 requests, (CTC, 0.5 "
        f"* MWER) {[tuple(round(x, 6) for x in p) for p in mwer_losses]}, "
        f"launches {mwer_launches}")
    if mwer_launches != {"topk": 3, "beam_step": 3, "backtrace": 3,
                         "ctc_alpha": 6, "ctc_beta": 6, "ctc_grad": 6}:
        raise AssertionError(f"kernels missed on the MWER path: "
                             f"{mwer_launches}")
    if not all(np.isfinite(x) for p in mwer_losses for x in p):
        raise AssertionError(f"bad MWER loss: {mwer_losses}")
    # serving extras on phase 6's first batch
    conf_out = greedy_decode_with_confidence(lp_gpu, serve_il)
    conf_cpu = greedy_decode_with_confidence(lp_gpu.cpu(), serve_il.cpu())
    conf_err = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(conf_out[4:], conf_cpu[4:]))
    same = all(torch.equal(conf_out[i].cpu(), conf_cpu[i]) for i in (0, 1, 3))
    log(f"phase 27 greedy_decode_with_confidence, card vs CPU: tokens, "
        f"lengths and times equal: {same}; confidences max err "
        f"{conf_err:.3g}; utterance confidences "
        f"{[round(x, 4) for x in conf_out[5].tolist()]}")
    if not same or conf_err > CONF_TOL:
        raise AssertionError(f"confidences differ: {same}, {conf_err}")
    ab = asr_alphabet()
    space = ab.encode(" ")[0]
    n0 = int(conf_out[1][0])
    words = word_confidences(conf_out[0][0, :n0].tolist(),
                             conf_out[3][0, :n0].tolist(),
                             conf_out[4][0, :n0].tolist(), space_id=space,
                             alphabet=ab)
    srt = to_srt(group_word_spans(words, frame_duration_s=0.04), 0.04)
    log(f"phase 27 request 0: {len(words)} words, first "
        f"{words[:2]}; SRT {srt[:160]!r}")
    reset_counts()
    packed, kept = collapse_and_bucket(lp_gpu, serve_il)
    c_tok, c_len, c_sc = beam_search_decode(packed, kept, beam_width=8,
                                            prune_k=16)
    torch.cuda.synchronize()
    c_counts = beam_counts()
    log(f"phase 27 collapse_and_bucket: kept frames {kept.tolist()} of "
        f"{serve_il.tolist()}, T {lp_gpu.shape[0]} -> {packed.shape[0]}; the "
        f"beam decode on them: top-k {topk_cuda.launches}, beam step "
        f"{c_counts['launches']}, backtrace "
        f"{c_counts['launches_backtrace']}; best lengths "
        f"{c_len[:, 0].tolist()}")
    if (topk_cuda.launches, c_counts["launches"]) != (1, 1) or not bool(
            torch.isfinite(c_sc[:, 0]).all()):
        raise AssertionError("the collapsed decode missed its kernels")
    kept2 = collapse_and_bucket(lp2, il2)[1]
    log(f"phase 27 collapse_and_bucket on phase 26's peaked config-2 "
        f"lattice (blank at 0.997 on half the frames): "
        f"{int(kept2.sum())} of {int(il2.sum())} frames kept")

    # 28. timings: the alignment, the MWER step and its parts, the
    # confidences, the blank collapse
    ms["ctc_align_main"] = time_both("ctc_align_main", lambda: (
        alignment.align_cuda(lp_gpu, a_tgt, serve_il, a_tl)))
    ms["ctc_align_plain_main"] = time_plain(lambda: alignment.align_plain(
        lp_gpu, a_tgt.long(), serve_il.long(), a_tl.long()))
    ms["ctc_align_ref2"] = time_both("ctc_align_ref2", lambda: (
        alignment.align_cuda(lp2, tgt2, il2, tl2)))
    ms["ctc_align_plain_ref2"] = time_plain(lambda: alignment.align_plain(
        lp2, tgt2.long(), il2.long(), tl2.long()))
    align_b = align_bound(lp_gpu, a_tgt, serve_il, a_tl)
    align_b2 = align_bound(lp2, tgt2, il2, tl2)
    for name, b in (("main", align_b), ("ref2", align_b2)):
        log(f"phase 28 ctc_align ({name}): the kernel "
            f"{DEVICE_MS[f'ctc_align_{name}'][0]:.4f} ms device, one call "
            f"{ms[f'ctc_align_{name}']:.4f}; align_plain one call "
            f"{ms[f'ctc_align_plain_{name}']:.3f} ms; bound {b[0]:.5f} ms "
            f"({b[1]})")
    # the step's forward and backward without the optimizer's update, so
    # that the timed calls leave the model, and the N-best's length with
    # it, where mwer_parts finds them
    ms.update(mwer_parts(mpipe, tbatches[0], cfg.vocab_size - 1))

    def fwd_bwd(with_mwer):
        mopt.zero_grad()
        if with_mwer:
            sum(mwer_objective(tbatches[0])).backward()
        else:
            mpipe.loss(*tbatches[0]).backward()

    ms["mwer_fwd_bwd_b8_30s"] = time_ms(lambda: fwd_bwd(True))
    ms["ctc_fwd_bwd_b8_30s"] = time_ms(lambda: fwd_bwd(False))
    ms["greedy_confidence_main"] = time_ms(
        lambda: greedy_decode_with_confidence(lp_gpu, serve_il))
    ms["greedy_main"] = time_ms(lambda: greedy_decode(lp_gpu, serve_il))
    ms["blank_collapse_main"] = time_ms(
        lambda: blank_collapse(lp_gpu, serve_il))
    log(f"phase 28 the MWER step's forward and backward (CTC + 0.5 MWER, B=8 "
        f"x 30 s, no optimizer update): {ms['mwer_fwd_bwd_b8_30s']:.3f} ms "
        f"against the CTC loss's {ms['ctc_fwd_bwd_b8_30s']:.3f} (the CTC "
        f"train step of phase 10 {ms['train_step_b8_30s']:.3f}); "
        f"greedy_decode_with_confidence "
        f"{ms['greedy_confidence_main']:.3f} ms (greedy_decode "
        f"{ms['greedy_main']:.3f}); blank_collapse "
        f"{ms['blank_collapse_main']:.3f} ms")
    # 29. the hashed-LM serving slice on phase 6's batches; 30. its
    # timings and bench.py's word-trigram rows
    with torch.no_grad():
        hlm_lps = []
        for wav_b, ns_b in batches:
            logits_b, len_b = pipe.encode(wav_b, ns_b)
            hlm_lps.append((torch.log_softmax(logits_b, -1).transpose(
                0, 1).contiguous(), len_b.to(torch.int32)))
    slice29 = hashed_lm_slice(hlm_lps, cfg.vocab_size, dev)
    ms.update(hashed_lm_timings(dev, slice29, hlm_lps))
    # 31. the transducer decoding slice (ALSD, lookahead, streaming, long
    # form, MWER) on a freshly seeded model of phase 16's configuration
    # (phase 16's steps teach it to emit blanks only, which would leave
    # every decode near empty) and phase 16's requests; 32. its timings
    dmodel = ConformerTransducer(tcfg, seed=SEED + 31)
    with torch.no_grad():
        dmodel.joint["b_out"][0] += DECODE_BLANK_BIAS
    dmodel_cpu = ConformerTransducer(tcfg, seed=SEED + 31, device="cpu")
    s31 = transducer_decode_slice(dmodel, dmodel_cpu, xbatches[0], hlm_lps,
                                  dev)
    ms.update(transducer_decode_timings(dmodel, xbatches[0], s31))
    # 33. the OCR recognizer and the Dense-front-end transducer; 34. the
    # multi-GPU slice; 35. their timings
    s_ocr = ocr_slice(np.random.default_rng(SEED + 33), dev)
    s_dense = dense_transducer_slice(np.random.default_rng(SEED + 330), dev,
                                     rnnt_ref_lib)
    mg_ms, new_b = new_slice_timings(s_ocr, s_dense, mg)
    ms.update(mg_ms)
    # 36. the last slice's utilities: trace, build log, checkpoint, the
    # host runtime, the float64 oracles, Throughput and the examples
    s36 = utilities_slice(pipe, cfg, dev, batches, tbatches, lp_gpu,
                          serve_il, slice29["kn"], build_log)
    p36 = s36["launches"].get
    # 37. the predictor's GRU kernels against their plain twins, and timed
    s37 = gru_seq_slice(dev)
    ms.update(s37["ms"])
    # 38. the encoder's valid-frame packing at the serving cells' shapes
    ms.update(packing_slice(dev)["ms"])

    def mg_launches(kernel):  # every rank's, every path's
        return sum(n for x in mg for key, c in x.items()
                   if key.endswith("_launches") for k, n in c.items()
                   if k == kernel)

    log(json.dumps({"card": card, "ms": ms, "device_ms": DEVICE_MS}))

    beam_src = "end2end_tpu_torch/csrc/beam_step.cu"
    beam_tpu = "end2end_tpu/ops/beam_search_pallas.py"
    walk_src = "end2end_tpu_torch/csrc/backtrace.cu"
    ctc_src = "end2end_tpu_torch/csrc/ctc_loss.cu"
    rnnt_src = "end2end_tpu_torch/csrc/rnnt_loss.cu"
    rnnt_tpu = "end2end_tpu/ops/rnnt_loss_pallas.py"
    joint_src = "end2end_tpu_torch/csrc/rnnt_joint.cu"
    joint_tpu = "end2end_tpu/ops/rnnt_joint_pallas.py"
    rows = [  # name, source, replaces, launches, err, ms key, bound,
        # library key; every row's launches include phase 36's (p36)
        # launches: phase 6's serving path and phase 31's transducer
        # decoding slice (the ALSD top-K and top-W, the MWER step's decode)
        ("topk", "end2end_tpu_torch/csrc/topk.cu",
         "end2end_tpu/ops/topk_pallas.py:64",
         launches["topk"] + s31["launches"]["topk"]
         + s31["mwer_launches"]["topk"] + s_ocr["decode"]["topk"]
         + mg_launches("topk") + p36("topk", 0), topk_err,
         "topk_main", topk_b, "topk_library_main"),
        # + phase 33's OCR decode and phase 34's ranks' VP beams
        ("beam_step", beam_src, f"{beam_tpu}:94", launches["beam_step"]
         + s_ocr["decode"]["beam_step"] + mg_launches("beam_step")
         + p36("beam_step", 0) - p36("beam_step_lm", 0),  # counts K5 too
         beam_err, "beam_main", beam_b, None),
        # the same kernel at W=10 on the OCR row (three sequences a warp
        # in the backtrace): its launch is phase 33's decode
        ("beam_step_w10", beam_src, f"{beam_tpu}:94",
         s_ocr["decode"]["beam_step"], s_ocr["beam_err"], "beam_w10_bench",
         new_b["beam_w10"], None),
        # outside Pallas on the TPU: the backtrace's lane-map composition
        # and compaction, and the chunked decode's (one chunk's) scan
        ("backtrace", walk_src, f"{beam_tpu}:442", launches["backtrace"]
         + s_ocr["decode"]["backtrace"] + mg_launches("backtrace")
         + p36("backtrace", 0),
         bt_err, "backtrace_main", bt_b, None),
        ("backtrace_w10", walk_src, f"{beam_tpu}:442",
         s_ocr["decode"]["backtrace"], s_ocr["err"], "backtrace_w10_bench",
         new_b["backtrace_w10"], None),
        ("ctc_alpha", ctc_src, "end2end_tpu/ops/ctc_loss_pallas.py:115",
         train_launches["ctc_alpha"] + s_ocr["train"]["ctc_alpha"]
         + mg_launches("ctc_alpha") + p36("ctc_alpha", 0), ctc_err[0], "ctc_alpha_main", ctc_b[0],
         "ctc_library_fwd_main"),
        # library: F.ctc_loss backward alone, the yardstick of K2 + combine
        ("ctc_beta", ctc_src, "end2end_tpu/ops/ctc_loss_pallas.py:174",
         train_launches["ctc_beta"] + s_ocr["train"]["ctc_beta"]
         + mg_launches("ctc_beta") + p36("ctc_beta", 0), ctc_err[1], "ctc_beta_main", ctc_b[1],
         "ctc_library_bwd_main"),
        ("beam_step_lm", beam_src, f"{beam_tpu}:202",
         lm_launches["launches_lm"] + p36("beam_step_lm", 0), k5_err, "beam_lm_main", lm_b, None),
        ("beam_step_cls", beam_src, f"{beam_tpu}:101",
         chunk_launches["launches_cls"], chunk_err, "beam_cls_chunk", cls_b,
         None),
        ("beam_step_resume", beam_src, f"{beam_tpu}:129",
         chunk_launches["launches_resume"], chunk_err, "beam_resume_chunk",
         resume_b, None),
        ("lane_walk", walk_src, "end2end_tpu/ops/beam_chunked.py:70",
         chunk_launches["launches_walk"], walk_err, "lane_walk_chunk",
         walk_b, None),
        # torch has no transducer loss (and torchaudio is not installed);
        # launches: phase 16's training and phase 31's MWER step
        ("rnnt_alpha", rnnt_src, f"{rnnt_tpu}:108",
         rnnt_launches["rnnt_alpha"]
         + s31["mwer_launches"]["rnnt_alpha"]
         + s_dense["launches"]["rnnt_alpha"] + mg_launches("rnnt_alpha")
         + p36("rnnt_alpha", 0),
         max(rnnt_err[0], s_dense["errs"][0]),
         "rnnt_alpha_main", rnnt_b[0], None),
        ("rnnt_posteriors", rnnt_src, f"{rnnt_tpu}:194",
         rnnt_launches["rnnt_posteriors"]
         + s31["mwer_launches"]["rnnt_posteriors"]
         + s_dense["launches"]["rnnt_posteriors"]
         + mg_launches("rnnt_posteriors") + p36("rnnt_posteriors", 0),
         max(rnnt_err[1], s_dense["errs"][1]),
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
         train_launches["ctc_grad"] + s_ocr["train"]["ctc_grad"]
         + mg_launches("ctc_grad") + p36("ctc_grad", 0), combine_err, "ctc_grad_main",
         ctc_grad_b, None),
        # outside Pallas on the TPU: the Viterbi forward and backtrace
        # scans; torch has no forced alignment (nor torchaudio here)
        ("ctc_align", "end2end_tpu_torch/csrc/ctc_align.cu",
         "end2end_tpu/ops/alignment.py:37", align_launches, align_err,
         "ctc_align_main", align_b, None),
        # outside Pallas on the TPU: the predictor's lax.scan; times at the
        # transducer cell's longest bucket (N=11, U=158)
        *(("gru_" + d, "end2end_tpu_torch/csrc/gru_seq.cu",
           "end2end_tpu/models/transducer.py:112",
           gru_launches["gru_" + d] + s_dense["gru_launches"]["gru_" + d]
           + p36("gru_" + d, 0),
           s37["errs"]["gru_" + d], f"gru_{d}_{GRU_ROW}_bench",
           s37["bounds"][GRU_ROW], None) for d in ("forward", "backward")),
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
    beta_row = next(k for k in kernels if k["name"] == "ctc_beta")
    log(f"ctc_beta's library_ms is F.ctc_loss backward alone, which "
        f"computes what K2 + the combine do: K2 + combine "
        f"{beta_row['ms'] + DEVICE_MS['ctc_grad_main'][0]:.4f} ms against "
        f"{beta_row['library_ms']:.4f}")
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

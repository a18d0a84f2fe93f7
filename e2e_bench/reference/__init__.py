"""The plain reference: what the benchmark holds the port to.

Plain PyTorch and NumPy, written from the architecture's equations and
independent of the port: nothing here imports `end2end_tpu_torch`,
`end2end_tpu` or `jax`, and nothing takes a tensor that the port made.
The benchmark draws the weights (`e2e_bench.weights`) and the inputs
(`e2e_bench.traffic`) and hands the same to both sides; everything the
port derives from them (the mel filterbank, the positional table, the
lattices) is worked out here again.

  * `frontend`: log-mel features of waveforms.
  * `conformer`: the Conformer encoder, its parameter list (`encoder_spec`)
    and the precision it computes in (`Precision`).
  * `ctc`: the CTC pipeline's loss, log-probs, best paths and the
    log-likelihood and Viterbi score of a transcript.
  * `transducer`: the GRU predictor, the joint and the transducer loss.
  * `adamw`: the optimizer step, from its formula.
"""

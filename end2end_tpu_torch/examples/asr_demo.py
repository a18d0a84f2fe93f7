"""End-to-end ASR demo: train a tiny Conformer-CTC on synthetic audio until
it overfits, then decode with greedy and beam search, and round-trip a
checkpoint.

Run: python -m end2end_tpu_torch.examples.asr_demo
(E2E_DEMO_DEVICE=cpu runs it on the CPU, E2E_DEMO_STEPS sets the steps)
"""

import os
import tempfile

import numpy as np
import torch

from end2end_tpu_torch.examples import adamw_cosine, demo_device, demo_steps
from end2end_tpu_torch.models.pipeline import (ConformerCTCPipeline,
                                               PipelineConfig)
from end2end_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from end2end_tpu_torch.utils.metrics import corpus_wer
from end2end_tpu_torch.utils.text import asr_alphabet


def main():
    dev = demo_device()
    alphabet = asr_alphabet()
    cfg = PipelineConfig(vocab_size=len(alphabet), d_model=64,
                         num_layers=2, num_heads=2, n_mels=24)
    pipe = ConformerCTCPipeline(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0))

    rng = np.random.default_rng(0)
    B = 4
    wav = rng.standard_normal((B, 8000)).astype(np.float32)  # 0.5s each
    ns = np.full(B, 8000, np.int32)
    texts = ["hello", "jax tpu", "ctc", "beam"]
    tgt = np.zeros((B, 8), np.int32)
    tl = np.zeros(B, np.int32)
    for i, t in enumerate(texts):
        ids = alphabet.encode(t)
        tgt[i, : len(ids)] = ids
        tl[i] = len(ids)
    tgt, tl = torch.from_numpy(tgt).to(dev), torch.from_numpy(tl).to(dev)

    n_steps = demo_steps(400)
    opt, sched = adamw_cosine(pipe.parameters(), 5e-3, n_steps)
    for i in range(n_steps):
        opt.zero_grad()
        loss = pipe.loss(wav, ns, tgt, tl)
        loss.backward()
        opt.step()
        sched.step()
        if i % 50 == 0:
            print(f"step {i:3d}  ctc loss {loss.item():.3f}")

    def texts_of(tokens, lengths):
        return [alphabet.decode(tokens[i, : int(lengths[i])].tolist())
                for i in range(B)]

    toks, lens, _ = pipe.decode(wav, ns)
    greedy = texts_of(toks, lens)
    beam = texts_of(*pipe.decode(wav, ns, beam_width=8)[:2])
    print("\ntarget | greedy | beam-8")
    for t, g, b in zip(texts, greedy, beam):
        print(f"{t!r:12} | {g!r:12} | {b!r:12}")
    print(f"\ngreedy WER {corpus_wer(texts, greedy):.2%} | "
          f"beam-8 WER {corpus_wer(texts, beam):.2%}")

    # checkpoint round trip (utils/checkpoint.py) into a freshly built
    # pipeline: its greedy decode must be reproduced exactly
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        save_checkpoint(path, pipe.state_dict())
        fresh = ConformerCTCPipeline(
            cfg, device=dev, generator=torch.Generator().manual_seed(99))
        fresh.load_state_dict(restore_checkpoint(path, fresh.state_dict()))
    toks2, lens2, _ = fresh.decode(wav, ns)
    assert torch.equal(toks2, toks) and torch.equal(lens2, lens)
    print("checkpoint restore reproduces the greedy decode exactly")


if __name__ == "__main__":
    main()

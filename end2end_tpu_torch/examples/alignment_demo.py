"""Forced-alignment demo: align a transcript to a lattice and print the
per-frame segmentation.

Run: python -m end2end_tpu_torch.examples.alignment_demo
(E2E_DEMO_DEVICE=cpu runs it on the CPU)
"""

import numpy as np
import torch

import end2end_tpu_torch as e2e
from end2end_tpu_torch.examples import demo_device
from end2end_tpu_torch.utils.text import asr_alphabet


def main():
    dev = demo_device()
    alphabet = asr_alphabet()
    text = "cat"
    ids = alphabet.encode(text)
    T, V = 16, len(alphabet)

    # synthesize a lattice that clearly spells the target with varying spans
    lp = np.full((T, 1, V), np.log(0.01 / (V - 1)), np.float32)
    spans = [(1, 4, ids[0]), (6, 9, ids[1]), (11, 14, ids[2])]
    for t in range(T):
        c = 0
        for lo, hi, cid in spans:
            if lo <= t < hi:
                c = cid
        lp[t, 0, c] = np.log(0.99)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))

    def on_dev(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    out = e2e.ctc_forced_alignment(
        on_dev(lp), on_dev(np.array([ids], np.int32)),
        on_dev(np.array([T], np.int32)), on_dev(np.array([len(ids)],
                                                          np.int32)))
    labels = out.labels[:, 0].tolist()
    print(f"aligning {text!r}, best-path logp = {float(out.scores[0]):.2f}")
    for t in range(T):
        sym = alphabet.symbols[labels[t]] if labels[t] > 0 else "·"
        print(f"frame {t:2d}: {sym}")


if __name__ == "__main__":
    main()

"""Language-model decoding demo: the full KenLM-style toolchain.

Builds a word trigram ARPA from a toy corpus, then shows the ways to use it
with a char-CTC lattice:

  1. shallow fusion during beam search (word-boundary scoring, any order),
  2. fast no-LM decode + exact N-best rescoring (`rescore_nbest`),
  3. streaming decode with the LM state carried across lattice chunks,
  4. hotword boosting stacked on the word LM (`HotwordBoostLM` +
     `CompositeLM` -- pyctcdecode's hotwords setup),
  5. a char GRU LM trained on the corpus, fused through `NeuralLM`.

A char bigram `NGramLM` is also fitted from the corpus; on the card it
fuses inside the beam kernel (K5, csrc/beam_step.cu).

Run: python -m end2end_tpu_torch.examples.lm_decode_demo
(E2E_DEMO_DEVICE=cpu runs it on the CPU, E2E_DEMO_STEPS sets the GRU's
training steps)
"""

import math
import os
import tempfile
from collections import Counter

import numpy as np
import torch

import end2end_tpu_torch as e2e
from end2end_tpu_torch.examples import demo_device, demo_steps
from end2end_tpu_torch.ops.lm import HashedWordNGramLM, NGramLM
from end2end_tpu_torch.ops.neural_lm import (gru_logits, gru_step,
                                             random_gru_params)
from end2end_tpu_torch.utils.text import asr_alphabet

CORPUS = [
    "the cat sat on the mat",
    "the cat sat on the hat",
    "the dog sat on the mat",
    "a cat and a dog",
    "the cat and the dog sat",
]


def build_word_arpa(path, corpus):
    """Tiny add-one-smoothed trigram ARPA over the corpus words."""
    sents = [["<s>"] + s.split() + ["</s>"] for s in corpus]
    vocab = sorted({w for s in sents for w in s if w not in ("<s>", "</s>")})
    uni, bi, tri = Counter(), Counter(), Counter()
    for s in sents:
        for i, w in enumerate(s):
            uni[w] += 1
            if i >= 1:
                bi[(s[i - 1], w)] += 1
            if i >= 2:
                tri[(s[i - 2], s[i - 1], w)] += 1
    vs = len(uni)
    n_tot = sum(uni.values())

    def lg(p):
        return f"{math.log10(max(p, 1e-12)):.6f}"

    lines = ["\\data\\", f"ngram 1={len(uni)}", f"ngram 2={len(bi)}",
             f"ngram 3={len(tri)}", "", "\\1-grams:"]
    for w, c in sorted(uni.items()):
        lines.append(f"{lg((c + 1) / (n_tot + vs))}\t{w}\t-0.30103")
    lines += ["", "\\2-grams:"]
    for (a, b), c in sorted(bi.items()):
        lines.append(f"{lg(c / uni[a])}\t{a} {b}\t-0.30103")
    lines += ["", "\\3-grams:"]
    for (a, b, w), c in sorted(tri.items()):
        lines.append(f"{lg(c / bi[(a, b)])}\t{a} {b} {w}")
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return vocab


def char_bigram_lm(corpus, alphabet, device):
    """Dense char bigram from the corpus (fuses in the beam kernel on the
    card)."""
    v = len(alphabet)
    counts = np.ones((v, v), np.float64)
    for s in corpus:
        ids = alphabet.encode(s)
        for a, b in zip(ids, ids[1:]):
            counts[a, b] += 4.0
    probs = counts / counts.sum(1, keepdims=True)
    return NGramLM(np.log(probs).astype(np.float32), device=device)


def synth_lattice(alphabet, text, noise=1.2, seed=0, frames_per_char=2):
    """Noisy peaked lattice whose clean path spells `text`."""
    rng = np.random.default_rng(seed)
    ids = alphabet.encode(text)
    path = []
    for c in ids:
        path += [c] * frames_per_char + [0]
    T, V = len(path), len(alphabet)
    lp = np.full((T, 1, V), -6.0, np.float32)
    for t, c in enumerate(path):
        lp[t, 0, c] = -0.05
    lp += rng.standard_normal((T, 1, V)).astype(np.float32) * noise
    lp -= np.log(np.sum(np.exp(lp), -1, keepdims=True))
    return lp.astype(np.float32)


def train_char_gru(alphabet, device, n_steps):
    """A tiny char GRU LM trained on the corpus by gradient descent on its
    NLL (the cell is `ops.neural_lm.gru_step`); returns numpy weights."""
    rng = np.random.default_rng(7)
    V = len(alphabet)
    params = {k: torch.from_numpy(v).to(device).requires_grad_()
              for k, v in random_gru_params(rng, V, emb_dim=16,
                                            hidden_dim=48).items()}
    seqs = np.full((len(CORPUS), max(len(s) for s in CORPUS)), -1, np.int32)
    for i, s in enumerate(CORPUS):
        seqs[i, : len(s)] = alphabet.encode(s)
    seqs = torch.from_numpy(seqs).to(device)

    def nll(p):
        h = torch.zeros((seqs.shape[0], p["wz"].shape[1]), device=device)
        rows = torch.arange(seqs.shape[0], device=device)
        total = torch.zeros((), device=device)
        for tok in seqs.T:
            lp_tok = torch.log_softmax(gru_logits(p, h), -1)
            valid = tok >= 0
            safe = tok.clamp(min=0)
            total = total + torch.where(valid, -lp_tok[rows, safe],
                                        0.0).sum()
            h = torch.where(valid[:, None], gru_step(p, h, safe), h)
        return total / seqs.shape[0]

    for _ in range(n_steps):
        grads = torch.autograd.grad(nll(params), list(params.values()))
        with torch.no_grad():
            params = {k: (w - 0.15 * g).requires_grad_()
                      for (k, w), g in zip(params.items(), grads)}
    with torch.no_grad():
        print(f"char GRU LM trained: corpus NLL {nll(params).item():.2f}")
    return {k: w.detach().cpu().numpy() for k, w in params.items()}


def main():
    dev = demo_device()
    alphabet = asr_alphabet()
    lp_np = synth_lattice(alphabet, "the cat sat on the mat", noise=1.1)
    lp = torch.from_numpy(lp_np).to(dev)
    T = lp.shape[0]
    il = torch.tensor([T], dtype=torch.int32, device=dev)

    def show(tag, toks, lens):
        txt = "".join(alphabet.decode(toks[0, 0, : int(lens[0, 0])].tolist()))
        print(f"{tag:34s} -> {txt!r}")

    # 0. no LM
    base = e2e.beam_search_decode(lp, il, beam_width=8)
    show("beam-8, no LM", base[0], base[1])

    # 1. word-trigram shallow fusion (KenLM-style, any order)
    with tempfile.TemporaryDirectory() as d:
        arpa = os.path.join(d, "words.arpa")
        words = build_word_arpa(arpa, CORPUS)
        wlm = HashedWordNGramLM.from_arpa(arpa, words, alphabet, device=dev)
    fused = e2e.beam_search_decode(lp, il, beam_width=8, lm=wlm,
                                   lm_alpha=1.0, lm_beta=0.0)
    show("beam-8 + word-trigram fusion", fused[0], fused[1])

    # 2. fast no-LM decode + exact N-best rescoring
    rescored = e2e.rescore_nbest(*base, lm=wlm, lm_alpha=1.0, lm_beta=0.0)
    show("beam-8 + trigram N-best rescore", rescored[0], rescored[1])

    # 3. char-bigram fusion (in the beam kernel on the card) and streaming
    # with the LM
    clm = char_bigram_lm(CORPUS, alphabet, dev)
    cf = e2e.beam_search_decode(lp, il, beam_width=8, lm=clm,
                                lm_alpha=0.8, lm_beta=0.4)
    show("beam-8 + char-bigram fusion", cf[0], cf[1])

    dec = e2e.StreamingBeamDecoder(beam_width=8, lm=clm, lm_alpha=0.8,
                                   lm_beta=0.4, max_symbols=128)
    state = dec.init(1)
    for lo in range(0, T, 16):
        hi = min(lo + 16, T)
        state = dec.step(state, lp[lo:hi],
                         (il - lo).clamp(0, hi - lo).to(torch.int32))
    st, sl, ss = dec.finish(state)
    show("streaming beam + char LM (16f)", st, sl)

    # 4. hotword boosting stacked on the word LM: make the last word
    # acoustically ambiguous ('mat' barely ahead of 'hat'), then a modest
    # phrase boost flips it -- pyctcdecode's hotwords setup
    m_id = alphabet.encode("m")[0]
    h_id = alphabet.encode("h")[0]
    amb = lp_np.copy()
    m_frames = np.where(np.argmax(amb[:, 0], -1) == m_id)[0]
    amb[m_frames[-2:], 0, h_id] = amb[m_frames[-2:], 0, m_id] - 0.3
    amb -= np.log(np.sum(np.exp(amb), -1, keepdims=True))
    amb = torch.from_numpy(amb).to(dev)
    plain = e2e.beam_search_decode(amb, il, beam_width=8, lm=wlm,
                                   lm_alpha=1.0, lm_beta=0.0)
    show("ambiguous lattice, no hotword", plain[0], plain[1])
    hot = e2e.HotwordBoostLM([tuple(alphabet.encode("hat"))], weight=0.4,
                             complete_bonus=1.0, device=dev)
    stack = e2e.CompositeLM([wlm, hot], weights=[1.0, 1.0])
    hw = e2e.beam_search_decode(amb, il, beam_width=8, lm=stack,
                                lm_alpha=1.0, lm_beta=0.0)
    show('        + hotword "hat" boost', hw[0], hw[1])

    # 5. NEURAL shallow fusion: train a tiny char GRU LM on the corpus,
    # wrap it in NeuralLM, and fuse it into the same beam search
    gru = e2e.NeuralLM.gru(train_char_gru(alphabet, dev, demo_steps(300)),
                           device=dev)
    nf = e2e.beam_search_decode(lp, il, beam_width=8, lm=gru,
                                lm_alpha=0.8, lm_beta=0.3,
                                implementation="xla")
    show("beam-8 + trained GRU fusion", nf[0], nf[1])


if __name__ == "__main__":
    main()

"""Production-serving demo: LM training, confidence gating, MWER tuning.

Everything a production ASR deployment does around the decoder, in one
loop, with no external tools:

  1. estimate a Kneser-Ney word LM directly from text
     (`word_lm_from_corpus`: the KenLM `lmplz` role),
  2. beam-decode with word-LM fusion + per-token timestamps,
  3. attach confidences (frame -> token -> word -> utterance) and gate,
  4. fine-tune the model on its own errors with the MWER/MBR loss.

Run: python -m end2end_tpu_torch.examples.serving_demo
(E2E_DEMO_DEVICE=cpu runs it on the CPU, E2E_DEMO_STEPS sets the MWER
steps)
"""

import numpy as np
import torch

import end2end_tpu_torch as e2e
from end2end_tpu_torch.examples import demo_device, demo_steps
from end2end_tpu_torch.utils.text import asr_alphabet

CORPUS = [
    "the cat sat on the mat",
    "the cat ate the fish",
    "a dog sat on the rug",
    "the dog ate the bone",
    "a cat and a dog sat",
]


def peaked_lattice(text, alphabet, confusions=(), seed=0, pad=4):
    """Char lattice spelling `text`, with targeted acoustic confusions:
    each (char_pos, wrong_char, margin) makes the wrong char win the frame
    by `margin` odds -- the acoustically-best path spells the corruption."""
    rng = np.random.default_rng(seed)
    ids = alphabet.encode(text)
    t = 2 * len(ids) + pad
    a = np.full((t, 1, len(alphabet)), 0.02)
    for i, c in enumerate(ids):
        a[2 * i, 0, c] = 12.0
        a[2 * i + 1, 0, 0] = 12.0
    a[2 * len(ids):, 0, 0] = 12.0
    for pos, wrong, margin in confusions:
        wid = alphabet.encode(wrong)[0]
        a[2 * pos, 0, wid] = a[2 * pos, 0, ids[pos]] * margin
    a += rng.random(a.shape) * 0.3
    lp = np.log(a / a.sum(-1, keepdims=True))
    return lp.astype(np.float32), t


def main():
    dev = demo_device()
    ab = asr_alphabet()
    space = ab.encode(" ")[0]

    # 1. corpus -> interpolated modified-KN word bigram, ready to fuse
    lm = e2e.word_lm_from_corpus([s.split() for s in CORPUS], ab, order=2,
                                 device=dev)
    print(f"trained word LM: order={lm.order} over "
          f"{len({w for s in CORPUS for w in s.split()})} words")

    # 2. decode a noisy utterance with and without the LM: two chars are
    # acoustically confusable ('dog'->'bog', 'mat'->'mab'), producing
    # out-of-vocabulary words the LM can veto
    truth = "the dog sat on the mat"
    lp, t = peaked_lattice(
        truth, ab, confusions=[(4, "b", 1.3), (21, "b", 1.3)], seed=3)
    lp = torch.from_numpy(lp).to(dev)
    il = torch.tensor([t], dtype=torch.int32, device=dev)

    def decode(lm_):
        return e2e.beam_search_decode(
            lp, il, beam_width=8, max_symbols=32, lm=lm_, lm_alpha=0.8,
            lm_beta=0.4,  # per-token insertion bonus (pyctcdecode-style)
            return_timestamps=True, implementation="xla")

    for name, lm_ in (("no LM", None), ("word LM", lm)):
        toks, lens, scores, times = decode(lm_)
        n = int(lens[0, 0])
        print(f"  {name:8s}: {ab.decode(toks[0, 0, :n].tolist())!r}")

    # 3. confidence: frame -> token -> word -> utterance, then gate
    toks, lens, scores, times = decode(lm)
    n = int(lens[0, 0])
    fc = e2e.frame_confidence(lp, method="max_prob", exclude_blank=True)
    tc = e2e.token_confidence(fc, times, lens)
    uc = float(e2e.aggregate_confidence(tc, lens, "mean")[0, 0])
    words = e2e.word_confidences(
        toks[0, 0, :n].cpu().numpy(), times[0, 0, :n].cpu().numpy(),
        tc[0, 0, :n].cpu().numpy(), space_id=space, alphabet=ab, how="min")
    print("  per-word confidence:")
    for w, t0, t1, c in words:
        flag = "" if c > 0.7 else "   <- review"
        print(f"    {w:8s} frames [{t0:3d},{t1:3d}]  conf {c:.2f}{flag}")
    print(f"  utterance confidence {uc:.2f} -> "
          f"{'ACCEPT' if uc > 0.7 else 'SEND TO REVIEW'}")

    # 4. MWER fine-tuning on the model's own N-best errors
    targets = torch.tensor([ab.encode(truth)], dtype=torch.int32,
                           device=dev)
    s_len = targets.shape[1]
    tl = torch.tensor([s_len], dtype=torch.int32, device=dev)

    def objective(x):
        lpx = torch.log_softmax(x, dim=-1)
        return e2e.ctc_loss(lpx, targets, il, tl) + 0.5 * e2e.mwer_loss(
            lpx, targets, il, tl, beam_width=4,
            max_symbols=s_len + 2, err="word", space_id=space,
            implementation="xla")

    def expected_wer_errs(x):
        with torch.no_grad():
            _, aux = e2e.mwer_loss(
                torch.log_softmax(x, dim=-1), targets, il, tl, beam_width=4,
                max_symbols=s_len + 2, err="word", space_id=space,
                implementation="xla", return_aux=True)
        return float(aux["expected_error"].sum())

    x = lp
    e0 = expected_wer_errs(x)
    for _ in range(demo_steps(15)):
        x = x.detach().requires_grad_()
        (grad,) = torch.autograd.grad(objective(x), x)
        x = x - 1.5 * grad
    e1 = expected_wer_errs(x.detach())
    print(f"  MWER fine-tune: expected word errors {e0:.2f} -> {e1:.2f}")
    assert e1 < e0


if __name__ == "__main__":
    main()

"""OCR demo: train the CRNN-style recognizer to read synthetic glyph strips,
then decode with beam-10 (BASELINE config 3's decoding setup).

Run: python -m end2end_tpu_torch.examples.ocr_demo
(E2E_DEMO_DEVICE=cpu runs it on the CPU, E2E_DEMO_STEPS sets the steps)
"""

import numpy as np
import torch

from end2end_tpu_torch import beam_search_decode, ctc_loss
from end2end_tpu_torch.examples import adamw_cosine, demo_device, demo_steps
from end2end_tpu_torch.models.ocr import OCRRecognizer
from end2end_tpu_torch.utils.text import Alphabet


def glyph_strip(text, alphabet, h=16, glyph_w=8, width=64, rng=None):
    """Deterministic toy glyphs: each char id renders as a distinct pattern."""
    img = np.zeros((h, width), np.float32)
    for i, c in enumerate(text):
        cid = alphabet.encode(c)[0]
        x0 = i * glyph_w
        gy, gx = np.mgrid[0:h, 0:glyph_w]
        img[:, x0 : x0 + glyph_w] = np.sin(0.7 * cid * gx + gy * 0.31 * (cid % 5 + 1))
    if rng is not None:
        img += 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    return img, len(text) * glyph_w


def main():
    dev = demo_device()
    alphabet = Alphabet(["_"] + list("abcdefgh"))
    model = OCRRecognizer(vocab_size=len(alphabet), d_model=48, num_layers=1,
                          num_heads=2, device=dev,
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    texts = ["cafe", "badge", "dach", "fee"]
    imgs, widths, tgt, tl = [], [], [], []
    for t in texts:
        im, w = glyph_strip(t, alphabet, rng=rng)
        imgs.append(im)
        widths.append(w)
        ids = alphabet.encode(t)
        tgt.append(ids + [0] * (8 - len(ids)))
        tl.append(len(ids))
    imgs = torch.from_numpy(np.stack(imgs)).to(dev)
    widths = torch.tensor(widths, dtype=torch.int32, device=dev)
    tgt = torch.tensor(tgt, dtype=torch.int32, device=dev)
    tl = torch.tensor(tl, dtype=torch.int32, device=dev)

    def log_probs():
        logits, ow = model(imgs, widths)
        return torch.log_softmax(logits, -1).transpose(0, 1), ow

    n_steps = demo_steps(300)
    opt, sched = adamw_cosine(model.parameters(), 4e-3, n_steps)
    for i in range(n_steps):
        opt.zero_grad()
        lp, ow = log_probs()
        loss = ctc_loss(lp, tgt, ow, tl)
        loss.backward()
        opt.step()
        sched.step()
        if i % 50 == 0:
            print(f"step {i:3d}  ctc loss {loss.item():.3f}")

    with torch.no_grad():
        lp, ow = log_probs()
    toks, lens, scores = beam_search_decode(lp, ow, beam_width=10)
    print("\ntarget | beam-10 best")
    for i, t in enumerate(texts):
        got = alphabet.decode(toks[i, 0, : int(lens[i, 0])].tolist())
        print(f"{t!r:10} | {got!r}")


if __name__ == "__main__":
    main()

"""ARPA n-gram files -> dense bigram tables for shallow fusion (torch port
of the bigram part of `end2end_tpu/utils/arpa.py`).

The model is read once into dense tables (unigram, backoff-completed
bigram, <s> and </s> rows) that `ops.lm.NGramLM` and `ops.lm.WordNGramLM`
query with gathers.  Only the pure-Python parser is ported; the JAX
package's native C parser gives the same output faster.
"""

from __future__ import annotations

import numpy as np

from ..ops.semiring import LOG0

_LN10 = np.log(10.0)


def parse_arpa_python(path: str, vocab: list[str]):
    """(unigram, bigram, start, eos) natural-log float32 tables for `vocab`:
    unigram (V,), bigram (V, V) with unseen pairs backed off as
    bo(w1) + p(w2), start (V,) = log p(w | <s>), eos (V,) = log p(</s> | w)
    (0 everywhere when the file has no </s> unigram)."""
    v = len(vocab)
    word_id = {w: i for i, w in enumerate(vocab)}
    uni = np.full(v, LOG0, np.float32)
    bo = np.zeros(v, np.float32)
    start = np.full(v, LOG0, np.float32)
    eos = np.full(v, LOG0, np.float32)
    bigrams = []
    unk_lp, start_bo, eos_uni = LOG0, 0.0, None
    section = 0
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s == "\\1-grams:":
                section = 1
                continue
            if s == "\\2-grams:":
                section = 2
                continue
            if s in ("\\end\\", "\\3-grams:"):
                section = 3
                continue
            parts = s.split()
            if section == 1 and len(parts) >= 2:
                lp = float(parts[0]) * _LN10
                w = parts[1]
                b = float(parts[2]) * _LN10 if len(parts) >= 3 else 0.0
                if w in ("<unk>", "<UNK>"):
                    unk_lp = lp
                elif w == "<s>":
                    start_bo = b
                elif w == "</s>":
                    eos_uni = lp
                elif w in word_id:
                    uni[word_id[w]] = lp
                    bo[word_id[w]] = b
            elif section == 2 and len(parts) == 3:
                lp = float(parts[0]) * _LN10
                w1, w2 = parts[1], parts[2]
                if w2 == "</s>":
                    if w1 in word_id:
                        eos[word_id[w1]] = lp
                elif w2 in word_id:
                    if w1 == "<s>":
                        start[word_id[w2]] = lp
                    elif w1 in word_id:
                        bigrams.append((word_id[w1], word_id[w2], lp))
    uni = np.where(uni <= LOG0, unk_lp, uni).astype(np.float32)
    bigram = bo[:, None] + uni[None, :]
    for w1, w2, lp in bigrams:
        bigram[w1, w2] = lp
    start = np.where(start <= LOG0, start_bo + uni, start).astype(np.float32)
    # unseen "w </s>" backs off to bo(w) + p(</s>); without a </s> unigram
    # the end-of-sentence bonus is neutral (0)
    eos_fill = (bo + eos_uni) if eos_uni is not None else np.zeros(v)
    eos = np.where(eos <= LOG0, eos_fill, eos).astype(np.float32)
    return uni, bigram.astype(np.float32), start, eos


def load_arpa(path: str, vocab: list[str], prefer_native: bool = True):
    """(unigram, bigram, start, eos) natural-log tables for the vocab.

    `prefer_native` is accepted as the JAX package's loader takes it; the
    port has only the Python parser, so it changes nothing."""
    del prefer_native
    return parse_arpa_python(path, vocab)


def ngram_lm_from_arpa(path: str, vocab: list[str],
                       prefer_native: bool = True, *, device=None):
    """An `ops.lm.NGramLM` built from an ARPA file's bigrams
    (`prefer_native` as in `load_arpa`)."""
    from ..ops.lm import NGramLM

    _, bigram, start, eos = load_arpa(path, vocab, prefer_native)
    return NGramLM(bigram, start_logp=start, eos_logp=eos, device=device)

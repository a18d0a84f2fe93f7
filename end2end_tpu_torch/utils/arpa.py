"""ARPA n-gram files -> LM tables for shallow fusion (torch port of
`end2end_tpu/utils/arpa.py`).

`load_arpa` reads a bigram model into dense tables (unigram,
backoff-completed bigram, <s> and </s> rows) for `ops.lm.NGramLM` and
`ops.lm.WordNGramLM`; `parse_arpa_order` reads a model of any order into
the n-gram lists of `ops.lm.HashedNGramLM` and `ops.lm.HashedWordNGramLM`;
`ArpaScorer` is the float64 host oracle of their backoff semantics.  With
`prefer_native` (the default) both loaders parse with the C++ host
runtime (`utils/native.py`) when it is built, which gives the Python
parsers' output faster, and with the Python parsers otherwise.
"""

from __future__ import annotations

import numpy as np

from ..ops.semiring import LOG0
from . import native

_LN10 = np.log(10.0)


def parse_arpa_python(path: str, vocab: list[str]):
    """(unigram, bigram, start, eos) natural-log float32 tables for `vocab`:
    unigram (V,), bigram (V, V) with unseen pairs backed off as
    bo(w1) + p(w2), start (V,) = log p(w | <s>), eos (V,) = log p(</s> | w)
    (0 everywhere when the file has no </s> unigram).  A bigram line may
    carry a backoff weight (files of order 3 and above); the JAX package's
    parser skips such lines, and so loses those bigrams, where its native
    parser and this one read them."""
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
            elif section == 2 and len(parts) >= 3:  # bo optional
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
    """(unigram, bigram, start, eos) natural-log tables for the vocab, by
    the native parser when `prefer_native` and it is built."""
    if prefer_native and native.available():
        out = native.parse_arpa_native(path, vocab)
        if out is not None:
            return out
    return parse_arpa_python(path, vocab)


def ngram_lm_from_arpa(path: str, vocab: list[str],
                       prefer_native: bool = True, *, device=None):
    """An `ops.lm.NGramLM` built from an ARPA file's bigrams
    (`prefer_native` as in `load_arpa`)."""
    from ..ops.lm import NGramLM

    _, bigram, start, eos = load_arpa(path, vocab, prefer_native)
    return NGramLM(bigram, start_logp=start, eos_logp=eos, device=device)


def parse_arpa_order(path: str, vocab: list[str], prefer_native: bool = True):
    """An ARPA file of any order as (order, ngrams): ngrams[k] (1-based) is
    a list of (ids_tuple, logp, backoff) with natural-log scores.  Ids are
    vocab indices, <s> = len(vocab), </s> = len(vocab) + 1; n-grams with
    <unk> or out-of-vocabulary words are dropped except the <unk> unigram,
    whose log-prob is ngrams["unk"] (None without one).  With
    `prefer_native` the native parser reads it when it is built (orders up
    to 8), else the Python one below."""
    if prefer_native and native.available():
        out = native.parse_arpa_order_native(path, vocab)
        if out is not None:
            return out
    v = len(vocab)
    word_id = {w: i for i, w in enumerate(vocab)}
    word_id["<s>"] = v
    word_id["</s>"] = v + 1
    ngrams: dict = {"unk": None}
    order = 0
    section = 0
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("\\") and s.endswith("-grams:"):
                section = int(s[1:-7])
                order = max(order, section)
                ngrams.setdefault(section, [])
                continue
            if s == "\\end\\":
                break
            parts = s.split()
            if section < 1 or len(parts) < section + 1:
                continue
            lp = float(parts[0]) * _LN10
            words = parts[1:1 + section]
            bo = (float(parts[1 + section]) * _LN10
                  if len(parts) > section + 1 else 0.0)
            if section == 1 and words[0] in ("<unk>", "<UNK>"):
                ngrams["unk"] = lp
                continue
            if any(w not in word_id for w in words):
                continue
            ngrams[section].append((tuple(word_id[w] for w in words), lp,
                                    bo))
    return order, ngrams


class ArpaScorer:
    """Host dict-based backoff scorer: exact ARPA/KenLM semantics in
    float64, the oracle of the device LMs' tables."""

    def __init__(self, order, ngrams, vocab_size, unk_logp=None):
        self.order = int(order)
        self.v = int(vocab_size)
        self.bos = self.v
        self.eos = self.v + 1
        self.tab = {
            k: {ids: (lp, bo) for ids, lp, bo in ngrams.get(k, [])}
            for k in range(1, self.order + 1)
        }
        u = ngrams.get("unk")
        self.unk = float(unk_logp if unk_logp is not None
                         else (u if u is not None else -23.0))

    @classmethod
    def from_file(cls, path, vocab, **kw):
        # the Python parser: float64 scores, as an oracle's
        order, ngrams = parse_arpa_order(path, list(vocab),
                                         prefer_native=False)
        return cls(order, ngrams, len(vocab), **kw)

    def score(self, context, w):
        """log p(w | context) with full backoff: context a token id
        sequence (bos first at the start of an utterance), w a token id."""
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        acc = 0.0
        for k in range(self.order, 0, -1):
            need = k - 1
            if need <= len(ctx):
                c = ctx[len(ctx) - need:]
                g = c + (int(w),)
                if g in self.tab[k]:
                    return self.tab[k][g][0] + acc
                if k > 1 and c in self.tab[k - 1]:
                    acc += self.tab[k - 1][c][1]
        return self.unk + acc

"""N-gram LM estimation: corpus -> smoothed ARPA / device LM tables (torch
port of `end2end_tpu/utils/lm_train.py`, pure Python).

KenLM's workflow has two halves: training an n-gram model from text
(`lmplz`, interpolated modified Kneser-Ney) and querying it during beam
search.  This module is the first half, so a corpus becomes an LM with no
external tool:

    order, ngrams, vocab = train_ngram_lm(sentences, order=3)
    lm = HashedNGramLM(order, ngrams, len(vocab))          # token LM
    arpa_text = train_ngram_arpa(sentences, order=3)       # interoperable

Estimation is interpolated modified Kneser-Ney (Chen & Goodman 1999, the
KenLM default): per-order discounts D1/D2/D3+ from count-of-counts,
continuation counts for the lower orders, interpolation down to a uniform
base distribution.  It is written as a backoff ARPA model (entry prob =
the interpolated prob, backoff = the context's interpolation mass), so
every conditional distribution is normalised: for every context,

    sum_{w in vocab} p(w|ctx) + p(</s>|ctx) + p(<unk>|ctx) == 1

to float64 round-off (checked against the float64 `ArpaScorer`).
Counting is host-side (dicts), like every ARPA toolchain's first pass.
"""

from __future__ import annotations

import math
from collections import Counter

_LOG10 = math.log(10.0)


def _as_tokens(sentence):
    return sentence.split() if isinstance(sentence, str) else list(sentence)


def _count_raw(id_sentences, order, bos, eos):
    """Raw k-gram counts for k=1..order over <s>-padded sentences.

    KenLM/SRILM convention (matching this library's decoders, which seed
    ONE <s> in the LM state): each sentence is padded with a single <s>,
    so early positions condition on shorter contexts: the first word
    yields (<s>, w1) but never (<s>, <s>, w1).  Multi-<s> padding would
    create pure-<s> run contexts whose backoff weights have no storable
    entry (grams never end in <s>), leaking interpolation mass.
    """
    raw = [None] + [Counter() for _ in range(order)]
    for s in id_sentences:
        seq = [bos] + s + [eos]
        for k in range(1, order + 1):
            ctr = raw[k]
            for last in range(1, len(seq)):
                if last - k + 1 >= 0:
                    ctr[tuple(seq[last - k + 1 : last + 1])] += 1
    return raw


def _adjusted_counts(raw, order, bos):
    """Modified-KN counts per order: the top order keeps raw counts; lower
    orders use continuation counts N1+(. g) (distinct raw predecessors),
    EXCEPT grams starting with <s>, which can never be preceded and keep
    their raw counts (the standard convention).  Every raw-observed gram
    ends up with an adjusted count >= 1 (any non-<s>-initial occurrence
    has a predecessor), which guarantees each stored gram's suffix is
    stored one level down: the interpolation lookups below rely on it."""
    adj = [None] * (order + 1)
    adj[order] = dict(raw[order])
    for k in range(order - 1, 0, -1):
        cont = Counter()
        for g in raw[k + 1]:
            cont[g[1:]] += 1
        adj[k] = {g: (c if g[0] == bos else cont.get(g, 0))
                  for g, c in raw[k].items()}
    return adj


def _discounts(counts, fallback):
    """Modified-KN discounts (D1, D2, D3+) from count-of-counts; falls back
    to a fixed discount when the corpus is too small for the estimator."""
    n = Counter()
    for c in counts:
        if 1 <= c <= 4:
            n[c] += 1
    n1, n2, n3, n4 = n[1], n[2], n[3], n[4]
    if n1 == 0 or n2 == 0:
        return (fallback, fallback, fallback)
    y = n1 / (n1 + 2.0 * n2)
    d1 = 1.0 - 2.0 * y * n2 / n1
    d2 = 2.0 - 3.0 * y * n3 / n2 if n3 else fallback
    d3 = 3.0 - 4.0 * y * n4 / n3 if n3 and n4 else fallback
    ds = []
    for i, d in enumerate((d1, d2, d3)):
        ds.append(d if 0.0 <= d <= i + 1 else min(fallback, i + 1))
    return tuple(ds)


def train_ngram_lm(sentences, order=3, vocab=None, discount=None,
                   include_unk=True):
    """Estimate an interpolated modified-Kneser-Ney n-gram LM.

    Args:
      sentences: iterable of sentences; each a list of token strings (or a
        whitespace-joined string).  For word LMs tokens are words; for
        token LMs pass e.g. characters.
      order: n-gram order (>= 1).
      vocab: list of token strings defining the model's id space; defaults
        to the sorted set of corpus tokens.  Every vocab token receives a
        unigram entry even at count 0 (interpolation mass).
      discount: fixed discount used when the count-of-counts estimator is
        degenerate (default 0.75); never applied beyond a gram's own count.
      include_unk: reserve uniform-base mass for <unk> (one extra event in
        the base distribution) and emit its unigram, KenLM-style.  With
        False, <unk> gets a -99 placeholder and the distribution
        normalizes exactly over vocab + </s>.

    Returns:
      (order, ngrams, vocab) where `ngrams` is exactly the structure
      `utils.arpa.parse_arpa_order` produces (natural-log scores; token ids
      are vocab indices, <s> = len(vocab), </s> = len(vocab)+1; key "unk"
      holds the <unk> log-prob): feed it to
      `ops.lm.HashedNGramLM(order, ngrams, len(vocab))`,
      `HashedWordNGramLM(...)`, or `utils.arpa.ArpaScorer`.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    sents = [_as_tokens(s) for s in sentences]
    sents = [s for s in sents if s]
    if not sents:
        raise ValueError("empty corpus")
    if vocab is None:
        vocab = sorted({w for s in sents for w in s})
    word_id = {w: i for i, w in enumerate(vocab)}
    missing = {w for s in sents for w in s if w not in word_id}
    if missing:
        raise ValueError(
            f"corpus tokens outside vocab: {sorted(missing)[:5]}"
            f"{'...' if len(missing) > 5 else ''}")
    v = len(vocab)
    bos, eos = v, v + 1
    fallback = 0.75 if discount is None else float(discount)

    id_sents = [[word_id[w] for w in s] for s in sents]
    raw = _count_raw(id_sents, order, bos, eos)
    adj = _adjusted_counts(raw, order, bos)

    # Per-order distributions, lowest first.  p[k] maps gram -> interpolated
    # prob; gamma[k] maps context (len k-1) -> interpolation mass.
    n_events = v + 1 + (1 if include_unk else 0)  # vocab + </s> (+ <unk>)
    uniform = 1.0 / n_events

    p = [None] * (order + 1)
    gamma = [None] * (order + 1)

    # level 1: continuation-count unigrams over all events
    a1 = adj[1]
    d1 = _discounts(a1.values(), fallback)
    dd = lambda c, ds: 0.0 if c == 0 else min(ds[min(c, 3) - 1], c)  # noqa: E731
    denom1 = sum(a1.values())
    if denom1 == 0:
        raise ValueError("corpus has no countable unigrams")
    removed = sum(dd(c, d1) for c in a1.values())
    g1 = removed / denom1
    # events with no continuation count at all get pure interpolation mass
    zero_mass = g1 * uniform
    p1 = {}
    for w in list(range(v)) + [eos]:
        c = a1.get((w,), 0)
        p1[(w,)] = (c - dd(c, d1)) / denom1 + zero_mass
    p[1] = p1
    gamma[1] = {(): g1}
    unk_logp = math.log(zero_mass) if include_unk else -99.0 * _LOG10

    for k in range(2, order + 1):
        ak = adj[k]
        ds = _discounts(ak.values(), fallback)
        by_ctx = {}
        for g, c in ak.items():
            by_ctx.setdefault(g[:-1], []).append((g, c))
        pk, gk = {}, {}
        lower = p[k - 1]
        for ctx, grams in by_ctx.items():
            denom = sum(c for _, c in grams)
            removed = sum(dd(c, ds) for _, c in grams)
            g_ctx = removed / denom
            gk[ctx] = g_ctx
            for g, c in grams:
                # the suffix is always stored one level down (see
                # _adjusted_counts), so this lookup cannot miss
                pk[g] = (c - dd(c, ds)) / denom + g_ctx * lower[g[1:]]
        p[k] = pk
        gamma[k] = gk

    # assemble parse_arpa_order-shaped output (natural log)
    ngrams = {"unk": unk_logp}
    for k in range(1, order + 1):
        rows = []
        higher_ctx = gamma[k + 1] if k < order else {}
        if k == 1:
            for w in list(range(v)) + [eos]:
                lp = math.log(p1[(w,)])
                bo = higher_ctx.get((w,), 0.0)
                rows.append(((w,), lp, math.log(bo) if bo > 0.0 else 0.0))
            bo = higher_ctx.get((bos,), 0.0)
            rows.append(((bos,), -99.0 * _LOG10,
                         math.log(bo) if bo > 0.0 else 0.0))
        else:
            for g, prob in sorted(p[k].items()):
                bo = higher_ctx.get(g, 0.0)
                rows.append((g, math.log(prob),
                             math.log(bo) if bo > 0.0 else 0.0))
        ngrams[k] = rows
    return order, ngrams, vocab


def render_arpa(order, ngrams, vocab):
    """Render a train_ngram_lm result as ARPA text (log10, KenLM-readable;
    round-trips through `utils.arpa.parse_arpa_order` to 8 digits)."""
    v = len(vocab)
    names = list(vocab) + ["<s>", "</s>"]
    out = ["\\data\\"]
    counts = {k: len(ngrams.get(k, [])) + (1 if k == 1 else 0)
              for k in range(1, order + 1)}  # +1: the <unk> unigram
    for k in range(1, order + 1):
        out.append(f"ngram {k}={counts[k]}")
    for k in range(1, order + 1):
        out.append("")
        out.append(f"\\{k}-grams:")
        if k == 1:
            out.append(f"{ngrams['unk'] / _LOG10:.8f}\t<unk>")
        for ids, lp, bo in ngrams.get(k, []):
            words = " ".join(names[i] for i in ids)
            line = f"{lp / _LOG10:.8f}\t{words}"
            if k < order and bo != 0.0:
                line += f"\t{bo / _LOG10:.8f}"
            out.append(line)
    out += ["", "\\end\\", ""]
    return "\n".join(out)


def train_ngram_arpa(sentences, order=3, vocab=None, **kw):
    """corpus -> ARPA text (see train_ngram_lm)."""
    order, ngrams, vocab = train_ngram_lm(sentences, order, vocab, **kw)
    return render_arpa(order, ngrams, vocab)


def word_lm_from_corpus(sentences, alphabet, order=3, space_symbol=" ",
                        vocab=None, boundary_ids=None, spellings=None, *,
                        device=None, **kw):
    """corpus -> ready-to-fuse `HashedWordNGramLM` on `device` (the card
    by default).  `alphabet` maps word spellings to CTC token ids
    (utils.text.Alphabet); for BPE units pass `spellings` +
    `boundary_ids` instead (see HashedWordNGramLM.from_arpa).
    """
    from ..ops.lm import HashedWordNGramLM

    order, ngrams, vocab = train_ngram_lm(sentences, order, vocab, **kw)
    if spellings is None:
        spellings = [tuple(alphabet.encode(w)) for w in vocab]
    space_id = (None if boundary_ids is not None
                else alphabet.encode(space_symbol)[0])
    return HashedWordNGramLM(spellings, order, ngrams, space_id,
                             boundary_ids=boundary_ids, device=device)

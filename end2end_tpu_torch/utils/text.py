"""Label alphabets and text<->id conversion (copy of
`end2end_tpu/utils/text.py`; the port keeps its own, since importing the
JAX package would import JAX): the decoder classes' vocab/labels handling.

Conventions match the library: id 0 is the CTC blank by default; alphabets
are lists indexed by label id (index 0 = blank symbol, rendered as "").
"""

from __future__ import annotations

import string

# 29-symbol char ASR set (BASELINE configs 1-2): blank + a-z + ' + space.
ASR_CHARS = [""] + list(string.ascii_lowercase) + ["'", " "]

# 96-symbol printable OCR charset (BASELINE config 3): blank + printables.
OCR_CHARS = [""] + list(string.printable[:95])


class Alphabet:
    """Bidirectional label mapping with blank at a configurable id."""

    def __init__(self, symbols, blank_id: int = 0):
        self.symbols = list(symbols)
        self.blank_id = blank_id
        self._to_id = {
            s: i for i, s in enumerate(self.symbols) if i != blank_id
        }

    def __len__(self):
        return len(self.symbols)

    def encode(self, text: str):
        """Text -> list of label ids (raises KeyError on unknown symbols)."""
        return [self._to_id[c] for c in text]

    def decode(self, ids) -> str:
        """Label ids -> text (blank / out-of-range ids are skipped)."""
        out = []
        for i in ids:
            i = int(i)
            if i == self.blank_id or not 0 <= i < len(self.symbols):
                continue
            out.append(self.symbols[i])
        return "".join(out)


def asr_alphabet() -> Alphabet:
    return Alphabet(ASR_CHARS)


def ocr_alphabet() -> Alphabet:
    return Alphabet(OCR_CHARS)


def word_spans(ids, times, space_id=None, alphabet: Alphabet | None = None,
               boundary_ids=None):
    """Word-level timings from decoded tokens + per-token emission frames.

    ids/times: one hypothesis's token ids and frame indices, as returned by
    `greedy_decode_with_timestamps` or `beam_search_decode(...,
    return_timestamps=True)` (trim to the decoded length first).
    Words are delimited by exactly one of the two regimes the word-level
    LMs support (ops/lm.py):

      * `space_id`: separator token (space, char CTC) — the separator is
        dropped and splits words;
      * `boundary_ids`: word-STARTER token set (BPE '▁...'-style prefix
        marking) — a token in the set opens a new word and belongs to it.

    Each word's span is [first token's frame, last token's frame].
    Returns a list of (word, start_frame, end_frame) with `word` a string
    when an alphabet is given, else a list of ids.
    """
    if (space_id is None) == (boundary_ids is None):
        raise ValueError("pass exactly one of space_id / boundary_ids")
    boundary = frozenset(int(b) for b in boundary_ids or ())
    out = []
    cur_ids, cur_times = [], []

    def flush():
        if cur_ids:
            word = (alphabet.decode(cur_ids) if alphabet is not None
                    else list(cur_ids))
            out.append((word, int(cur_times[0]), int(cur_times[-1])))
        cur_ids.clear()
        cur_times.clear()

    for c, t in zip(ids, times):
        c = int(c)
        if space_id is not None and c == space_id:
            flush()
            continue
        if c in boundary:
            flush()
        cur_ids.append(c)
        cur_times.append(t)
    flush()
    return out

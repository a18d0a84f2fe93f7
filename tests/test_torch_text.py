"""The port's copies of the host-side text utilities (alphabets, word
spans, subtitles, edit distances) against the JAX package's: equal
outputs."""

import numpy as np
import pytest

from end2end_tpu.utils import metrics as jmetrics
from end2end_tpu.utils import subtitles as jsub
from end2end_tpu.utils import text as jtext
from end2end_tpu_torch.utils import metrics as tmetrics
from end2end_tpu_torch.utils import subtitles as tsub
from end2end_tpu_torch.utils import text as ttext


def test_alphabets_match_jax():
    for make in ("asr_alphabet", "ocr_alphabet"):
        got, want = getattr(ttext, make)(), getattr(jtext, make)()
        assert got.symbols == want.symbols and len(got) == len(want)
        text = "hello world's" if make == "asr_alphabet" else "Ab3 ~x!"
        assert got.encode(text) == want.encode(text)
        ids = want.encode(text) + [0, 999, -1]
        assert got.decode(ids) == want.decode(ids) == text
    custom = ttext.Alphabet(["a", "b", "-", "c"], blank_id=2)
    jcustom = jtext.Alphabet(["a", "b", "-", "c"], blank_id=2)
    assert custom.encode("abc") == jcustom.encode("abc") == [0, 1, 3]
    assert custom.decode([0, 2, 3]) == jcustom.decode([0, 2, 3]) == "ac"
    with pytest.raises(KeyError):
        custom.encode("-")


def _decoded(ab, text):
    ids = ab.encode(text)
    return ids, [2 * i + 1 for i in range(len(ids))]


def test_word_spans_match_jax():
    ab, jab = ttext.asr_alphabet(), jtext.asr_alphabet()
    space = ab.encode(" ")[0]
    ids, times = _decoded(ab, "  the cat  sat ")
    got = ttext.word_spans(ids, times, space_id=space, alphabet=ab)
    assert got == jtext.word_spans(ids, times, space_id=space, alphabet=jab)
    assert [w for w, *_ in got] == ["the", "cat", "sat"]
    assert ttext.word_spans(ids, times, space_id=space) == jtext.word_spans(
        ids, times, space_id=space)
    starters = ab.encode("tcs")
    got = ttext.word_spans(ids, times, boundary_ids=starters, alphabet=ab)
    assert got == jtext.word_spans(ids, times, boundary_ids=starters,
                                   alphabet=jab)
    with pytest.raises(ValueError, match="exactly one"):
        ttext.word_spans(ids, times)
    with pytest.raises(ValueError, match="exactly one"):
        ttext.word_spans(ids, times, space_id=space, boundary_ids=starters)


def test_subtitles_match_jax():
    ab = ttext.asr_alphabet()
    space = ab.encode(" ")[0]
    words = ("one two three four five six seven eight nine ten eleven "
             "twelve thirteen fourteen").split()
    ids, times = [], []
    t = 0
    for k, word in enumerate(words):
        for c in ab.encode(word):
            ids.append(c)
            times.append(t)
            t += 3
        ids.append(space)
        times.append(t)
        t += 40 if k == 4 else 2  # a long pause after the fifth word
    spans = ttext.word_spans(ids, times, space_id=space, alphabet=ab)
    conf = [s + (0.5 + 0.03 * k,) for k, s in enumerate(spans)]
    for sp in (spans, conf):
        for kw in ({}, {"max_words": 3}, {"max_duration_s": 1.0,
                                          "max_gap_s": 0.2}):
            cues = tsub.group_word_spans(sp, 0.04, **kw)
            assert cues == jsub.group_word_spans(sp, 0.04, **kw)
            for fmt in ("to_srt", "to_vtt"):
                assert getattr(tsub, fmt)(cues, 0.04, offset_s=1.5) == (
                    getattr(jsub, fmt)(cues, 0.04, offset_s=1.5))
    srt = tsub.to_srt(tsub.group_word_spans(spans, 0.04), 0.04)
    assert srt.startswith("1\n00:00:00,000 --> ")
    with pytest.raises(ValueError, match="positive"):
        tsub.to_vtt(spans, 0.0)


def test_host_metrics_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.integers(0, 4, int(rng.integers(0, 9))).tolist()
        b = rng.integers(0, 4, int(rng.integers(0, 9))).tolist()
        assert tmetrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
    pairs = [("the cat sat", "the bat sat down"), ("", ""), ("", "x"),
             ("a b", "")]
    for ref, hyp in pairs:
        assert tmetrics.wer(ref, hyp) == jmetrics.wer(ref, hyp)
        assert tmetrics.cer(ref, hyp) == jmetrics.cer(ref, hyp)
    refs, hyps = zip(*pairs)
    assert tmetrics.corpus_wer(refs, hyps) == jmetrics.corpus_wer(refs, hyps)

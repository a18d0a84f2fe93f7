"""Subtitle export: decoder word timings -> SRT / WebVTT text (copy of
`end2end_tpu/utils/subtitles.py`; the port keeps its own, since importing
the JAX package would import JAX).

Long-form transcription (models/streaming.py) plus word-level timings
(`utils.text.word_spans` / `ops.confidence.word_confidences`) is most
useful delivered as subtitles; this renders the standard formats from
those span tuples with nothing but the model's frame duration.

    spans = word_spans(ids, times, space_id=space, alphabet=ab)
    cues = group_word_spans(spans, frame_duration_s=0.04)
    srt = to_srt(cues, frame_duration_s=0.04)

Spans are (word, start_frame, end_frame[, confidence]) with INCLUSIVE
frame indices (a word's cue ends at the end of its last frame).  Frames
map to wall time via `frame_duration_s` — for a subsampling encoder this
is hop_s * subsampling (e.g. 10 ms hop x 4 = 0.04).
"""

from __future__ import annotations


def _fmt_time(seconds: float, sep: str) -> str:
    ms = max(int(round(seconds * 1000.0)), 0)
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def group_word_spans(spans, frame_duration_s: float,
                     max_duration_s: float = 5.0, max_gap_s: float = 1.0,
                     max_words: int = 12):
    """Merge word spans into caption cues.

    A new cue starts when the pause before a word exceeds `max_gap_s`,
    when the cue would exceed `max_duration_s`, or at `max_words`.
    Returns (text, start_frame, end_frame) tuples; input confidences
    (4-tuples) are preserved as each cue's MINIMUM confidence (gate on it
    to e.g. italicize low-confidence captions).
    """
    if frame_duration_s <= 0:
        raise ValueError("frame_duration_s must be positive")
    cues = []
    cur: list = []

    def flush():
        if not cur:
            return
        text = " ".join(w for w, *_ in cur)
        t0, t1 = cur[0][1], cur[-1][2]
        if len(cur[0]) > 3:
            cues.append((text, t0, t1, min(sp[3] for sp in cur)))
        else:
            cues.append((text, t0, t1))
        cur.clear()

    for sp in spans:
        if cur:
            gap_s = (sp[1] - cur[-1][2]) * frame_duration_s
            dur_s = (sp[2] + 1 - cur[0][1]) * frame_duration_s
            if (gap_s > max_gap_s or dur_s > max_duration_s
                    or len(cur) >= max_words):
                flush()
        cur.append(sp)
    flush()
    return cues


def to_srt(spans, frame_duration_s: float, offset_s: float = 0.0) -> str:
    """Render (text, start_frame, end_frame[, conf]) spans as SubRip text."""
    if frame_duration_s <= 0:
        raise ValueError("frame_duration_s must be positive")
    out = []
    for i, sp in enumerate(spans):
        text, t0, t1 = sp[0], sp[1], sp[2]
        start = offset_s + t0 * frame_duration_s
        end = offset_s + (t1 + 1) * frame_duration_s
        out.append(f"{i + 1}\n{_fmt_time(start, ',')} --> "
                   f"{_fmt_time(end, ',')}\n{text}\n")
    return "\n".join(out)


def to_vtt(spans, frame_duration_s: float, offset_s: float = 0.0) -> str:
    """Render (text, start_frame, end_frame[, conf]) spans as WebVTT text."""
    if frame_duration_s <= 0:
        raise ValueError("frame_duration_s must be positive")
    out = ["WEBVTT\n"]
    for sp in spans:
        text, t0, t1 = sp[0], sp[1], sp[2]
        start = offset_s + t0 * frame_duration_s
        end = offset_s + (t1 + 1) * frame_duration_s
        out.append(f"{_fmt_time(start, '.')} --> "
                   f"{_fmt_time(end, '.')}\n{text}\n")
    return "\n".join(out)

"""A whole run on the CPU at a tiny size, the card's look skipped: sound,
`correct` is true; with the timed path broken underneath, once for each
fault a cell can have, it is false."""

import pytest
import torch

from e2e_bench.tests import tiny
from end2end_tpu_torch.models import pipeline
from end2end_tpu_torch.models.pipeline import ConformerCTCPipeline
from end2end_tpu_torch.models.transducer import ConformerTransducer

TRAIN = ("ctc-large.train", "transducer-large.train")
SERVE = ("ctc-large.serve-beam8", "ctc-large.serve-greedy")


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    out = tiny.run(tiny.cell(name))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _half(x):
    return x[: max(1, len(x) // 2)]


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_returns_its_state_unchanged(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out = tiny.run(tiny.cell(name))
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_half_the_batch_out(name, monkeypatch):
    cls = ConformerCTCPipeline if "ctc" in name else ConformerTransducer
    loss = cls.loss
    monkeypatch.setattr(cls, "loss", lambda self, a, b, c, d, **kw: loss(
        self, _half(a), _half(b), _half(c), _half(d), **kw))
    out = tiny.run(tiny.cell(name))
    assert not out["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_token_altered_where_it_is_produced(name, monkeypatch):
    decode = ConformerCTCPipeline.decode

    def altered(self, *a, **kw):
        tokens, lengths, scores = decode(self, *a, **kw)
        tokens = tokens.clone()
        for i in range(len(lengths)):
            j = int(lengths[i]) // 2
            if lengths[i] > 0:
                tokens[i, j] = tokens[i, j] % (self.config.vocab_size - 1) + 1
        return tokens, lengths, scores

    monkeypatch.setattr(ConformerCTCPipeline, "decode", altered)
    out = tiny.run(tiny.cell(name))
    assert not out["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_half_the_batch_left_out(name, monkeypatch):
    decode = ConformerCTCPipeline.decode

    def half(self, waveforms, num_samples, **kw):
        n = len(num_samples)
        tokens, lengths, scores = decode(self, _half(waveforms),
                                         _half(num_samples), **kw)
        pad = n - len(lengths)
        return (torch.cat([tokens, tokens.new_full((pad, tokens.shape[1]),
                                                   -1)]),
                torch.cat([lengths, lengths.new_zeros(pad)]),
                torch.cat([scores, scores.new_zeros(pad)]))

    monkeypatch.setattr(ConformerCTCPipeline, "decode", half)
    c = tiny.cell(name)
    c.mix["check"]["requests"] = 8  # both halves of a batch in the sample
    out = tiny.run(c)
    assert not out["correct"]


def test_last_beam_served_in_place_of_the_best(monkeypatch):
    search = pipeline.beam_search_decode

    def last(*a, **kw):
        tokens, lengths, scores = search(*a, **kw)
        return tokens.roll(1, 1), lengths.roll(1, 1), scores.roll(1, 1)

    monkeypatch.setattr(pipeline, "beam_search_decode", last)
    out = tiny.run(tiny.cell("ctc-large.serve-beam8"))
    assert not out["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_one_row_of_the_batch_altered(name, monkeypatch):
    """A fault confined to one row of every batch is in the sample."""
    decode = ConformerCTCPipeline.decode

    def altered(self, *a, **kw):
        tokens, lengths, scores = decode(self, *a, **kw)
        scores = scores.clone()
        scores[-1] -= 1.0
        return tokens, lengths, scores

    monkeypatch.setattr(ConformerCTCPipeline, "decode", altered)
    out = tiny.run(tiny.cell(name))
    assert not out["correct"]

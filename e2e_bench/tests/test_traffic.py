"""The generator: a seed gives the same draws; every seed gets the same
sizes and batches, in another order."""

import numpy as np
import pytest
import torch

from e2e_bench import traffic
from e2e_bench.tests.tiny import ROOT, cell

CELLS = ("ctc-large.train", "ctc-large.serve-beam8")


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_draws(name):
    c = cell(name)
    b = traffic.batches(c.mix, c.cfg)[0]
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(traffic.seeds(123456789012, 3)[1])
        draws.append(traffic.materialise(b, c.cfg, g, "cpu"))
    for x, y in zip(*draws):
        assert torch.equal(x, y)
    assert np.array_equal(traffic.order(c.mix, 10, 0),
                          traffic.order(c.mix, 10, 0))


@pytest.mark.parametrize("name", CELLS)
def test_sizes_never_depend_on_the_seed(name):
    c = cell(name)
    sets = traffic.batches(c.mix, c.cfg)
    assert sets == traffic.batches(c.mix, c.cfg)
    a, b = traffic.order(c.mix, len(sets), 0), traffic.order(c.mix,
                                                             len(sets), 1)
    assert sorted(a) == sorted(b) == list(range(len(sets)))
    assert not np.array_equal(a, b)  # epochs differ; run seeds do not
    g1, g2 = (torch.Generator().manual_seed(traffic.seeds(s, 3)[1])
              for s in (1, 2))
    w1 = traffic.materialise(sets[0], c.cfg, g1, "cpu")[0]
    w2 = traffic.materialise(sets[0], c.cfg, g2, "cpu")[0]
    assert w1.shape == w2.shape and not torch.equal(w1, w2)


def test_seeds_take_large_values():
    s = traffic.seeds(2 ** 31 + 12345, 3)
    assert len(set(s)) == 3 and all(0 <= x < 2 ** 63 for x in s)


def test_full_size_batches_keep_to_their_budgets():
    import json

    cfg = json.loads((ROOT / "e2e_bench/configs/conformer-ctc-large.json")
                     .read_text())
    for mix_name in ("ctc-train-800s", "rnnt-train-400s"):
        mix = json.loads((ROOT / f"e2e_bench/traffic/{mix_name}.json")
                         .read_text())
        sets = traffic.batches(mix, cfg)
        for b in sets:
            assert len(b.rows) * b.pad_samples <= mix["batch_audio_s"] * 16000
            assert max(b.samples) <= b.pad_samples
            assert b.pad_targets >= max(b.targets)
        mean = np.mean(traffic.durations(mix))
        assert abs(mean - mix["duration_s"]["mean"]) < 0.5
    serve = json.loads((ROOT / "e2e_bench/traffic/testclean-b32-beam8.json")
                       .read_text())
    sets = traffic.batches(serve, cfg)
    assert len(sets) == serve["utterances"] // serve["batch"]
    assert all(len(b.rows) == 32 and b.pad_samples % 16000 == 0
               for b in sets)


def test_waveforms_are_silent_past_each_length():
    c = cell("ctc-large.train")
    b = traffic.batches(c.mix, c.cfg)[0]
    wave, n, tgt, tl = traffic.materialise(
        b, c.cfg, torch.Generator().manual_seed(0), "cpu")
    for i in range(len(n)):
        assert torch.all(wave[i, n[i]:] == 0) and torch.all(wave[i, :n[i]] != 0)
        assert torch.all(tgt[i, tl[i]:] == 0) and torch.all(tgt[i, :tl[i]] > 0)


def test_schedule_runs_epoch_after_epoch_in_the_drawn_order():
    c = cell("ctc-large.train")
    n = 7
    index = traffic.Schedule(c.mix, n).index
    seq = [index(k) for k in range(3 * n)]
    for epoch in range(3):
        assert seq[epoch * n:(epoch + 1) * n] == list(
            traffic.order(c.mix, n, epoch))

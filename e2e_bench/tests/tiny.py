"""Tiny stand-ins for the benchmark's cells, for CPU tests: the cell's own
files with the widths, depth, vocabulary and traffic cut down."""

from __future__ import annotations

import copy
from pathlib import Path

from e2e_bench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("ctc-large.train", "transducer-large.train",
         "ctc-large.serve-beam8", "ctc-large.serve-greedy")


def shrink(cell):
    cfg = dict(cell.cfg, d_model=32, num_layers=2, num_heads=4,
               subsampling_conv_channels=32, vocab_size=9)
    if cfg["model"] == "transducer":
        cfg.update(enc_dim=24, pred_emb_dim=8, pred_hidden=16,
                   joint_hidden=16)
    mix = copy.deepcopy(cell.mix)
    mix["utterances"] = 24
    mix["duration_s"] = {"dist": "gamma", "mean": 1.5, "sd": 0.5,
                         "min": 0.5, "max": 3.0}
    if "batch_audio_s" in mix:
        mix.update(bucket_s=1.0, batch_audio_s=6.0, targets_per_s=3.0)
    else:
        mix.update(batch=4, pad_to_s=0.5)
        mix["check"]["requests"] = 4
        mix["weights"] = {"out_scale": 8.0}
    mix["trace"] = {"skip": 1, "count": 2}
    cell.cfg, cell.mix = cfg, mix
    return cell


def cell(name: str):
    return shrink(harness.load_cell(ROOT, name))


def run(c, seed=7, seconds=0.5, traced=False):
    import time

    return harness.run_cell(c, seed, seconds, traced, "cpu",
                            time.perf_counter(), ROOT)

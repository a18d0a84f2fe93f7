"""The Parakeet cell's and the data-parallel cell's entries at tiny sizes on
the CPU: a run of each is correct; the data-parallel ranks (gloo
processes here) end bit-equal; the predictor metric counts cuDNN's cell
kernels and the GEMMs between them, and nothing without them."""

import copy
from types import SimpleNamespace

from e2e_bench import harness
from e2e_bench.tests import tiny


def _parakeet():
    cell = harness.load_cell(tiny.ROOT, "parakeet-rnnt-1.1b.train")
    cell.cfg = dict(cell.cfg, d_model=64, num_layers=2, num_heads=4,
                    subsampling_conv_channels=16, vocab_size=33, enc_dim=64,
                    pred_emb_dim=32, pred_hidden=32, joint_hidden=32)
    mix = copy.deepcopy(cell.mix)
    mix["utterances"] = 24
    mix["duration_s"] = {"dist": "gamma", "mean": 1.5, "sd": 0.5,
                         "min": 0.5, "max": 3.0}
    mix.update(bucket_s=1.0, batch_audio_s=6.0, targets_per_s=3.0)
    mix["trace"] = {"skip": 1, "count": 2}
    cell.mix = mix
    return cell


def test_the_parakeet_cell_runs_correct():
    out = tiny.run(_parakeet())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_throughput.transducer", "setup_s"}


def test_the_predictor_metric_reads_cudnns_lstm_runs():
    read = harness.reader(tiny.ROOT, "predictor_ms.train.parakeet")
    ops = [(0, 5, "gemm_a", "kernel"), (5, 7, "elemWiseRNNcell", "kernel"),
           (7, 10, "gemm_b", "kernel"), (10, 11, "elemWiseRNNcell", "kernel"),
           (11, 50, "other", "kernel"), (50, 90, "gemm_c", "kernel")]
    run = SimpleNamespace(kind="train", slice_works=[{"audio_s": 2.0}],
                          trace=SimpleNamespace(ops=ops))
    assert read(run) == 1e3 * 6e-6 / 2.0  # from the first cell to the last
    run.trace.ops = [o for o in ops if o[2] != "elemWiseRNNcell"]
    assert read(run) is None


def test_the_data_parallel_cell_runs_correct():
    cell = tiny.cell("ctc-large.train.dp4")
    out = tiny.run(cell, seconds=0.5)
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_mismatch"]["value"] == 0.0
    assert set(out["metrics"]) == {"train_throughput", "setup_s"}

"""A new cell needs new files and new entries in BENCHMARK.json, and no
edit: a copy of the benchmark gains a configuration, a traffic mix, limits
and a metric, and the new cell runs."""

import json
import shutil

from e2e_bench import harness
from e2e_bench.tests.tiny import ROOT


def test_a_cell_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "e2e_bench", tmp_path / "e2e_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = tmp_path / "e2e_bench"
    before = {p.relative_to(base): p.read_bytes()
              for p in base.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs/conformer-ctc-large.json").read_text())
    cfg.update(name="conformer-ctc-small", d_model=32, num_layers=2,
               num_heads=4, subsampling_conv_channels=32, vocab_size=17)
    (base / "configs/conformer-ctc-small.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic/testclean-b32-greedy.json").read_text())
    mix.update(utterances=16, batch=4, pad_to_s=0.5,
               duration_s={"dist": "gamma", "mean": 1.5, "sd": 0.5,
                           "min": 0.5, "max": 3.0},
               check={"requests": 4})
    (base / "traffic/short-b4-greedy.json").write_text(json.dumps(mix))
    (base / "limits/ctc-small.serve-short.json").write_text(
        json.dumps({"score_gap": 1e-3, "rank_gap": 1e-3}))
    (base / "metrics/decode_latency_p50.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    lat = [x for w in run.works for x in w.get('latencies_s', [])]\n"
        "    return 1e3 * float(np.median(lat)) if lat else None\n")
    bench["configs"].append({"name": "conformer-ctc-small",
                             "source": "https://example.org/small",
                             "file": "e2e_bench/configs/conformer-ctc-small.json",
                             "reduced": ["d_model"], "why": "a test"})
    bench["workloads"].append({"name": "ctc-small.serve-short",
                               "config": "conformer-ctc-small",
                               "traffic": "short-b4-greedy", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "decode_latency_p50", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["ctc-small.serve-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(base): p.read_bytes()
             for p in base.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    cell = harness.load_cell(tmp_path, "ctc-small.serve-short")
    import time

    out = harness.run_cell(cell, 5, 0.3, False, "cpu", time.perf_counter(),
                           tmp_path)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"decode_latency_p50", "setup_s"}

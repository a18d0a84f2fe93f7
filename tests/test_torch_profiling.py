"""The port's profiling helpers (`end2end_tpu_torch/utils/profiling.py`):
`trace` writes a Chrome trace of a pipeline decode, `log_compiles` logs the
builds of the port's libraries (the host runtime's g++ build here, in a
build directory of the test's own), and `Throughput` is consistent (CPU)."""

import json
import logging
import shutil
import time

import numpy as np
import pytest
import torch

from end2end_tpu_torch.models.pipeline import (ConformerCTCPipeline,
                                               PipelineConfig)
from end2end_tpu_torch.utils import native, profiling

CFG = PipelineConfig(vocab_size=12, d_model=32, num_layers=1, num_heads=2,
                     n_mels=16)


def test_trace_holds_the_decodes_ops(tmp_path):
    pipe = ConformerCTCPipeline(CFG, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    wav = np.random.default_rng(0).standard_normal((2, 4000)).astype(
        np.float32)
    with profiling.trace(str(tmp_path)):
        pipe.decode(wav, np.array([4000, 3000]), beam_width=4)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    for op in ("aten::_fft_r2c", "aten::linear", "aten::log_softmax"):
        assert op in names, op
    assert sum(n.startswith("aten::") for n in names) > 20


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is missing")
def test_log_compiles_logs_the_host_runtime_build(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="end2end_tpu_torch"):
        native.build(tmp_path)  # outside the block: not logged
        assert not caplog.records
        with profiling.log_compiles():
            path = native.build(tmp_path / "fresh")
            native.build(tmp_path / "fresh")
            with profiling.log_compiles(False):
                native.build(tmp_path / "fresh")
    msgs = [r.getMessage() for r in caplog.records]
    name = path.rsplit("/", 1)[1]
    assert len(msgs) == 2, msgs
    assert msgs[0].startswith(f"built {name} in ")
    assert msgs[1].startswith(f"found in the cache: {name} in ")
    assert all(r.name == "end2end_tpu_torch" for r in caplog.records)


def test_throughput_numbers_are_consistent():
    meter = profiling.Throughput(units_per_iter=8)
    time.sleep(0.05)
    out = meter.stop(10)
    assert out["seconds"] >= 0.05
    np.testing.assert_allclose(out["iters_per_s"], 10 / out["seconds"])
    np.testing.assert_allclose(out["units_per_s"], 8 * out["iters_per_s"])

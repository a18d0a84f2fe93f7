"""The control: the reference in the port's place in TF32, the precision
below the configurations' float32.  At a tiny size on the CPU (operands
rounded to TF32) it reads at least ten times what the port does (the
limits are set for the cells' sizes, where TF32's error is larger); at the
cell's own size on the card it fails the cell's limits."""

import json

import pytest
import torch

from e2e_bench import calibrate, harness
from e2e_bench.tests import tiny


def _readings(c, seed, dev):
    if c.entry.KIND == "train":
        return calibrate.train(c, seed, dev, True)
    return calibrate.serve(c, seed, dev, True, 4)


def _fails(numbers, limits):
    return any(not v <= limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_at_a_tiny_size(name):
    c = tiny.cell(name)
    r = _readings(c, 11, torch.device("cpu"))
    sound = max(r["program"].values())
    assert max(r["control"].values()) >= 10 * sound
    assert not _fails(r["program"], c.limits)
    for fault in ("half_batch", "unchanged", "token_altered", "outranked"):
        if fault in r:
            assert _fails(r[fault], c.limits), fault


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_at_the_cells_size(name, cuda_device):
    c = harness.load_cell(tiny.ROOT, name)
    harness.apply_precision(c.cfg)
    r = _readings(c, 20261018, cuda_device)
    assert not _fails(r["program"], c.limits), json.dumps(r)
    assert _fails(r["control"], c.limits), json.dumps(r)

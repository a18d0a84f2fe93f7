"""No process of the benchmark loads JAX or the JAX package: the check
compares whole top-level names, and a run's modules pass it."""

import subprocess
import sys

from e2e_bench.run import forbidden_modules
from e2e_bench.tests.tiny import ROOT


def test_whole_top_level_names():
    assert forbidden_modules(["end2end_tpu_torch", "end2end_tpu_torch.ops",
                              "jaxtyping", "flax_like", "numpy"]) == []
    assert forbidden_modules(["end2end_tpu.ops", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["end2end_tpu", "flax",
                                                 "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        "from e2e_bench import calibrate, harness, repeat, run\n"
        "from e2e_bench.tests import tiny\n"
        "for name in tiny.CELLS:\n"
        "    tiny.run(tiny.cell(name), seconds=0.2)\n"
        "print(run.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

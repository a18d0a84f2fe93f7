"""Smoke-run the port's examples (`end2end_tpu_torch/examples/`), each the
twin of one of the JAX package's `examples/*.py`, as a subprocess on the
CPU (`E2E_DEMO_DEVICE=cpu`) with tests/test_examples.py's step counts
(`E2E_DEMO_STEPS`); serving_demo keeps its 15 steps, since it asserts that
its MWER objective decreases.  And an `ast` check that no example imports
jax, flax, optax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "end2end_tpu_torch" / "examples"

_CASES = [  # module, its env, a line its run must print
    ("alignment_demo", {}, "aligning 'cat'"),
    ("asr_demo", {"E2E_DEMO_STEPS": "25"},
     "checkpoint restore reproduces the greedy decode exactly"),
    ("ocr_demo", {"E2E_DEMO_STEPS": "25"}, "target | beam-10 best"),
    ("lm_decode_demo", {"E2E_DEMO_STEPS": "25"},
     "beam-8 + trained GRU fusion"),
    ("serving_demo", {}, "MWER fine-tune: expected word errors"),
]


@pytest.mark.parametrize("module,env,expect", _CASES,
                         ids=[c[0] for c in _CASES])
def test_example_runs(module, env, expect):
    full_env = dict(os.environ, E2E_DEMO_DEVICE="cpu", OMP_NUM_THREADS="2",
                    **env)
    proc = subprocess.run(
        [sys.executable, "-m", f"end2end_tpu_torch.examples.{module}"],
        capture_output=True, text=True, timeout=300, env=full_env, cwd=ROOT)
    assert proc.returncode == 0, (
        f"{module} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-4000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}")
    assert expect in proc.stdout


def test_every_jax_example_has_a_twin():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*_demo.py")}
    assert jax_examples == {c[0] for c in _CASES}
    assert jax_examples <= {p.stem for p in EXAMPLES.glob("*_demo.py")}


def test_examples_import_no_jax():
    for path in sorted(EXAMPLES.glob("*.py")):
        tree = ast.parse(path.read_text())
        mods = [a.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names]
        mods += [node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module]
        for mod in mods:
            assert mod.split(".")[0] not in (
                "jax", "jaxlib", "flax", "optax", "end2end_tpu"), (
                f"{path.name} imports {mod}")

"""The benchmark of `end2end_tpu_torch`, the PyTorch and CUDA port, on an
NVIDIA H100.  It never loads JAX or the JAX package.

    python3 e2e_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of `BENCHMARK.json` once (see `run.py`); `repeat.py` runs a
cell several times and prints the spreads the bounds are set from, and
`calibrate.py` the readings the correctness limits are set from.  What
belongs to one configuration, traffic mix, timed entry or metric is a
file of its own under `configs/`, `traffic/`, `entries/`, `limits/` and
`metrics/` (`harness.py` finds them by name); `reference/` is the plain
reference the port is held to; `programs.py` is the only module that
imports the port.  CPU tests: `python -m pytest e2e_bench/tests`; the
ones marked `cuda` run on the card.
"""

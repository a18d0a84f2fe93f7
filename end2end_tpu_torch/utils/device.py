"""The port's default device: the card.

Entry points that build state (the encoder, the pipeline, the LMs' tables)
take `device=`; left as None it means CUDA.  Without a CUDA device they
raise instead of quietly building on the CPU: a caller who wants the CPU
(the tests, a CPU-only machine) says so with `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; raises when CUDA is asked for
    implicitly and there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to build on the CPU")
    return torch.device("cuda")

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
    implicitly and there is no CUDA device.  A CUDA device without an
    index gets the current one, as a tensor placed there reports it, so
    the LMs' `device` compares equal to their lattices'."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to build on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device

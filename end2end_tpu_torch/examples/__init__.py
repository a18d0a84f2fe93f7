"""Runnable examples of the port, one for each of the JAX package's
`examples/*.py`, with the same seeded synthetic data and stages:

    python -m end2end_tpu_torch.examples.asr_demo         # on the card
    E2E_DEMO_DEVICE=cpu python -m end2end_tpu_torch.examples.asr_demo

`E2E_DEMO_DEVICE` picks the device (the card when unset) and
`E2E_DEMO_STEPS` the number of training steps.
"""

from __future__ import annotations

import os

import torch

from ..utils.device import resolve_device


def demo_device() -> torch.device:
    """`E2E_DEMO_DEVICE`, or the card."""
    return resolve_device(os.environ.get("E2E_DEMO_DEVICE") or None)


def demo_steps(default: int) -> int:
    """`E2E_DEMO_STEPS`, or the example's own count."""
    return int(os.environ.get("E2E_DEMO_STEPS", default))


def adamw_cosine(params, lr: float, n_steps: int):
    """AdamW with a cosine decay from `lr` to 0 over `n_steps`: the
    optimizer and schedule of the JAX examples (`optax.adamw` of
    `optax.cosine_decay_schedule`, weight decay 1e-4)."""
    opt = torch.optim.AdamW(params, lr=lr, weight_decay=1e-4)
    return opt, torch.optim.lr_scheduler.CosineAnnealingLR(opt, n_steps)

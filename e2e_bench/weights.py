"""Weights drawn on the device from the run seed, in a few large calls.

A model's weights are listed by its reference (`reference.ctc.spec`,
`reference.transducer.spec`) as (name, shape, init); every 'normal'
weight is a slice of one `torch.randn` on the device, scaled by its
standard deviation.  The same dict is loaded into the port
(`load_state_dict`) and handed to the reference.
"""

from __future__ import annotations

import math

import torch


def draw(spec, seed: int, device, shaping: dict | None = None) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, init in spec
             if init[0] == "normal"]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = z[off:off + n].view(shape) * init[1]
            off += n
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    if shaping:
        shape_output(out, shaping)
    return out


def shape_output(w: dict, shaping: dict) -> None:
    """A serving mix's stand-in for training: the output layer scaled by
    `out_scale`, so that a seeded model's posteriors are peaked, as a
    trained model's are."""
    w["encoder.out.weight"] *= shaping["out_scale"]


def check_layout(state_dict: dict, spec) -> None:
    """The port's state dict holds exactly the spec's names and shapes."""
    want = {name: tuple(shape) for name, shape, _ in spec}
    have = {k: tuple(v.shape) for k, v in state_dict.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        wrong = sorted(k for k in set(want) & set(have)
                       if want[k] != have[k])[:5]
        raise ValueError(f"weight layout differs from the port's: missing "
                         f"{missing}, extra {extra}, shapes differ {wrong}")

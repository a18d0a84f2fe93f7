"""The transducer predictor's GRU over a whole target sequence: one launch
of `csrc/gru_seq.cu`'s forward recurrence and one of its backward.

Replaces no Pallas kernel: the JAX package runs the predictor's U steps as
a `lax.scan` of `gru_step` (`end2end_tpu/models/transducer.py::
ConformerTransducer._pred_states` :101-112), one device loop, where the port's plain path
(`ops/rnnt_decode._prefix_states`) drives the same steps from the host,
~4,900 small launches and ~1,344 autograd nodes a training step at the
benchmark's batches.  What bounds the kernels on the H100: 2U grid-wide
barriers a direction (each step needs all of h_t, then all of r * h_t; the
backward all of the candidate's gradient, then all of the gates'), and
3 N H^2 float32 FMAs a step on CUDA cores (no TF32: the models are
float32).  What the design does about that: one persistent cooperative
launch a direction, every block resident, each keeping its slice of the
three hidden-side weights in shared memory for all U steps, so a step
costs its two barriers and its FMAs and no launch; the blocks split the
rows into two groups of twice the units where those fit (`gru_plan`), so
each stages half the rows from L2 a phase and reads each staged row into
twice the sums.  Sums run in another order than cuBLAS's: the results agree with
the plain twins (`ops/neural_lm.gru_seq_forward_plain`,
`gru_seq_backward_plain`) to float32 rounding.

`gru_forward` and `gru_backward` take CUDA float32 tensors and raise on
anything else, or on an H the plan cannot hold in shared memory; nothing
falls back.  `launches` counts their launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cuda_build

launches = {"gru_forward": 0, "gru_backward": 0}

THREADS = 256
UNIT_PLANS = (1, 2, 4, 5, 8, 10, 16)  # the kernels' instantiations
ROWS_TILE_MAX = 32


class GruPlan(NamedTuple):
    units: int      # output units a block (a template instantiation)
    slices: int     # ceil(H / units)
    groups: int     # row groups; slices * groups blocks, one an SM
    rows_tile: int  # rows staged in shared memory at a time (even)
    smem_fwd: int   # shared bytes of the forward kernel
    smem_bwd: int   # of the backward kernel


def _units(at_least: int) -> int | None:
    return next((u for u in UNIT_PLANS if u >= at_least), None)


def gru_plan(n: int, h: int, sms: int, smem: int) -> GruPlan:
    """The launch plan of N rows of H units on `sms` SMs of `smem` shared
    bytes a block: the fewest units a block with which every block is
    resident, then two row groups of twice the units where those fit (on
    the H100 at H = 640 against one group: 14-34% less time in each
    direction at N = 28-200; at N = 11, U = 158 the forward 0.7% more, the
    backward 8.5% less).  Raises if the weights' slices and two rows leave
    no room in shared memory."""
    units = _units(-(-h // sms))
    if units is None:
        raise ValueError(f"gru_cuda: H = {h} needs more than "
                         f"{UNIT_PLANS[-1]} units a block on {sms} SMs")
    groups = 1
    wide = _units(2 * units)
    if wide is not None and 2 * -(-h // wide) <= sms:
        units, groups = wide, 2
    weights = 3 * units * h * 4
    rows = (smem - weights) // (2 * h * 4) // 2 * 2
    if rows < 2:
        raise ValueError(f"gru_cuda: H = {h} does not fit shared memory "
                         f"({weights} bytes of weights a block)")
    per_group = -(-n // groups)
    rows = min(rows, ROWS_TILE_MAX, (per_group + 1) // 2 * 2)
    return GruPlan(units, -(-h // units), groups, rows,
                   weights + rows * h * 4, weights + 2 * rows * h * 4)


def _check(what, tensors, shapes):
    for name, x in tensors.items():
        if not x.is_cuda or x.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be CUDA float32, got "
                             f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must be {shapes[name]}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if x.device != tensors["wz_h"].device:
            raise ValueError(f"{what}: {name} is on {x.device}, the "
                             f"weights on {tensors['wz_h'].device}")


def _plan(dev, n, h):
    props = torch.cuda.get_device_properties(dev)
    return gru_plan(n, h, props.multi_processor_count,
                    props.shared_memory_per_block_optin)


def _run(name, args, plan, smem, dev):
    lib, _ = cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, name)(
            *(x.data_ptr() for x in args[:-3]), *args[-3:], plan.units,
            plan.slices, plan.groups, plan.rows_tile, THREADS, smem, stream)
    cuda_build.check(status, name)


def gru_forward(gx, wz_h, wr_h, wh_h, h0):
    """The forward recurrence: gx (N, U, 3H), the x-side terms and biases
    of every step; the hidden-side weights (H, H); h0 (H,).  Returns the
    states (N, U+1, H) and the tape (N, U, 4H) of z, r, c and r * h."""
    n, u, h3 = gx.shape
    h = h3 // 3
    _check("gru_forward", {"gx": gx, "wz_h": wz_h, "wr_h": wr_h,
                           "wh_h": wh_h, "h0": h0},
           {"gx": (n, u, 3 * h), "wz_h": (h, h), "wr_h": (h, h),
            "wh_h": (h, h), "h0": (h,)})
    if n < 1 or u < 1 or h3 != 3 * h or h < 1:
        raise ValueError(f"gru_forward: needs N, U >= 1 and 3H columns, "
                         f"got gx {tuple(gx.shape)}")
    dev = gx.device
    plan = _plan(dev, n, h)
    states = torch.empty((n, u + 1, h), dtype=torch.float32, device=dev)
    tape = torch.empty((n, u, 4 * h), dtype=torch.float32, device=dev)
    bar = torch.empty((plan.slices * plan.groups,), dtype=torch.int32,
                      device=dev)
    _run("e2e_gru_seq_fwd",
         (gx, wz_h, wr_h, wh_h, h0, states, tape, bar, n, u, h), plan,
         plan.smem_fwd, dev)
    launches["gru_forward"] += 1
    return states, tape


def gru_backward(d_states, states, tape, wz_h, wr_h, wh_h):
    """The backward recurrence from the states' cotangent d_states
    (N, U+1, H) and the forward's states and tape.  Returns the gradients
    of the pre-activations dgx (N, U, 3H) (z, r, candidate) and of each
    row's h_0 (N, H)."""
    n, u1, h = states.shape
    u = u1 - 1
    _check("gru_backward", {"d_states": d_states, "states": states,
                            "tape": tape, "wz_h": wz_h, "wr_h": wr_h,
                            "wh_h": wh_h},
           {"d_states": (n, u1, h), "states": (n, u1, h),
            "tape": (n, u, 4 * h), "wz_h": (h, h), "wr_h": (h, h),
            "wh_h": (h, h)})
    if n < 1 or u < 1 or h < 1:
        raise ValueError(f"gru_backward: needs N, U >= 1, got states "
                         f"{tuple(states.shape)}")
    dev = states.device
    plan = _plan(dev, n, h)
    dgx = torch.empty((n, u, 3 * h), dtype=torch.float32, device=dev)
    dh0 = torch.empty((n, h), dtype=torch.float32, device=dev)
    bar = torch.empty((plan.slices * plan.groups,), dtype=torch.int32,
                      device=dev)
    _run("e2e_gru_seq_bwd",
         (states, tape, d_states, wz_h, wr_h, wh_h, dgx, dh0, bar, n, u, h),
         plan, plan.smem_bwd, dev)
    launches["gru_backward"] += 1
    return dgx, dh0

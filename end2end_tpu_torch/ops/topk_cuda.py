"""Exact top-k over the vocabulary: the beam decoder's candidate prune.

Port of `end2end_tpu/ops/topk_pallas.py`.  `topk(x, k)` returns the k largest
entries of the last axis, values descending and equal values by ascending
index (jax.lax.top_k's order; -0.0 equals +0.0).  On a CUDA tensor it
launches the hand-written kernel in `csrc/topk.cu` with `topk_plan`'s
launch; on a CPU tensor it runs `topk_plain`.  `sort_key` is the kernel's
ordering of (value, index) pairs in Python.

`launches` counts kernel launches (it is the only module state).
"""

from __future__ import annotations

import struct

import torch

from ..utils import cuda_build

launches = 0

MAX_SORT_V = 32  # widest row of the sort path (one value a lane)
MAX_LIST = 256  # longest list of the select path; past it, the rounds


def topk_plan(v: int, k: int) -> dict:
    """K3's launch for rows of V values and k picks (csrc/topk.cu's paths):

    * "sort" (V <= 32): a row is a segment of `segment` lanes (the power of
      two >= V), `rows_per_warp` = 32 / segment rows a warp, one bitonic
      sort;
    * "select" (V > 32, k <= 256): a warp a row streamed in 128-value
      chunks into a sorted list of `list` = 32 * 2^m >= k composites;
    * "rounds" (k > 256): the replaced kernel's k rounds, a warp a row.

    `segment` and `list` are what the C entry takes (0 where unused).
    """
    if not 1 <= k <= v:
        raise ValueError(f"need 1 <= k <= V, got k={k}, V={v}")
    if v <= MAX_SORT_V:
        segment = 1 << (v - 1).bit_length()
        return {"path": "sort", "segment": segment, "list": 0,
                "rows_per_warp": 32 // segment, "warps": 4}
    if k <= MAX_LIST:
        lst = 32 << (-(-k // 32) - 1).bit_length()
        return {"path": "select", "segment": 0, "list": lst,
                "rows_per_warp": 1, "warps": 4}
    return {"path": "rounds", "segment": 0, "list": 0, "rows_per_warp": 1,
            "warps": 8}


def sort_key(value: float, index: int) -> int:
    """The kernel's composite of (float32 value, index) as an unsigned
    64-bit int: an order-preserving key of the value (-0.0 takes +0.0's)
    above the complement of the index, so a larger composite comes first
    in the output order and no two are equal."""
    u = struct.unpack("<I", struct.pack("<f", value))[0]
    if u == 0x80000000:  # -0.0
        u = 0
    key = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (key << 32) | (~index & 0xFFFFFFFF)


def topk_plain(x: torch.Tensor, k: int):
    """Plain version: a stable descending sort sliced to k (torch.topk does
    not promise the tie order).  Returns (values, int32 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def topk_cuda(x: torch.Tensor, k: int):
    """Launch the CUDA kernel on a CUDA float32 tensor (..., V) with
    `topk_plan`'s launch."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"topk_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"topk_cuda is float32-only, got {x.dtype}")
    v = x.shape[-1]
    plan = topk_plan(v, k)
    x = x.contiguous()
    rows = x.numel() // v
    vals = torch.empty((*x.shape[:-1], k), dtype=torch.float32,
                       device=x.device)
    idx = torch.empty((*x.shape[:-1], k), dtype=torch.int32, device=x.device)
    lib, _ = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.e2e_topk_f32(x.data_ptr(), vals.data_ptr(),
                                  idx.data_ptr(), rows, v, k,
                                  plan["segment"], plan["list"], stream)
    cuda_build.check(status, "e2e_topk_f32")
    launches += 1
    return vals, idx


def topk(x: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest entries of the last axis:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.is_cuda:
        return topk_cuda(x, k)
    if x.device.type != "cpu":
        raise ValueError(f"topk: unsupported device {x.device}")
    return topk_plain(x, k)

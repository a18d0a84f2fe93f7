"""Row-wise indexing helpers of the LM decode (torch port of
`end2end_tpu/ops/indexing.py`).

The JAX module routes around slow TPU gather forms; here both helpers are
plain torch: `flat_take` is a `gather` and `compact_rows` a stable sort on
a validity key.  `ladder_take` (a compare-select ladder that exists only
because of the TPU's gather cost) is not ported: its callers use `gather`.
"""

from __future__ import annotations

import torch


def flat_take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`take_along_axis(arr, idx, axis=-1)`: arr (..., C), idx (..., K)
    with 0 <= idx < C."""
    return arr.gather(-1, idx.long())


def compact_rows(vals: torch.Tensor, fill=-1, valid=None) -> torch.Tensor:
    """Left-justify each row's valid entries, keeping their order; the rest
    become `fill`.  Entries equal to `fill` are invalid unless `valid` (a
    bool mask of vals' shape) says otherwise."""
    if valid is None:
        valid = vals != fill
    key = (~valid).to(torch.int8)
    order = torch.sort(key, dim=-1, stable=True).indices
    out = torch.where(valid, vals, torch.as_tensor(fill, dtype=vals.dtype))
    return out.gather(-1, order)

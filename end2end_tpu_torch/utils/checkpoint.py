"""Checkpoint / resume for the port's models and training loops (torch port
of `end2end_tpu/utils/checkpoint.py`).

The loss and decoder functions are stateless; the models in `models/` and
their optimizers are not.  A state is any nesting of dicts, lists and
tuples whose leaves are tensors and Python scalars: what
`nn.Module.state_dict()` and `torch.optim.Optimizer.state_dict()` give.

    save_checkpoint(path, {"model": model.state_dict(),
                           "opt": opt.state_dict()})
    state = restore_checkpoint(path, like)   # like: the same structure

`save_checkpoint` writes with `torch.save` to a temporary file beside
`path` and renames it over `path`, so a reader never sees half a file and
an existing checkpoint is replaced.  `restore_checkpoint` reads with
`torch.load(weights_only=True)` and holds the result to `like`: the same
keys, lengths and container kinds, and for each tensor the same shape and
dtype, as the JAX package's restore holds it to `like`'s shapes and dtypes.
A mismatch raises and names the leaf's key path.  Each tensor is placed on
the device of `like`'s tensor.
"""

from __future__ import annotations

import os
import tempfile

import torch


def save_checkpoint(path: str, state) -> None:
    """Save `state` to `path` (overwriting it)."""
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def restore_checkpoint(path: str, like):
    """Restore a state saved by `save_checkpoint`; `like` supplies its
    structure, shapes, dtypes and devices (e.g. a freshly built model's
    `state_dict()`)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return _match(saved, like, "")


def _match(saved, like, key: str):
    where = key or "the root"
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint {where}: a tensor expected, got "
                             f"{type(saved).__name__}")
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(
                f"checkpoint {where}: {tuple(saved.shape)} {saved.dtype} "
                f"saved, {tuple(like.shape)} {like.dtype} expected")
        return saved.to(like.device)
    if isinstance(like, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint {where}: a dict expected, got "
                             f"{type(saved).__name__}")
        missing = [k for k in like if k not in saved]
        extra = [k for k in saved if k not in like]
        if missing or extra:
            raise ValueError(f"checkpoint {where}: keys missing {missing}, "
                             f"unexpected {extra}")
        out = type(like)((k, _match(saved[k], v, f"{key}/{k}"))
                         for k, v in like.items())
        if hasattr(like, "_metadata"):  # a state_dict's module versions
            out._metadata = like._metadata
        return out
    if isinstance(like, (list, tuple)):
        if type(saved) is not type(like) or len(saved) != len(like):
            raise ValueError(
                f"checkpoint {where}: a {type(like).__name__} of "
                f"{len(like)} expected, got {type(saved).__name__}"
                + (f" of {len(saved)}" if isinstance(saved, (list, tuple))
                   else ""))
        return type(like)(_match(s, l, f"{key}/{i}")
                          for i, (s, l) in enumerate(zip(saved, like)))
    if type(saved) is not type(like):
        raise ValueError(f"checkpoint {where}: a {type(like).__name__} "
                         f"expected, got {type(saved).__name__}")
    return saved

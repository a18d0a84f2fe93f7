"""The port's checkpointing (`end2end_tpu_torch/utils/checkpoint.py`): a
pipeline's `state_dict` and its AdamW state round-trip bit for bit and
reproduce the greedy decode (as tests/test_models.py::
test_checkpoint_save_restore does for the JAX params); a mismatch with
`like` raises and names the key; and JAX weights carried across, saved
and restored by the JAX package's orbax checkpoint, converted into the
port, saved and restored by the port's, decode as the JAX model does
(CPU)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from end2end_tpu.utils import checkpoint as jckpt
from end2end_tpu_torch import ConformerCTCPipeline, PipelineConfig
from end2end_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                save_checkpoint)

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

CFG = PipelineConfig(vocab_size=16, d_model=64, num_layers=2, num_heads=2,
                     n_mels=16)


def _pipe(seed):
    return ConformerCTCPipeline(CFG, device="cpu",
                                generator=torch.Generator().manual_seed(seed))


def _batch():
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((3, 4000)).astype(np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)
    tgt = torch.from_numpy(rng.integers(1, 16, (3, 4)).astype(np.int32))
    return wav, ns, tgt, torch.tensor([4, 3, 2], dtype=torch.int32)


def _step(pipe, opt, batch):
    opt.zero_grad()
    pipe.loss(*batch).backward()
    opt.step()


def _primed_adamw(pipe):
    """A fresh AdamW whose state exists (one zero-gradient step), the
    structure `like` needs: torch builds optimizer state lazily."""
    opt = torch.optim.AdamW(pipe.parameters(), lr=1e-3)
    for p in pipe.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    return opt


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_pipeline_and_adamw_round_trip(tmp_path):
    batch = _batch()
    pipe = _pipe(0)
    opt = torch.optim.AdamW(pipe.parameters(), lr=1e-3)
    for _ in range(2):
        _step(pipe, opt, batch)
    state = {"model": pipe.state_dict(), "opt": opt.state_dict()}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    save_checkpoint(path, state)  # overwrites

    fresh = _pipe(99)
    fresh_opt = _primed_adamw(fresh)
    restored = restore_checkpoint(path, {"model": fresh.state_dict(),
                                         "opt": fresh_opt.state_dict()})
    _assert_same(restored, state)
    fresh.load_state_dict(restored["model"])
    fresh_opt.load_state_dict(restored["opt"])
    wav, ns = batch[:2]
    for got, want in zip(fresh.decode(wav, ns), pipe.decode(wav, ns)):
        assert torch.equal(got, want)
    # training resumes exactly where it stopped
    _step(pipe, opt, batch)
    _step(fresh, fresh_opt, batch)
    for p, q in zip(pipe.parameters(), fresh.parameters()):
        assert torch.equal(p, q)


def test_mismatch_raises_and_names_the_key(tmp_path):
    pipe = _pipe(0)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, pipe.state_dict())
    like = _pipe(1).state_dict()
    key = "encoder.out.weight"
    wrong = dict(like, **{key: torch.zeros(3, 3)})
    with pytest.raises(ValueError, match=key):
        restore_checkpoint(path, wrong)
    with pytest.raises(ValueError, match=key):
        restore_checkpoint(path, dict(like, **{key: like[key].double()}))
    missing = dict(like, extra=torch.zeros(1))
    with pytest.raises(ValueError, match="extra"):
        restore_checkpoint(path, missing)
    del like[key]
    with pytest.raises(ValueError, match=key):
        restore_checkpoint(path, like)
    save_checkpoint(path, {"a": [torch.zeros(2), 1.5]})
    with pytest.raises(ValueError, match="/a/1"):
        restore_checkpoint(path, {"a": [torch.zeros(2), 1]})
    with pytest.raises(ValueError, match="/a"):
        restore_checkpoint(path, {"a": (torch.zeros(2), 1.5)})


def test_jax_weights_carried_across(tmp_path):
    jpipe = graft._tiny_pipeline()
    wav, ns = _batch()[:2]
    params = jpipe.init(jax.random.key(0), wav, ns)
    jckpt.save_checkpoint(str(tmp_path / "jax"), params)
    jparams = jax.device_get(jckpt.restore_checkpoint(
        str(tmp_path / "jax"), jpipe.init(jax.random.key(7), wav, ns)))

    carried = _pipe(3)
    carried.load_flax_params(jparams)
    save_checkpoint(str(tmp_path / "port"), carried.state_dict())
    tpipe = _pipe(4)
    tpipe.load_state_dict(restore_checkpoint(str(tmp_path / "port"),
                                             tpipe.state_dict()))
    for p, q in zip(tpipe.parameters(), carried.parameters()):
        assert torch.equal(p, q)
    # tests/test_torch_pipeline.py's tolerance against the JAX decode
    want = [np.asarray(x) for x in jpipe.decode(jparams, wav, ns)]
    got = [x.numpy() for x in tpipe.decode(wav, ns)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)

"""The training slice as a whole: the same waveforms, targets and weights
through the JAX `ConformerCTCPipeline.loss` (under `jax.value_and_grad`,
implementation='xla') and the torch port's `loss` + `backward()` on the CPU.

The loss must agree within rtol 1e-5; every parameter's gradient, mapped
from flax layout by `utils/convert.py`, within 1e-4 of that tensor's
largest gradient (float32 sums in other orders through the encoder's
backward), that scale floored at 1e-4: the attention key bias's gradient
is zero in exact arithmetic (softmax ignores a shift of all keys) and
both frameworks return rounding noise of ~1e-9 there.

One `torch.optim.AdamW(lr=1e-3, weight_decay=1e-4)` step on the same
gradients must match one `optax.adamw(1e-3)` step within 1e-5.  Adam's
first step is ~lr * sign(g), so on each framework's own gradients the
noise above becomes updates of ~2e-4 that differ; the whole train step is
instead held by the loss after it (rtol 1e-4).
"""

import jax
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from end2end_tpu_torch import ConformerCTCPipeline, PipelineConfig
from end2end_tpu_torch.utils.convert import conformer_state_dict_from_flax

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def setup():
    jpipe = graft._tiny_pipeline()
    rng = np.random.default_rng(3)
    wav = rng.standard_normal((3, 4000)).astype(np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)  # T' = 6, 5, 4
    tgt = rng.integers(1, 16, (3, 3)).astype(np.int32)
    tl = np.array([3, 2, 1], np.int32)
    params = jax.device_get(jpipe.init(jax.random.key(0), wav, ns))
    tpipe = ConformerCTCPipeline(PipelineConfig(
        vocab_size=16, d_model=64, num_layers=2, num_heads=2, n_mels=16),
        device="cpu")
    tpipe.load_flax_params(params)

    def jloss(p):
        return jpipe.loss(p, wav, ns, tgt, tl, implementation="xla")

    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    j_loss, j_grads = value_and_grad(params)
    return dict(value_and_grad=value_and_grad, params=params, tpipe=tpipe,
                batch=(wav, ns, tgt, tl), j_loss=float(j_loss),
                j_grads=jax.device_get(j_grads))


def _torch_grads(tpipe, batch):
    tpipe.zero_grad()
    loss = tpipe.loss(*batch)
    loss.backward()
    return loss, {k.removeprefix("encoder."): p.grad
                  for k, p in tpipe.named_parameters()}


def test_loss_and_gradients_match_jax(setup):
    loss, grads = _torch_grads(setup["tpipe"], setup["batch"])
    assert np.isfinite(loss.item()) and loss.item() > 0
    np.testing.assert_allclose(loss.item(), setup["j_loss"], rtol=1e-5)
    want = conformer_state_dict_from_flax(setup["j_grads"])
    assert set(want) == set(grads)
    for name, w in want.items():
        g = grads[name]
        assert g is not None, name
        scale = max(float(w.abs().max()), 1e-4)
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _adamw_step(setup, jax_grads: bool):
    """One torch AdamW step from the loaded weights, on JAX's gradients
    (mapped to torch layout) or on the port's own; returns the new
    state_dict and restores the weights."""
    tpipe = setup["tpipe"]
    start = {k: v.clone() for k, v in tpipe.encoder.state_dict().items()}
    try:
        opt = torch.optim.AdamW(tpipe.parameters(), lr=1e-3,
                                weight_decay=1e-4)
        if jax_grads:
            want = conformer_state_dict_from_flax(setup["j_grads"])
            for name, p in tpipe.encoder.named_parameters():
                p.grad = want[name].clone()
        else:
            _torch_grads(tpipe, setup["batch"])
        opt.step()
        return {k: v.clone() for k, v in tpipe.encoder.state_dict().items()}
    finally:
        tpipe.encoder.load_state_dict(start)


def _optax_step(setup):
    params = setup["params"]
    opt = optax.adamw(1e-3)
    updates, _ = opt.update(setup["j_grads"], opt.init(params), params)
    return optax.apply_updates(params, updates)


def test_adamw_step_matches_optax(setup):
    want = conformer_state_dict_from_flax(jax.device_get(_optax_step(setup)))
    got = _adamw_step(setup, jax_grads=True)
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_train_step_matches_jax(setup):
    """loss -> backward -> AdamW in each framework, then the loss again."""
    j_after, _ = setup["value_and_grad"](_optax_step(setup))
    tpipe = setup["tpipe"]
    start = {k: v.clone() for k, v in tpipe.encoder.state_dict().items()}
    try:
        tpipe.encoder.load_state_dict(_adamw_step(setup, jax_grads=False))
        with torch.no_grad():
            t_after = tpipe.loss(*setup["batch"]).item()
    finally:
        tpipe.encoder.load_state_dict(start)
    assert t_after < setup["j_loss"]
    np.testing.assert_allclose(t_after, float(j_after), rtol=1e-4)

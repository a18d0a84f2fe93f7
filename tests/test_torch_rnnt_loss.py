"""The port's plain transducer loss (ops/rnnt_loss.py on the CPU) against
the JAX package: its XLA scan, its Pallas wavefront kernels K8/K9 (run in
interpret mode here, as the JAX package's own tests run them) and the
float64 oracle `utils/rnnt_reference.py`.

Tolerances: NLL rtol 1e-5 / atol 1e-4 and logits gradients atol 2e-5
against JAX (libm exp/log1p in place of JAX's float32 polynomials, and
softmax sums in another order); atol 1e-4 against the float64 oracle, the
family's budget; plane gradients atol 1e-6 (the same DP on the same
planes); the fused joint rtol 1e-5 and gradients atol 2e-5 against JAX's,
and within 3e-4 of the materialised joint (JAX's own contract).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import fastmath
from end2end_tpu.ops import rnnt_loss as jrnnt
from end2end_tpu.utils.rnnt_reference import rnnt_logits_grad_ref
from end2end_tpu_torch import (RNNTLoss, fused_additive_joint, rnnt_loss,
                               rnnt_loss_fused, rnnt_nll,
                               rnnt_nll_from_planes, rnnt_nll_fused)
from end2end_tpu_torch.ops.semiring import round_to_half

torch.set_num_threads(1)

# name: (seed, n, t, u, v, blank, input lengths, target lengths)
CASES = {
    # U > T (sample 1), an empty target (sample 2), il < T
    "mixed": (0, 5, 9, 7, 17, 0, [9, 3, 9, 5, 2], [7, 7, 0, 3, 1]),
    "long_t": (1, 4, 30, 5, 8, 0, [30, 17, 26, 2], [5, 2, 4, 1]),
    "blank_last": (2, 3, 6, 3, 7, 6, [6, 6, 4], [3, 1, 2]),
}


@functools.cache
def problem(name):
    seed, n, t, u, v, blank, il, ul = CASES[name]
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, t, u + 1, v)) * 2.0).astype(np.float32)
    lo, hi = (1, v) if blank == 0 else (0, v - 1)
    targets = rng.integers(lo, hi, (n, u)).astype(np.int32)
    return (logits, targets, np.array(il, np.int32), np.array(ul, np.int32),
            blank)


def torch_nll_grad(x, targets, il, ul, blank, dtype=torch.float32, **kw):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    nll = rnnt_nll(xt, targets, il, ul, blank=blank, **kw)
    nll.sum().backward()
    return nll.detach().numpy(), xt.grad.numpy()


@functools.cache
def torch_result(name):
    return torch_nll_grad(*problem(name))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name, impl):
    logits, targets, il, ul, blank = problem(name)

    def total(x):
        nll = jrnnt.rnnt_nll(x, targets, il, ul, blank=blank,
                             implementation=impl)
        return jnp.sum(nll), nll

    (_, j_nll), j_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(logits))
    nll, grad = torch_result(name)
    np.testing.assert_allclose(nll, np.asarray(j_nll), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_f64_oracle(name):
    logits, targets, il, ul, blank = problem(name)
    ref_nll, ref_grad = rnnt_logits_grad_ref(logits, targets, il, ul, blank)
    nll, grad = torch_result(name)
    np.testing.assert_allclose(nll, ref_nll, rtol=4e-6, atol=1e-4)
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-4)
    nll64, grad64 = torch_nll_grad(logits, targets, il, ul, blank,
                                   dtype=torch.float64)
    np.testing.assert_allclose(nll64, ref_nll, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(grad64, ref_grad, rtol=0, atol=1e-10)


def test_from_log_probs_matches_jax():
    logits, targets, il, ul, blank = problem("mixed")
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))

    def total(x):
        nll = jrnnt.rnnt_nll(x, targets, il, ul, from_logits=False,
                             implementation="xla")
        return jnp.sum(nll), nll

    (_, j_nll), j_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(lp))
    nll, grad = torch_nll_grad(lp, targets, il, ul, blank, from_logits=False)
    np.testing.assert_allclose(nll, np.asarray(j_nll), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=0, atol=2e-5)


def test_from_planes_matches_jax():
    logits, targets, il, ul, _ = problem("long_t")
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    y = np.concatenate([targets, np.zeros((len(il), 1), np.int32)], 1)
    b_pl = lp[..., 0]
    l_pl = np.take_along_axis(lp, y[:, None, :, None], -1)[..., 0]

    def total(bp, lq):
        nll = jrnnt.rnnt_nll_from_planes(bp, lq, il, ul, implementation="xla")
        return jnp.sum(nll), nll

    (_, j_nll), j_grads = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(jnp.asarray(b_pl),
                                              jnp.asarray(l_pl))
    bt = torch.tensor(b_pl, requires_grad=True)
    lt = torch.tensor(l_pl, requires_grad=True)
    nll = rnnt_nll_from_planes(bt, lt, il, ul)
    nll.sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(j_nll),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(j_grads[0]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(j_grads[1]),
                               rtol=0, atol=1e-6)


def test_reductions_and_module():
    logits, targets, il, ul, blank = problem("mixed")
    nll = torch_result("mixed")[0]
    x = torch.tensor(logits)
    for reduction, want in (("none", nll), ("sum", nll.sum()),
                            ("mean", nll.mean())):
        got = rnnt_loss(x, targets, il, ul, reduction=reduction).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        mod = RNNTLoss(blank=blank, reduction=reduction)
        np.testing.assert_allclose(mod(x, targets, il, ul).numpy(), want,
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        rnnt_loss(x, targets, il, ul, reduction="avg")


@pytest.mark.parametrize("name", list(CASES))
def test_no_gradient_reaches_padded_frames(name):
    """The encoder on the card returns padded frames as zeros that take no
    gradient (models/conformer.py's packing), which is the padded
    encoder's mathematics only if the loss sends them none: the logits'
    gradient at every frame t >= the sample's length is exactly zero."""
    _, _, il, _, _ = problem(name)
    grad = torch_result(name)[1]
    for n, t in enumerate(il):
        assert grad[n, :t].any() and not grad[n, t:].any(), n


def test_implementation_routing():
    logits, targets, il, ul, _ = problem("mixed")
    x = torch.tensor(logits)
    auto = rnnt_nll(x, targets, il, ul)
    assert torch.equal(auto, rnnt_nll(x, targets, il, ul,
                                      implementation="xla"))
    with pytest.raises(ValueError, match="pallas"):
        rnnt_nll(x, targets, il, ul, implementation="pallas")
    with pytest.raises(ValueError, match="pallas"):
        rnnt_nll(x.double(), targets, il, ul, implementation="pallas")
    with pytest.raises(ValueError, match="implementation"):
        rnnt_nll(x, targets, il, ul, implementation="cuda")
    with pytest.raises(ValueError, match="U\\+1"):
        rnnt_nll(x[:, :, :3], targets, il, ul)


def test_round_to_half_matches_jax():
    x = np.array([0.25, 0.75, -0.25, -0.75, 1.25, 2.74, -3.5e3, 0.0],
                 np.float32)
    np.testing.assert_array_equal(round_to_half(torch.tensor(x)).numpy(),
                                  np.asarray(fastmath.round_to_half(x)))


def _fused_setup(seed, n=3, t=11, u=5, v=7, j=6):
    """tests/test_rnnt_fused.py's problem."""
    rng = np.random.default_rng(seed)
    enc_p = rng.normal(size=(n, t, j)).astype(np.float32)
    pred_p = rng.normal(size=(n, u + 1, j)).astype(np.float32)
    w_out = (rng.normal(size=(j, v)) / np.sqrt(j)).astype(np.float32)
    b_out = (0.1 * rng.normal(size=(v,))).astype(np.float32)
    tgt = rng.integers(1, v, (n, u)).astype(np.int32)
    il = np.array([t, t - 3, t - 1], np.int32)[:n]
    ul = np.array([u, 2, 0], np.int32)[:n]
    return (enc_p, pred_p, w_out, b_out), tgt, il, ul


def _torch_fused(arrays, tgt, il, ul, chunk_t, materialised=False):
    e, p, w, b = (torch.tensor(a, requires_grad=True) for a in arrays)
    if materialised:
        logits = torch.tanh(e[:, :, None] + p[:, None]) @ w + b
        nll = rnnt_nll(logits, tgt, il, ul)
    else:
        nll = rnnt_nll_fused(e, p, fused_additive_joint(w, b), tgt, il, ul,
                             chunk_t=chunk_t)
    nll.sum().backward()
    return nll.detach().numpy(), [x.grad.numpy() for x in (e, p, w, b)]


@pytest.mark.parametrize("chunk_t", [2, 64])
def test_fused_matches_jax(chunk_t):
    arrays, tgt, il, ul = _fused_setup(1)

    def total(e, p, w, b):
        nll = jrnnt.rnnt_nll_fused(e, p, jrnnt.fused_additive_joint(w, b),
                                   tgt, il, ul, chunk_t=chunk_t,
                                   implementation="xla")
        return jnp.sum(nll), nll

    (_, j_nll), j_grads = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1, 2, 3), has_aux=True))(
            *(jnp.asarray(a) for a in arrays))
    nll, grads = _torch_fused(arrays, tgt, il, ul, chunk_t)
    np.testing.assert_allclose(nll, np.asarray(j_nll), rtol=1e-5, atol=1e-4)
    for g, jg, name in zip(grads, j_grads, ("enc_proj", "pred_proj",
                                            "w_out", "b_out")):
        np.testing.assert_allclose(g, np.asarray(jg), rtol=0, atol=2e-5,
                                   err_msg=name)


def test_fused_equals_materialised():
    arrays, tgt, il, ul = _fused_setup(0)
    want, want_g = _torch_fused(arrays, tgt, il, ul, 0, materialised=True)
    for chunk_t in (1, 4, 11):
        got, got_g = _torch_fused(arrays, tgt, il, ul, chunk_t)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g, w, rtol=0, atol=3e-4)
    e, p, w, b = (torch.tensor(a) for a in arrays)
    for reduction, value in (("sum", want.sum()), ("mean", want.mean())):
        np.testing.assert_allclose(
            rnnt_loss_fused(e, p, fused_additive_joint(w, b), tgt, il, ul,
                            chunk_t=4, reduction=reduction).numpy(),
            value, rtol=0, atol=3e-4)


def test_fused_bfloat16_joint():
    """bfloat16 joint operands: logits move by O(1e-2), so the loss stays
    within 2% of the float32 joint's and the gradient keeps its
    direction (cosine > 0.99), as tests/test_rnnt_fused.py holds JAX's."""
    arrays, tgt, il, ul = _fused_setup(3)
    e, p, w, b = (torch.tensor(a, requires_grad=True) for a in arrays)
    out = {}
    for md in (None, "bfloat16"):
        w.grad = None
        nll = rnnt_nll_fused(e, p, fused_additive_joint(w, b, matmul_dtype=md),
                             tgt, il, ul, chunk_t=4)
        nll.sum().backward()
        out[md] = (nll.detach(), w.grad.clone())
    (l32, g32), (l16, g16) = out[None], out["bfloat16"]
    assert torch.allclose(l16, l32, rtol=2e-2)
    cos = torch.nn.functional.cosine_similarity(g16.flatten(), g32.flatten(),
                                                dim=0)
    assert cos > 0.99

"""The CTC loss of the torch port (plain scans, CPU) against the JAX package.

The same numpy inputs go through the port's `ctc_loss` and JAX's
`ctc_nll_xla`, `ctc_nll_pallas` (interpret mode, as the JAX tests run it
on the CPU), `utils/reference_impl.py` (float64 NumPy oracle) and
`torch.nn.functional.ctc_loss`.  Tolerances:
  * vs ctc_nll_xla and torch: losses rtol 1e-5 / atol 1e-4, gradients
    rtol 1e-4 / atol 1e-4 (the JAX package's own tolerance against torch:
    float32 sums in other orders, libm exp/log1p vs its polynomials);
  * vs the interpret-mode Pallas kernels: their tolerance against the XLA
    scan (losses rtol 1e-6 / atol 1e-5, gradients rtol 1e-5 / atol 1e-6);
  * float64 vs the NumPy oracle: 1e-8 (both float64);
  * checkpoint modes, 'auto' vs 'xla', and the gather vs the JAX one-hot
    form: bit-equal.
The full-config cases carry `tests/test_full_configs.py`'s float64-truth
criterion, which decides that libm exp/log1p are accurate enough (the JAX
package's fastmath polynomials are not ported).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu import ctc_loss as jax_ctc_loss
from end2end_tpu.ops import ctc_common as jcommon
from end2end_tpu.ops.ctc_loss_pallas import ctc_nll_pallas
from end2end_tpu.ops.ctc_loss_xla import ctc_nll_xla
from end2end_tpu.utils.reference_impl import ctc_loss_ref
from end2end_tpu_torch import CTCLoss, ctc_loss, ctc_loss_jit, ctc_nll
from end2end_tpu_torch.ops import ctc_common, ctc_loss_cuda
from end2end_tpu_torch.tools import ctc_alpha_breakdown, ctc_beta_breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import patched
from end2end_tpu_torch.utils import cuda_build
from tests.conftest import random_ctc_problem

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def port_loss_grad(lp, tgt, il, tl, blank=0, dtype=torch.float32, **kw):
    """Per-sample loss and d(sum loss)/d lp through the port's ctc_loss."""
    x = torch.tensor(np.asarray(lp), dtype=dtype, requires_grad=True)
    kw.setdefault("reduction", "none")
    loss = ctc_loss(x, torch.tensor(np.asarray(tgt)), torch.tensor(il),
                    torch.tensor(tl), blank=blank, **kw)
    (loss.sum() if loss.ndim else loss).backward()
    return loss.detach().numpy(), x.grad.numpy()


def torch_loss_grad(lp, tgt, il, tl, blank=0, reduction="none",
                    zero_infinity=False):
    x = torch.tensor(lp, requires_grad=True)
    loss = torch.nn.functional.ctc_loss(
        x, torch.tensor(tgt).long(), torch.tensor(il).long(),
        torch.tensor(tl).long(), blank=blank, reduction=reduction,
        zero_infinity=zero_infinity)
    (loss.sum() if loss.ndim else loss).backward()
    return loss.detach().numpy(), x.grad.numpy()


def jax_loss_grad(fn, lp):
    f = jax.jit(lambda x: (fn(x), jax.grad(lambda y: jnp.sum(fn(y)))(x)))
    return tuple(np.asarray(a) for a in f(jnp.asarray(lp)))


@pytest.mark.parametrize("B,T,S,V,blank", [(3, 20, 6, 12, 0),
                                           (5, 37, 7, 11, 0),
                                           (4, 64, 12, 29, 3)])
def test_plain_matches_jax_xla(rng, B, T, S, V, blank):
    lp, tgt, il, tl = random_ctc_problem(rng, B, T, S, V)
    tgt = np.where(tgt == blank, (blank + 1) % V, tgt)
    want = jax_loss_grad(
        lambda x: ctc_nll_xla(x, tgt, il, tl, blank), lp)
    got = port_loss_grad(lp, tgt, il, tl, blank)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)


def test_plain_matches_pallas_interpret(rng):
    """A multichunk Pallas grid (chunk = checkpoint interval = 4 frames),
    odd B and T, vs the port's checkpoint mode at the same interval."""
    B, T, S, V = 3, 37, 6, 9
    lp, tgt, il, tl = random_ctc_problem(rng, B, T, S, V)
    want = jax_loss_grad(
        lambda x: ctc_nll_pallas(x, tgt, il, tl, 0, 4), lp)
    got = port_loss_grad(lp, tgt, il, tl, checkpoint_every=4)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_plain_matches_torch(rng, reduction):
    lp, tgt, il, tl = random_ctc_problem(rng, 6, 50, 10, 20)
    got = port_loss_grad(lp, tgt, il, tl, reduction=reduction)
    want = torch_loss_grad(lp, tgt, il, tl, reduction=reduction)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)


def test_float64_matches_reference_impl(rng):
    lp, tgt, il, tl = random_ctc_problem(rng, 4, 30, 6, 10,
                                         dtype=np.float64)
    tgt[1, :3] = [2, 2, 5]  # a repeated label
    got = port_loss_grad(lp, tgt, il, tl, dtype=torch.float64)
    want = ctc_loss_ref(lp, tgt, il, tl)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-8, atol=1e-8)


def test_repeated_labels_and_nonzero_blank(rng):
    lp, _, _, _ = random_ctc_problem(rng, 2, 18, 4, 7)
    tgt = np.array([[2, 2, 3, 3], [1, 1, 1, 4]], np.int32)
    tl = np.array([4, 4], np.int32)
    il = np.array([18, 13], np.int32)
    for blank in (0, 6):
        got = port_loss_grad(lp, tgt, il, tl, blank)
        want = torch_loss_grad(lp, tgt, il, tl, blank)
        np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
        np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)


def test_zero_target_infeasible_and_empty_input():
    """Zero target length matches torch; an infeasible sample scores +inf
    with the reference's finite gradient exp(lp); input length 0 scores
    +inf with a zero gradient, as the JAX kernel does."""
    T, V = 4, 5
    lp = np.log(np.full((T, 3, V), 1.0 / V, np.float32))
    tgt = np.array([[1, 1, 1], [2, 3, 0], [1, 0, 0]], np.int32)
    il = np.array([4, 4, 0], np.int32)
    tl = np.array([3, 0, 1], np.int32)
    loss, grad = port_loss_grad(lp, tgt, il, tl)
    assert np.isinf(loss[0]) and np.isinf(loss[2])
    assert np.all(np.isfinite(grad))
    np.testing.assert_allclose(grad[:, 0], np.exp(lp[:, 0]), atol=1e-7)
    assert not grad[:, 2].any()
    t_loss, t_grad = torch_loss_grad(lp[:, 1:2], tgt[1:2], il[1:2], tl[1:2])
    np.testing.assert_allclose(loss[1:2], t_loss, **LOSS_TOL)
    np.testing.assert_allclose(grad[:, 1:2], t_grad, **GRAD_TOL)
    want = jax_loss_grad(lambda x: ctc_nll_pallas(x, tgt, il, tl, 0), lp)
    np.testing.assert_array_equal(np.isinf(loss), np.isinf(want[0]))
    np.testing.assert_allclose(grad, want[1], rtol=1e-5, atol=1e-6)


def test_minus_inf_log_probs_stay_finite(rng):
    """-inf log-probs floor to log-zero: no NaN anywhere, the float64
    oracle's answer.  Sample 0 loses a token at every third frame; in
    sample 1 one frame emits nothing, so it is infeasible (+inf, finite
    gradient)."""
    lp, tgt, il, tl = random_ctc_problem(rng, 3, 24, 4, 8)
    lp[::3, 0, 5] = -np.inf
    lp[5, 1, :] = -np.inf
    il[1] = 24
    loss, grad = port_loss_grad(lp, tgt, il, tl)
    want = ctc_loss_ref(lp, tgt, il, tl)
    assert np.isfinite(loss[[0, 2]]).all() and np.isinf(loss[1])
    assert np.all(np.isfinite(grad))
    np.testing.assert_allclose(loss, want[0], **LOSS_TOL)
    np.testing.assert_allclose(grad, want[1], **GRAD_TOL)


def test_multichunk_edge_batch(rng):
    """Chunked checkpoints x variable lengths x zero target x infeasible,
    in one batch."""
    T, B, V = 24, 4, 6
    lp, _, _, _ = random_ctc_problem(rng, B, T, 4, V)
    tgt = np.array([[1, 2, 3, 4], [2, 2, 2, 2], [5, 0, 0, 0], [1, 1, 1, 1]],
                   np.int32)
    il = np.array([24, 5, 17, 3], np.int32)  # sample 3: 3 < 7 frames needed
    for tl in (np.array([4, 4, 1, 4], np.int32),
               np.array([4, 4, 0, 4], np.int32)):
        loss, grad = port_loss_grad(lp, tgt, il, tl, checkpoint_every=4)
        t_loss, t_grad = torch_loss_grad(lp, tgt, il, tl)
        fin = np.isfinite(t_loss)
        np.testing.assert_allclose(loss[fin], t_loss[fin], **LOSS_TOL)
        assert np.isinf(loss[~fin]).all()
        np.testing.assert_allclose(grad[:, fin], t_grad[:, fin], **GRAD_TOL)


def test_zero_infinity(rng):
    lp, tgt, il, tl = random_ctc_problem(rng, 3, 10, 3, 6)
    il[1], tl[1], tgt[1] = 2, 3, [1, 1, 1]  # infeasible
    for reduction in ("none", "mean"):
        got = port_loss_grad(lp, tgt, il, tl, reduction=reduction,
                             zero_infinity=True)
        want = torch_loss_grad(lp, tgt, il, tl, reduction=reduction,
                               zero_infinity=True)
        np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
        np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
        assert not got[1][:, 1].any()


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_no_gradient_reaches_padded_frames(rng, reduction):
    """The encoder on the card returns padded frames as zeros that take no
    gradient (models/conformer.py's packing), which is the padded
    encoder's mathematics only if the loss sends them none: the gradient
    at every frame t >= the sample's length is exactly zero (a full-length
    sample, a one-frame one and an infeasible one beside the rest)."""
    lp, tgt, il, tl = random_ctc_problem(rng, 5, 24, 5, 9, min_t_frac=0.2)
    il[:3], tl[:3], tgt[2] = [24, 1, 3], [3, 1, 3], [4, 4, 4, 1, 2]
    _, grad = port_loss_grad(lp, tgt, il, tl, reduction=reduction,
                             zero_infinity=True)
    assert grad[:, 0].any()
    for n, t in enumerate(il):
        assert not grad[t:, n].any(), n


def test_from_logits_batch_first_and_flat_targets(rng):
    B, T, S, V = 3, 15, 4, 9
    logits = rng.standard_normal((T, B, V)).astype(np.float32)
    _, tgt, il, tl = random_ctc_problem(rng, B, T, S, V)

    want = jax_loss_grad(
        lambda x: jax_ctc_loss(x, tgt, il, tl, reduction="sum",
                               from_logits=True), logits)
    got = port_loss_grad(logits, tgt, il, tl, reduction="sum",
                         from_logits=True)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)

    lp = torch.log_softmax(torch.tensor(logits), -1)
    ref = ctc_loss(lp, tgt, il, tl)
    bf = ctc_loss(lp.transpose(0, 1), tgt, il, tl, batch_first=True)
    flat = np.concatenate([tgt[n, : tl[n]] for n in range(B)])
    fl = ctc_loss(lp, torch.tensor(flat), il, tl)
    mod = CTCLoss()(lp, tgt, il, tl)
    part = ctc_loss_jit()(lp, tgt, il, tl)
    for other in (bf, fl, mod, part):
        assert torch.equal(other, ref)


def test_half_precision_input(rng):
    lp, tgt, il, tl = random_ctc_problem(rng, 3, 16, 4, 9)
    x = torch.tensor(lp).to(torch.bfloat16).requires_grad_(True)
    loss = ctc_loss(x, tgt, il, tl, reduction="sum")
    loss.backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    want = port_loss_grad(x.detach().float().numpy(), tgt, il, tl,
                          reduction="sum")
    np.testing.assert_allclose(loss.item(), want[0], **LOSS_TOL)
    np.testing.assert_allclose(x.grad.float().numpy(), want[1], atol=1e-2)


def test_implementation_names(rng):
    lp, tgt, il, tl = random_ctc_problem(rng, 2, 12, 3, 7)
    x = torch.tensor(lp)
    auto = ctc_nll(x, tgt, il, tl)
    assert torch.equal(ctc_nll(x, tgt, il, tl, implementation="xla"), auto)
    with pytest.raises(ValueError, match="CUDA"):
        ctc_nll(x, tgt, il, tl, implementation="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ctc_nll(x.double(), tgt, il, tl, implementation="pallas")
    with pytest.raises(ValueError, match="implementation"):
        ctc_nll(x, tgt, il, tl, implementation="triton")
    with pytest.raises(ValueError, match="reduction"):
        ctc_loss(x, tgt, il, tl, reduction="max")
    with pytest.raises(ValueError, match=r"\(T, N, C\)"):
        ctc_loss(x[0], tgt, il, tl)
    assert ctc_nll(x.double(), tgt, il, tl).dtype == torch.float64


def test_checkpoint_every_bit_identical(rng):
    lp, tgt, il, tl = random_ctc_problem(rng, 3, 50, 8, 12)
    v0, g0 = port_loss_grad(lp, tgt, il, tl)
    for every in (7, 16):
        v, g = port_loss_grad(lp, tgt, il, tl, checkpoint_every=every)
        np.testing.assert_array_equal(v, v0)
        np.testing.assert_array_equal(g, g0)


def test_gather_equals_jax_onehot_forms(rng):
    """The port's index gather == the JAX package's one-hot matrix forms
    (state_onehot and the label-compacted `_lp_ext_compact`), bit for
    bit: those forms are TPU work-arounds and are not ported."""
    lp, tgt, il, tl = random_ctc_problem(rng, 4, 9, 5, 13)
    lp[2, 1, 3] = -np.inf
    tl[0] = 0
    jt = jcommon.build_ctc_tables(jnp.asarray(tgt), jnp.asarray(tl), 0, 13)
    pt = ctc_common.build_ctc_tables(torch.tensor(tgt), torch.tensor(tl), 0,
                                     13)
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = ctc_common.gather_lp_ext(torch.tensor(lp), pt).numpy()
    lp32 = jnp.maximum(jnp.asarray(lp), -1e30)
    onehot = jnp.einsum("tbv,blv->tbl", lp32,
                        jcommon.state_onehot(jt, 13), precision="highest")
    onehot = jnp.where(jt.valid[None], onehot, -1e30)
    compact = jcommon._lp_ext_compact(jnp.asarray(lp), jt,
                                      jt.ext_labels.shape[1])
    np.testing.assert_array_equal(got, np.asarray(onehot))
    np.testing.assert_array_equal(got, np.asarray(compact))


FULL_CONFIGS = {  # name: (B, T, S, V) of tests/test_full_configs.py
    "librispeech-char": (32, 1000, 200, 29),
    "bpe-asr": (16, 1500, 150, 1024),
    "metric": (32, 1000, 100, 1024),
}


@pytest.mark.parametrize("name", list(FULL_CONFIGS))
def test_full_config_float64_truth(name):
    """At the long configs (batch cut to 4): losses match torch at the
    full-config tolerance, and the float32 gradient is within 1e-4 of the
    float64 scan, or at least as accurate as torch's float32 gradient:
    the criterion of tests/test_full_configs.py, met with libm
    exp/log1p."""
    B, T, S, V = FULL_CONFIGS[name]
    lp, tgt, il, tl = random_ctc_problem(np.random.default_rng(0), B, T, S, V)
    lp, tgt, il, tl = lp[:, :4], tgt[:4], il[:4], tl[:4]
    loss, grad = port_loss_grad(lp, tgt, il, tl)
    _, g64 = port_loss_grad(lp.astype(np.float64), tgt, il, tl,
                            dtype=torch.float64)
    t_loss, t_grad = torch_loss_grad(lp, tgt, il, tl)
    ulp = float(np.spacing(np.abs(t_loss).max().astype(np.float32)))
    np.testing.assert_allclose(loss, t_loss, rtol=2e-6,
                               atol=max(1e-4, 20 * ulp))
    err = float(np.abs(grad - g64).max())
    torch_err = float(np.abs(t_grad - g64).max())
    assert err <= max(1e-4, torch_err), (name, err, torch_err)
    if torch_err <= 5e-5:
        np.testing.assert_allclose(grad, t_grad, rtol=1e-3, atol=1e-4)


# the largest S whose lattice fits K2's shared memory (227 KB on the H100)
_S_LIMIT = 5806


def _slots(plan):
    """The shared bytes a plan must ask for: 6 floats a warp, the ring
    and the staged rows of R floats a thread, the staged norms."""
    r, threads, ring, tape = (plan[k] for k in ("states", "threads",
                                                 "ring", "tape"))
    return 4 * (6 * (threads // 32) + (ring + tape) * r * threads + tape)


def _computing(L, r):
    """Whole warps over ceil(L/r) threads."""
    cells = -(-L // r)
    return -(-cells // 32) * 32


@pytest.mark.parametrize("s_max", [0, 1, 16, 63, 100, 187, 200, 255, 256,
                                   511, 512, 1023, 2047, 2048, 4095,
                                   _S_LIMIT])
def test_alpha_plan_covers_every_lattice_that_fits(s_max):
    """K1's launch plan for L = 2S+1 from 1 up to the shared-memory limit:
    the fewest states a thread, at least ALPHA_STATES, that fit 1024
    threads; whole warps over ceil(L/R); the deepest (ring, staged tape)
    that fits and its shared bytes; and every other states choice that
    fits."""
    L = 2 * s_max + 1
    plan = ctc_loss_cuda.alpha_plan(s_max)
    r = plan["states"]
    fit = [x for x in ctc_loss_cuda.STATES if _computing(L, x) <= 1024]
    assert r == min(x for x in fit if x >= ctc_loss_cuda.ALPHA_STATES)
    for x in ctc_loss_cuda.STATES:
        if x not in fit:
            with pytest.raises(ValueError, match="states a thread"):
                ctc_loss_cuda.alpha_plan(s_max, x)
            continue
        p = ctc_loss_cuda.alpha_plan(s_max, x)
        threads = p["threads"]
        assert p["states"] == x
        assert threads % 32 == 0 and threads <= 1024
        assert x * threads >= L > x * (threads - 32)  # no idle warp
        assert p["smem"] == _slots(p) <= 232448
        pairs = ((8, 64), (8, 32), (8, 16), (4, 8), (2, 4), (2, 2), (2, 1))
        assert (p["ring"], p["tape"]) in pairs
        assert all(_slots({**p, "ring": ring, "tape": tape}) > 232448
                   for ring, tape in pairs[:pairs.index((p["ring"],
                                                         p["tape"]))])
    assert ctc_loss_cuda.alpha_plan(s_max, r, 2, 1)["smem"] == _slots(
        {**plan, "ring": 2, "tape": 1})


def test_alpha_plan_refuses_where_the_kernels_do():
    """The plan takes S up to the largest lattice K2's shared memory
    holds and refuses above it, as the kernels' checks do at S=6000."""
    assert ctc_loss_cuda.beta_smem_bytes(_S_LIMIT) <= 232448
    assert ctc_loss_cuda.beta_smem_bytes(_S_LIMIT + 1) > 232448
    for s_max in (_S_LIMIT + 1, 6000):
        with pytest.raises(ValueError, match="shared memory"):
            ctc_loss_cuda.alpha_plan(s_max)
    with pytest.raises(ValueError, match="states a thread"):
        ctc_loss_cuda.alpha_plan(100, 5)
    with pytest.raises(ValueError, match="do not fit"):
        ctc_loss_cuda.alpha_plan(100, ring=3)
    with pytest.raises(ValueError, match="do not fit"):
        ctc_loss_cuda.alpha_plan(_S_LIMIT, ring=8, tape=16)


def _beta_slots(plan):
    """The shared bytes K2's plan must ask for: 16 + 8 floats a warp of
    slots, a ring stage of R/2 + 1 emissions and R alpha entries a thread
    padded to a multiple of 4 floats, the staged gamma rows (R a thread a
    frame), 2 ring norms."""
    r, threads, ring, tape = (plan[k] for k in ("states", "threads",
                                                 "ring", "tape"))
    emissions = r if r % 2 else r // 2 + 1
    stage = -(-(emissions + r) // 4) * 4
    return 4 * (24 * (threads // 32) + ring * stage * threads
                + tape * r * threads + 2 * ring)


@pytest.mark.parametrize("s_max", [0, 1, 16, 63, 100, 187, 200, 255, 256,
                                   511, 512, 1023, 2047, 2048, 4095,
                                   _S_LIMIT])
def test_beta_plan_covers_every_lattice_that_fits(s_max):
    """K2's launch plan for L = 2S+1 from 1 up to the shared-memory limit,
    a function of S alone: the fewest of 2, 4, 8, 16 states a thread that
    fit 1024 threads; whole warps over ceil(L/R) with no idle warp; the
    deepest (ring, staged gamma) pair that fits and its shared bytes;
    a (states, ring) pair the library builds."""
    L = 2 * s_max + 1
    plan = ctc_loss_cuda.beta_plan(s_max)
    r, threads = plan["states"], plan["threads"]
    assert r == min(x for x in (2, 4, 8, 16) if _computing(L, x) <= 1024)
    assert threads % 32 == 0 and threads <= 1024
    assert r * threads >= L > r * (threads - 32)  # no idle warp
    assert plan["smem"] == _beta_slots(plan) <= 232448
    pairs = ((8, 64), (8, 32), (8, 16), (4, 8), (2, 4), (2, 2), (2, 1))
    at = pairs.index((plan["ring"], plan["tape"]))
    assert all(_beta_slots({**plan, "ring": ring, "tape": tape}) > 232448
               for ring, tape in pairs[:at])
    assert (r, plan["ring"]) in ctc_loss_cuda.BETA_KERNELS
    assert ctc_loss_cuda.beta_plan(s_max) == plan  # no state, no override


def test_beta_kernels_are_the_plans_picks():
    """The (states, ring) pairs that beta_plan picks over every S the
    kernels take are BETA_KERNELS, and csrc/ctc_loss.cu instantiates those
    and no others; above the limit beta_plan refuses as alpha_plan
    does."""
    picked = {(p["states"], p["ring"]) for p in map(
        ctc_loss_cuda.beta_plan, range(_S_LIMIT + 1))}
    assert picked == set(ctc_loss_cuda.BETA_KERNELS)
    src = (cuda_build.CSRC / "ctc_loss.cu").read_text()
    built = {tuple(map(int, m)) for m in re.findall(
        r"launch_beta<(\d+), (\d+)>", src)}
    assert built == picked
    with pytest.raises(ValueError, match="shared memory"):
        ctc_loss_cuda.beta_plan(_S_LIMIT + 1)


@pytest.mark.parametrize("name", [f"new: {k}" for k in ctc_beta_breakdown.NEW]
                         + [f"parent: {k}" for k in ctc_beta_breakdown.PARENT]
                         + ["probe", "parent probe", "any plan"])
def test_beta_breakdown_patches_apply(name):
    """Each of the K2 breakdown tool's text patches finds its text exactly
    once, in csrc/ctc_loss.cu (the kernel's variants, its clock probe and
    the build of every plan) or in tools/ctc_beta_reference.cu (the
    parent's), so the variants it times exist."""
    src = (cuda_build.CSRC / "ctc_loss.cu").read_text()
    ref = ctc_beta_breakdown.REFERENCE.read_text()
    kind, _, key = name.partition(": ")
    text, patches = {
        "new": (src, ctc_beta_breakdown.NEW.get(key)),
        "parent": (ref, ctc_beta_breakdown.PARENT.get(key)),
        "probe": (src, ctc_beta_breakdown.PROBE),
        "parent probe": (ref, ctc_beta_breakdown.PARENT_PROBE),
        "any plan": (src, ctc_beta_breakdown.ANY_PLAN)}[kind]
    assert patched(text, patches) != text


def test_beta_breakdown_other_plans():
    """The tool's other plans at the two timed shapes: each differs from
    beta_plan's in what it names, keeps whole warps over ceil(L/R), and
    asks for the shared bytes the C entry checks."""
    for _, _, s, _ in ctc_alpha_breakdown.SHAPES.values():
        base = ctc_loss_cuda.beta_plan(s)
        for over in ctc_beta_breakdown.PLANS.values():
            plan = ctc_beta_breakdown.plan_with(s, **over)
            assert {k: plan[k] for k in over} == over != {
                k: base[k] for k in over}
            assert plan["threads"] == _computing(2 * s + 1, plan["states"])
            assert plan["smem"] == _beta_slots(plan) <= 232448


@pytest.mark.parametrize("name", list(ctc_alpha_breakdown.NEW))
def test_alpha_breakdown_patches_apply(name):
    """Each of the breakdown tool's text patches finds its text exactly
    once in csrc/ctc_loss.cu, so the variants it times exist."""
    src = (cuda_build.CSRC / "ctc_loss.cu").read_text()
    assert patched(src, ctc_alpha_breakdown.NEW[name]) != src


def test_alpha_breakdown_problems():
    """The tool's two problems: the training slice's lengths (T'/4 labels
    for 30/22/15 s) and the metric shape's draw with one infeasible
    sample."""
    lp, tgt, il, tl = ctc_alpha_breakdown.problem("main", "cpu")
    assert lp.shape == (750, 8, 32) and tgt.shape == (8, 187)
    assert il.tolist() == [750, 550, 375, 750, 550, 375, 550, 375]
    assert tl.tolist() == [187, 137, 93, 187, 137, 93, 137, 93]
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones(750, 8))
    lp, tgt, il, tl = ctc_alpha_breakdown.problem("metric", "cpu")
    assert lp.shape == (1000, 32, 1024) and tgt.shape == (32, 100)
    assert il[1] < tl[1] and (tl <= il // 3).sum() == 31
    assert tgt.dtype == il.dtype == torch.int32

"""The port's online-softmax fused joint on the CPU (ops/rnnt_joint.py and
its plain twins, ops/rnnt_joint_plain.py) against the JAX package's
`rnnt_joint_pallas.py`, whose Pallas kernels run in interpret mode here, as
its own tests run them.

Tolerances, and why:
  * the twins' forward (planes, m, log s) within 1e-5 of the kernel's: the
    same tiles (512 lanes, 512 rows), the same bf16 products; only the
    order of the float32 sums and the exp's last bits differ;
  * dh, dW and db within 1e-3 of each tensor's max: d is rounded to bf16
    before the products, and a last-bit difference of the float32 d can
    round it to the neighbouring bf16 value (2^-8 of it);
  * `rnnt_nll_fused_pallas` against JAX's: the NLL rtol 1e-5 (the same
    planes to 1e-5 through the same DP), the gradients as dh/dW/db;
  * against the port's own bf16-joint `rnnt_nll_fused`: the JAX test's
    budget (2e-3 on the value; gradient cosine > 0.995 and 1.5e-2), since
    that path keeps float32 cotangents where the kernels round d.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from end2end_tpu.ops import rnnt_joint_pallas as jjoint
from end2end_tpu_torch import (fused_additive_joint, rnnt_nll_fused,
                               rnnt_nll_fused_pallas)
from end2end_tpu_torch.ops import rnnt_joint_cuda, rnnt_joint_plain

torch.set_num_threads(1)

GRAD_RTOL = 1e-3

# name: (seed, n, t, u, v, j, blank)
CASES = {
    "jax_setup": (0, 2, 7, 3, 11, 8, 0),         # test_rnnt_joint_pallas
    "blank5_v13": (1, 2, 7, 3, 13, 8, 5),
    # three 512-lane tiles, the last ragged, blank in the second; R = 720
    # rows: two 512-row blocks, the last ragged
    "v1100_j16": (2, 3, 40, 5, 1100, 16, 600),
}


@functools.cache
def problem(name):
    """tests/test_rnnt_joint_pallas.py's `_setup` draw, with a third sample
    when n = 3, labels kept off the blank; variable lengths."""
    seed, n, t, u, v, j, blank = CASES[name]
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, t, j)).astype(np.float32)
    pred = rng.normal(size=(n, u + 1, j)).astype(np.float32)
    w = (rng.normal(size=(j, v)) / np.sqrt(j)).astype(np.float32)
    b = (0.1 * rng.normal(size=(v,))).astype(np.float32)
    tgt = rng.integers(1, v, (n, u)).astype(np.int32)
    tgt = np.where(tgt == blank, (blank + 1) % v, tgt).astype(np.int32)
    il = np.array([t, t - 2, t - 5], np.int32)[:n]
    ul = np.array([u, 1, u - 2], np.int32)[:n]
    return (enc, pred, w, b), tgt, il, ul, blank


@functools.cache
def rows_problem(name):
    """The kernels' row inputs: h = tanh(enc + pred) (R, J), w, b, labels
    y (R,), and random plane cotangents gb, gl (R,)."""
    (enc, pred, w, b), tgt, _, _, blank = problem(name)
    n, t, j = enc.shape
    up = pred.shape[1]
    h = np.tanh(enc[:, :, None] + pred[:, None]).reshape(-1, j)
    y = np.broadcast_to(np.pad(tgt, ((0, 0), (0, up - tgt.shape[1])))
                        [:, None], (n, t, up)).reshape(-1).astype(np.int32)
    g = np.random.default_rng(7).random((2, h.shape[0])).astype(np.float32)
    return h.astype(np.float32), w, b, y, blank, g[0], g[1]


@functools.cache
def jax_rows(name):
    """JAX's forward (planes, m, log s) and backward (dh, dW, db)."""
    h, w, b, y, blank, gb, gl = rows_problem(name)
    v = w.shape[1]
    (b_pl, l_pl), res = jjoint._joint_planes_fwd_impl(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(y),
        blank, v)
    r = h.shape[0]
    m, logs = res[4][:r, 0], res[5][:r, 0]
    grads = jjoint._joint_planes_bwd(blank, v, res, (jnp.asarray(gb),
                                                     jnp.asarray(gl)))[:3]
    return ([np.asarray(x) for x in (b_pl, l_pl, m, logs)],
            [np.asarray(x) for x in grads])


def torch_rows(name):
    h, w, b, y, blank, gb, gl = rows_problem(name)
    return (*(torch.tensor(a) for a in (h, w, b, y)), blank), (
        torch.tensor(gb), torch.tensor(gl))


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rtol, f"{what}: {err} of the max"


@pytest.mark.parametrize("name", list(CASES))
def test_joint_fwd_matches_jax(name):
    args, _ = torch_rows(name)
    got = rnnt_joint_plain.joint_fwd(*args, rows=512, tile=512)
    want, _ = jax_rows(name)
    for g, w, what in zip(got, want, ("b_pl", "l_pl", "m", "logs")):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_joint_dh_dw_match_jax(name):
    args, (gb, gl) = torch_rows(name)
    (_, _, m, logs), (dh, dw, db) = jax_rows(name)
    stats = (torch.tensor(m), torch.tensor(logs), gb, gl)
    got_dh = rnnt_joint_plain.joint_dh(*args, *stats, rows=512, tile=512)
    got_dw, got_db = rnnt_joint_plain.joint_dw(*args, *stats, rows=512,
                                               tile=512)
    for g, w, what in ((got_dh, dh, "dh"), (got_dw, dw, "dW"),
                       (got_db, db, "db")):
        assert g.shape == w.shape
        assert_rel(g.numpy(), w, GRAD_RTOL, what)


def test_twins_tile_and_row_widths_agree():
    """The kernels' widths (row blocks of 64, tiles of 128) give the 512
    ones' results up to float32 sum order."""
    args, (gb, gl) = torch_rows("v1100_j16")
    wide = rnnt_joint_plain.joint_fwd(*args, rows=512, tile=512)
    narrow = rnnt_joint_plain.joint_fwd(*args, rows=64, tile=128)
    for a, c in zip(wide, narrow):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-5)
    stats = (wide[2], wide[3], gb, gl)
    for fn in (rnnt_joint_plain.joint_dh, rnnt_joint_plain.joint_dw):
        a, c = fn(*args, *stats, rows=512, tile=512), fn(*args, *stats,
                                                         rows=64, tile=128)
        for x, z in zip(a if isinstance(a, tuple) else (a,),
                        c if isinstance(c, tuple) else (c,)):
            assert_rel(x.numpy(), z.numpy(), GRAD_RTOL)


def jax_fused(name):
    arrays, tgt, il, ul, blank = problem(name)

    def total(*xs):
        return jnp.sum(jjoint.rnnt_nll_fused_pallas(
            *xs, tgt, il, ul, blank=blank, implementation="xla"))

    value = jjoint.rnnt_nll_fused_pallas(
        *(jnp.asarray(a) for a in arrays), tgt, il, ul, blank=blank,
        implementation="xla")
    grads = jax.grad(total, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    return np.asarray(value), [np.asarray(g) for g in grads]


def torch_fused(name, loss_fn=None):
    arrays, tgt, il, ul, blank = problem(name)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    if loss_fn is None:
        nll = rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank)
    else:
        nll = loss_fn(xs, tgt, il, ul, blank)
    nll.sum().backward()
    return nll.detach().numpy(), [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("name", list(CASES))
def test_fused_pallas_matches_jax(name):
    """Values and the gradients of enc_proj, pred_proj, w_out, b_out
    against jax.grad of the JAX function (variable lengths throughout)."""
    want, want_g = jax_fused(name)
    got, got_g = torch_fused(name)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    for g, w, what in zip(got_g, want_g, ("enc_proj", "pred_proj", "w_out",
                                          "b_out")):
        assert_rel(g, w, GRAD_RTOL, what)


@pytest.mark.parametrize("name", ["jax_setup", "blank5_v13"])
def test_fused_pallas_close_to_bf16_joint(name):
    """tests/test_rnnt_joint_pallas.py's oracle: the same joint with bf16
    operands, materialised chunk by chunk in float32 sums."""
    got, got_g = torch_fused(name)

    def bf16_joint(xs, tgt, il, ul, blank):
        joint = fused_additive_joint(xs[2], xs[3], matmul_dtype="bfloat16")
        return rnnt_nll_fused(xs[0], xs[1], joint, tgt, il, ul, blank=blank,
                              chunk_t=4)

    want, want_g = torch_fused(name, bf16_joint)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    for a, c in zip(got_g, want_g):
        a, c = a.ravel(), c.ravel()
        assert a @ c / (np.linalg.norm(a) * np.linalg.norm(c)) > 0.995
        np.testing.assert_allclose(a, c, rtol=0, atol=1.5e-2)


def test_training_descends():
    (enc, pred, w, b), tgt, il, ul, _ = problem("jax_setup")
    enc, pred, b = (torch.tensor(a) for a in (enc, pred, b))
    w = torch.tensor(w, requires_grad=True)

    def loss():
        return rnnt_nll_fused_pallas(enc, pred, w, b, tgt, il, ul).mean()

    l0 = loss().item()
    for _ in range(10):
        w.grad = None
        loss().backward()
        with torch.no_grad():
            w -= 0.1 * w.grad
    assert loss().item() < l0 - 0.05


def test_routing_on_the_cpu(monkeypatch):
    """CPU tensors take the plain twins (no kernel launch), every
    `implementation` of the DP but 'pallas', which needs the card."""
    arrays, tgt, il, ul, blank = problem("blank5_v13")
    xs = [torch.tensor(a) for a in arrays]
    calls = []
    for fn in ("joint_fwd", "joint_dh", "joint_dw"):
        orig = getattr(rnnt_joint_plain, fn)
        monkeypatch.setattr(rnnt_joint_plain, fn,
                            lambda *a, _f=orig, _n=fn: calls.append(_n)
                            or _f(*a))
    before = dict(rnnt_joint_cuda.launches)
    auto = rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank)
    assert torch.equal(auto, rnnt_nll_fused_pallas(
        *xs, tgt, il, ul, blank=blank, implementation="xla"))
    x = xs[0].clone().requires_grad_(True)
    rnnt_nll_fused_pallas(x, *xs[1:], tgt, il, ul, blank=blank).sum(
    ).backward()
    assert calls == ["joint_fwd"] * 3 + ["joint_dh"]  # w, b need no grad
    assert rnnt_joint_cuda.launches == before
    with pytest.raises(ValueError, match="pallas"):
        rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank,
                              implementation="pallas")
    with pytest.raises(ValueError, match="implementation"):
        rnnt_nll_fused_pallas(*xs, tgt, il, ul, implementation="cuda")


def test_bad_inputs_raise():
    arrays, tgt, il, ul, _ = problem("jax_setup")
    xs = [torch.tensor(a) for a in arrays]
    with pytest.raises(ValueError, match="targets must be"):
        rnnt_nll_fused_pallas(*xs, tgt[0], il, ul)
    with pytest.raises(ValueError, match="targets must be"):
        rnnt_nll_fused_pallas(*xs, np.ones((2, 4), np.int32), il, ul)
    with pytest.raises(ValueError, match="blank"):
        rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=11)
    with pytest.raises(ValueError, match="fit"):
        rnnt_nll_fused_pallas(xs[0], xs[1], xs[2].T, xs[3], tgt, il, ul)

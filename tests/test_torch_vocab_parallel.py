"""The port's vocabulary-parallel fused transducer losses on D=4 gloo ranks
on the CPU: `rnnt_nll_fused_pallas_vocab_parallel` (the kernels' plain TP
twins here) and the float32 `rnnt_nll_fused_vocab_parallel`, against the
JAX package's functions of the same names on a 4-device mesh (the Pallas
kernels in interpret mode, tests/conftest.py's virtual CPU devices) and
against the port's unsharded losses.

The four ranks are spawned once: a module fixture runs every case in them
and the tests below assert on what they return, so each case counts on
its own.  The ranks import this module, which imports no JAX at its top
(the JAX references are computed in this process only); they meet over a
`file://` rendezvous under a temporary directory, so concurrent test
workers never share a port.

Tolerances, and why:
  * the kernel path against JAX's: the NLL rtol 1e-5 / atol 2e-4 and the
    gradients 1e-3 of each tensor's max, as the unsharded
    tests/test_torch_rnnt_joint.py holds them (bf16 operands; a last-bit
    difference of d can round it to the neighbouring bf16 value);
  * either path against the port's unsharded loss: 2e-4 on the value and
    5e-4 absolute on the gradients, the JAX package's own TP tolerances
    (tests/test_rnnt_joint_pallas.py, tests/test_rnnt_fused.py): only the
    cross-shard order of the sum-exp differs;
  * the kernel path against the bf16-operand joint: 2e-3, the JAX test's
    bf16 budget;
  * a gradient's projection on the unsharded one within 1e-2 of 1: a
    factor of D (a cotangent summed, or not summed, over the group) moves
    it by at least 0.75.
"""

import functools
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from end2end_tpu_torch import (fused_additive_joint, rnnt_nll_fused,
                               rnnt_nll_fused_pallas,
                               rnnt_nll_fused_pallas_vocab_parallel,
                               rnnt_nll_fused_vocab_parallel)

D = 4
CHUNK_T = 4  # frames per chunk of the float32 paths
JOIN_S = 900  # the ranks' time limit
KINDS = ("pallas", "f32")
# name: (seed, n, t, u, v, j, blank)
CASES = {
    "v16": (4, 2, 7, 3, 16, 8, 0),          # test_tp_matches_unsharded_kernel
    "v16_blank9": (5, 2, 7, 3, 16, 8, 9),   # blank on a middle shard
    "v12": (6, 2, 7, 3, 12, 8, 0),          # test_tp_value_close_to_f32_...
    # shards of 275 columns (ragged tiles), blank on shard 2, three samples
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


def _tp_loss(kind, xs, tgt, il, ul, blank):
    if kind == "pallas":
        return rnnt_nll_fused_pallas_vocab_parallel(*xs, tgt, il, ul,
                                                    blank=blank)
    return rnnt_nll_fused_vocab_parallel(*xs, tgt, il, ul, blank=blank,
                                         chunk_t=CHUNK_T)


def _rank_main(rank, tmp):
    """One rank: every case through both TP losses; the NLL and the four
    gradients to tmp/rank{rank}.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=D, rank=rank)
    try:
        out = {"jax_free": "jax" not in sys.modules}
        for name in CASES:
            arrays, tgt, il, ul, blank = problem(name)
            for kind in KINDS:
                xs = [torch.tensor(a, requires_grad=True) for a in arrays]
                nll = _tp_loss(kind, xs, tgt, il, ul, blank)
                nll.sum().backward()
                out[f"{name}/{kind}"] = [nll.detach()] + [x.grad
                                                          for x in xs]
        zeros = (torch.zeros((1, 4, 3)), torch.zeros((1, 3, 3)),
                 torch.zeros((3, 9)), torch.zeros(9))
        for kind in KINDS:
            try:
                _tp_loss(kind, zeros, np.zeros((1, 2), np.int32), [4], [2],
                         0)
            except ValueError as e:
                out[f"indivisible/{kind}"] = str(e)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of D gloo ranks."""
    tmp = tmp_path_factory.mktemp("vocab_parallel")
    ctx = mp.spawn(_rank_main, args=(str(tmp),), nprocs=D, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {D} ranks ran past {JOIN_S} s")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(D)]


def tp_result(ranks, name, kind):
    """The NLL and the gradients of enc_proj and pred_proj (rank 0's), and
    of w_out and b_out (the sum of the ranks' own columns)."""
    res = [r[f"{name}/{kind}"] for r in ranks]
    return ([x.numpy() for x in res[0][:3]]
            + [sum(r[i] for r in res).numpy() for i in (3, 4)])


@functools.cache
def jax_tp(name, kind):
    """JAX's TP loss of the same kind on a 4-device mesh: NLL, gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from end2end_tpu.parallel import vocab_parallel as jvp

    arrays, tgt, il, ul, blank = problem(name)
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("model",))
    if kind == "pallas":
        def loss(*xs):
            return jvp.rnnt_nll_fused_pallas_vocab_parallel(
                *xs, tgt, il, ul, mesh, blank=blank, implementation="xla")
    else:
        def loss(*xs):
            return jvp.rnnt_nll_fused_vocab_parallel(
                *xs, tgt, il, ul, mesh, blank=blank, chunk_t=CHUNK_T)
    nll, vjp = jax.vjp(loss, *(jnp.asarray(a) for a in arrays))
    return [np.asarray(x) for x in (nll, *vjp(jnp.ones_like(nll)))]


@functools.cache
def unsharded(name, kind):
    """The port's unsharded loss of the same kind, in this process."""
    arrays, tgt, il, ul, blank = problem(name)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    if kind == "pallas":
        nll = rnnt_nll_fused_pallas(*xs, tgt, il, ul, blank=blank)
    elif kind == "f32":
        nll = rnnt_nll_fused(xs[0], xs[1], fused_additive_joint(*xs[2:]),
                             tgt, il, ul, blank=blank, chunk_t=CHUNK_T)
    else:  # the bf16-operand joint, materialised chunk by chunk
        nll = rnnt_nll_fused(
            xs[0], xs[1],
            fused_additive_joint(*xs[2:], matmul_dtype="bfloat16"), tgt, il,
            ul, blank=blank, chunk_t=CHUNK_T)
    nll.sum().backward()
    return [nll.detach().numpy()] + [x.grad.numpy() for x in xs]


GRADS = ("enc_proj", "pred_proj", "w_out", "b_out")


def assert_rel(got, want, rtol, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rtol, f"{what}: {err} of the max"


@pytest.mark.parametrize("name", list(CASES))
def test_tp_pallas_matches_jax(ranks, name):
    got = tp_result(ranks, name, "pallas")
    want = jax_tp(name, "pallas")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=2e-4)
    for g, w, what in zip(got[1:], want[1:], GRADS):
        assert_rel(g, w, 1e-3, what)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_tp_matches_unsharded(ranks, kind, name):
    got, want = tp_result(ranks, name, kind), unsharded(name, kind)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-4)
    for g, w, what in zip(got[1:], want[1:], GRADS):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_f32_matches_jax(ranks, name):
    got, want = tp_result(ranks, name, "f32"), jax_tp(name, "f32")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-4)
    for g, w, what in zip(got[1:], want[1:], GRADS):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-4, err_msg=what)


@pytest.mark.parametrize("name", ["v12", "v16_blank9"])
def test_tp_pallas_close_to_bf16_joint(ranks, name):
    got = tp_result(ranks, name, "pallas")
    want = unsharded(name, "bf16")
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_are_not_scaled_by_the_group_size(ranks, kind):
    """Each gradient's projection on the unsharded one is 1, not D or
    1/D: the plane cotangents are not summed over the group, the partial
    activation gradients are."""
    for name in CASES:
        got, want = tp_result(ranks, name, kind), unsharded(name, kind)
        for g, w, what in zip(got[1:], want[1:], GRADS):
            scale = float((g * w).sum() / (w * w).sum())
            assert abs(scale - 1.0) < 1e-2, f"{name} {what}: x{scale}"


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_agree_and_keep_to_their_columns(ranks, kind):
    """Every rank has the same NLL and enc/pred gradients; rank r's w_out
    and b_out gradients are zero outside its columns."""
    for name in CASES:
        v = CASES[name][4]
        res = [r[f"{name}/{kind}"] for r in ranks]
        for r, (nll, g_enc, g_pred, g_w, g_b) in enumerate(res):
            assert torch.equal(nll, res[0][0])
            assert torch.equal(g_enc, res[0][1])
            assert torch.equal(g_pred, res[0][2])
            own = torch.zeros(v, dtype=torch.bool)
            own[r * v // D:(r + 1) * v // D] = True
            assert not g_w[:, ~own].any() and not g_b[~own].any()
            assert g_w[:, own].any() and g_b[own].any()


@pytest.mark.parametrize("kind", KINDS)
def test_indivisible_vocab_raises(ranks, kind):
    for r in ranks:
        assert "divide" in r[f"indivisible/{kind}"]


def test_ranks_never_import_jax(ranks):
    assert all(r["jax_free"] for r in ranks)


def test_needs_a_process_group():
    (enc, pred, w, b), tgt, il, ul, _ = problem("v16")
    for fn in (rnnt_nll_fused_pallas_vocab_parallel,
               rnnt_nll_fused_vocab_parallel):
        with pytest.raises(RuntimeError, match="init_process_group"):
            fn(enc, pred, w, b, tgt, il, ul)

"""The launch plan of the transducer wavefront kernels K8/K9
(`rnnt_loss_cuda.wavefront_plan`), on the CPU: which lanes a thread, how
many warps, how deep a ring and how many shared bytes each U+1 gets, and
where the kernels' envelope ends; the wrappers' workspace; and the
breakdown tool's text patches and other plans.  The kernels themselves run
only on the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from end2end_tpu_torch.ops import rnnt_loss_cuda
from end2end_tpu_torch.ops.rnnt_loss_cuda import wavefront_plan
from end2end_tpu_torch.tools import rnnt_wavefront_breakdown as breakdown
from end2end_tpu_torch.tools.joint_dw_breakdown import patched
from end2end_tpu_torch.utils import cuda_build

SMEM_LIMIT = 232448  # a block's shared memory on the H100
ONE_WARP = 32  # the default one-warp plan's cap: one lane a thread


def _smem(plan):
    return 4 * (8 * plan["warps"]
                + plan["ring"] * 2 * plan["lanes"] * 32 * plan["warps"])


def test_lanes_cover_every_up():
    """Every U+1 in 1..2048: the plan's lanes cover it in whole warps, and
    one warp fewer would not."""
    for up in range(1, 2049):
        plan = wavefront_plan(up)
        threads = 32 * plan["warps"]
        assert plan["lanes"] * threads >= up, (up, plan)
        assert plan["lanes"] * (threads - 32) < up, (up, plan)


def test_one_warp_up_to_its_cap():
    """One warp up to 32 lanes, then whole warps at one lane a thread up to
    1024 lanes and two a thread up to 2048."""
    for up in range(1, 2049):
        plan = wavefront_plan(up)
        assert (plan["warps"] == 1) == (up <= ONE_WARP), up
        assert plan["lanes"] == (1 if up <= 1024 else 2), up


def test_five_kernels_a_wavefront():
    """Every U+1 up to 8192 takes one of the five kernels the C entry
    instantiates: one warp at one lane a thread, or whole warps at 1, 2 or
    4 lanes with a ring of 4 and at 8 lanes with a ring of 2."""
    kernels = {(p["lanes"], p["warps"] == 1, p["ring"])
               for p in map(wavefront_plan, range(1, 8193))}
    assert kernels == {(1, True, 4), (1, False, 4), (2, False, 4),
                       (4, False, 4), (8, False, 2)}
    assert wavefront_plan(8193)["lanes"] == 0


@pytest.mark.parametrize("up", [1, 151, 256, 257, 2048, 4096, 4097, 8192,
                                8193, 29039])
def test_shared_bytes_within_the_limit(up):
    """The slot row and the ring (or past 8192 lanes the rows in shared
    memory) fit a block's shared memory, the plan's bytes are its
    formula's, and the ring is the default depth where that fits."""
    plan = wavefront_plan(up)
    assert plan["smem"] <= SMEM_LIMIT
    if up > 8192:
        assert plan == {"lanes": 0, "warps": 32, "ring": 0,
                        "smem": 4 * (2 * up + 33)}
    else:
        assert plan["smem"] == _smem(plan)
        assert plan["ring"] == (2 if plan["lanes"] == 8
                                else rnnt_loss_cuda.RING)
        if plan["warps"] == 32 and plan["lanes"] == 8:
            assert _smem({**plan, "ring": rnnt_loss_cuda.RING}) > SMEM_LIMIT


def test_every_up_to_2048_within_the_limit():
    for up in range(1, 2049):
        assert wavefront_plan(up)["smem"] <= SMEM_LIMIT, up


def test_envelope_raises_exactly_past_it():
    """The last U+1 whose diagonal fits shared memory (29039) plans; the
    next raises, as the wrappers' check does."""
    assert wavefront_plan(29039)["smem"] == SMEM_LIMIT - 4
    with pytest.raises(ValueError, match="shared memory"):
        wavefront_plan(29040)


def test_envelope_raises_below_one_lane():
    with pytest.raises(ValueError, match="lane"):
        wavefront_plan(0)


@pytest.mark.parametrize("n,t,up", [(8, 750, 151), (8, 400, 81),
                                    (3, 9, 8192), (2, 5, 8193)])
def test_workspace_floats(n, t, up):
    """K8's workspace holds the two skewed planes (2 N D Up floats, D =
    T+U), K9's also the beta tape and its offsets ((3 Up + 1) N D); the
    rows-in-shared-memory kernels take none."""
    plan = wavefront_plan(up)
    d = t + up - 1
    want = (0, 0) if up > 8192 else (2 * up * n * d, (3 * up + 1) * n * d)
    assert tuple(rnnt_loss_cuda.workspace(n, t, up, plan, post)
                 for post in (False, True)) == want


@pytest.mark.parametrize("up,lanes,ring", [
    (151, 9, None),  # more lanes than a thread's registers take
    (151, 5, 3),  # no such ring
    (257, 3, None),  # several warps take 1, 2, 4 or 8 lanes
    (257, 4, 16),  # rings of 2, 4 or 8
    (4096, 1, None),  # 4096 threads
    (4096, 2, None),  # 2048 threads
    (8192, 8, 4),  # a ring of 4 at 1024 threads does not fit
])
def test_plans_that_do_not_hold_raise(up, lanes, ring):
    """The breakdown tool's other plans raise where its any-plan build has
    no kernel or shared memory does not fit."""
    with pytest.raises(ValueError, match="no plan"):
        breakdown.any_plan(up, lanes, ring)


@pytest.mark.parametrize("up,lanes,ring,want", [
    (151, 2, None, {"lanes": 2, "warps": 3, "ring": 4, "smem": 6240}),
    (151, 5, 8, {"lanes": 5, "warps": 1, "ring": 8, "smem": 10272}),
    (33, 8, 2, {"lanes": 8, "warps": 1, "ring": 2, "smem": 4128}),
    (151, None, 2, {"lanes": 1, "warps": 5, "ring": 2, "smem": 2720}),
    (8192, None, None, {"lanes": 8, "warps": 32, "ring": 2,
                        "smem": 132096}),
])
def test_plan_overrides(up, lanes, ring, want):
    """The breakdown tool's other plans; with nothing overridden,
    wavefront_plan's."""
    assert breakdown.any_plan(up, lanes, ring) == want
    if lanes is None and ring is None:
        assert wavefront_plan(up) == want


def _sources():
    return ((cuda_build.CSRC / "rnnt_loss.cu").read_text(),
            breakdown.REFERENCE.read_text())


@pytest.mark.parametrize("name", list(breakdown.NEW)
                         + ["any plan", "probe"])
def test_breakdown_kernel_patches_apply(name):
    """Each of the breakdown tool's patches of csrc/rnnt_loss.cu finds its
    text exactly once and changes the source."""
    src = _sources()[0]
    patches = {"any plan": breakdown.ANY_PLAN,
               "probe": breakdown.PROBE_NEW}.get(name) or breakdown.NEW[name]
    assert patched(src, patches) != src
    assert breakdown.is_new(src)


@pytest.mark.parametrize("name", list(breakdown.PARENT) + ["probe"])
def test_breakdown_parent_patches_apply(name):
    """The same for the parent kept as tools/rnnt_loss_reference.cu, which
    takes no plan."""
    src = _sources()[1]
    patches = (breakdown.PROBE_PARENT if name == "probe"
               else breakdown.PARENT[name])
    assert patched(src, patches) != src
    assert not breakdown.is_new(src)


def test_breakdown_problems():
    """The tool's two lattices: planes of their shapes, log-zero labels
    past each sequence's labels, T'/5 labels a sequence."""
    for name, (b, t, up, il) in breakdown.SHAPES.items():
        b_pl, l_pl, il_t, ul = breakdown.problem(name, "cpu")
        assert b_pl.shape == l_pl.shape == (b, t, up)
        assert il_t.tolist() == list(il)
        assert ul.tolist() == [min(x // 5, up - 1) for x in il]
        assert bool(torch.all(b_pl <= 0)) and bool(torch.all(l_pl <= 0))
        for n, u in enumerate(ul.tolist()):
            assert bool(torch.all(l_pl[n, :, u:] <= -1e29)), (name, n)

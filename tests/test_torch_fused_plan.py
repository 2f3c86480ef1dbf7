"""The two-loop kernel's launch plan, computed in Python.

``fused.launch_plan`` decides, for one call of the CUDA kernel, how many
warps a block has, how many shared-memory stages each warp's ring holds,
the persistent grid, and whether each operand arrives by a bulk
asynchronous copy or by ``cp.async``.  The kernel needs the card, but the
plan does not: these tests hold it to the card's limits (227 KB of shared
memory per block, 132 SMs on an H100) and walk its instance assignment in
plain Python.  tests/test_torch_cuda.py checks on the card that the
kernel's own layout gives the same shared-memory size.
"""

import numpy as np
import pytest
import torch

from lbfgspp_tpu_torch.ops import fused as TF
from test_torch_history import build_both

H100_SMS = 132


@pytest.mark.parametrize("dtype,itemsize", [(torch.float32, 4),
                                            (torch.float64, 8)])
def test_main_shape_takes_bulk_copies_within_a_block(dtype, itemsize):
    plan = TF.launch_plan(4096, 16, 100, TF.KINDS[dtype, dtype], H100_SMS)
    assert plan.smem_bytes <= TF.MAX_SMEM_BYTES == 232448
    assert set(plan.copy.values()) == {"bulk"} and plan.codes == 0
    assert plan.staged and plan.ld == 100
    # s, y (m rows of n), two [m, m] runs, v, ys and the 16-byte header
    assert plan.stage_bytes == itemsize * (2 * 16 * 100 + 2 * 256 + 100
                                           + 16) + 16
    assert plan.warps * plan.stages * plan.stage_bytes <= plan.smem_bytes
    assert plan.grid == H100_SMS * plan.blocks_per_sm
    if dtype == torch.float32:
        # two stages cost no warps: 7 warps x 2 stages fill an SM
        assert (plan.warps, plan.stages, plan.blocks_per_sm) == (7, 2, 1)
    else:
        # two stages would leave 3 warps an SM: 7 warps of one stage win
        assert (plan.warps, plan.stages, plan.blocks_per_sm) == (7, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offsets,expect", [
    (101, {}, {"s", "y", "v"}),               # rows not 16-byte multiples
    (100, {"s": 1, "v": 3}, {"s", "v"}),      # views at an odd offset
    (100, {"y": 1 << 40 | 1}, {"y"}),
])
def test_unaligned_runs_take_cp_async(dtype, n, offsets, expect):
    """``offsets`` are storage offsets in elements from a 16-byte aligned
    base."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    addresses = {op: k * itemsize for op, k in offsets.items()}
    plan = TF.launch_plan(64, 16, n, TF.KINDS[dtype, dtype], H100_SMS,
                          addresses)
    slow = {op for op, path in plan.copy.items() if path != "bulk"}
    assert slow == expect
    for op in slow:
        granule = int(plan.copy[op].split("/")[1])
        assert granule >= itemsize
        assert addresses.get(op, 0) % granule == 0
    assert plan.ld * itemsize % 16 == 0 and plan.ld >= n


def test_copy_codes_pack_two_bits_per_operand():
    plan = TF.launch_plan(8, 16, 101, "f32", H100_SMS,
                          {"mat": 4, "ys": 8})
    paths = {0: "bulk", 1: "cp.async/4", 2: "cp.async/8", 3: "lanes/2"}
    unpacked = {op: paths[(plan.codes >> (2 * k)) & 3]
                for k, op in enumerate(TF.OPERANDS)}
    assert unpacked == plan.copy
    assert plan.copy == {"s": "cp.async/4", "y": "cp.async/4",
                         "mat": "cp.async/4", "yy": "bulk",
                         "v": "cp.async/4", "ys": "cp.async/8"}


@pytest.mark.parametrize("m,n,dtype,stages,staged", [
    (1, 40, torch.float32, 2, True),
    (33, 33, torch.float32, 1, True),     # cp.async rows: 8 warps/SM
    (33, 33, torch.float64, 1, True),
    (16, 416, torch.float32, 1, True),
    (16, 417, torch.float32, 2, False),   # cp.async rows: < 4 warps/SM
    (16, 199, torch.float64, 2, False),
    (16, 100000, torch.float32, 2, False),
    (128, 100, torch.float32, 1, False),
    (16, 600, torch.float32, 1, True),    # bulk rows at 2 warps/SM
    (16, 1000, torch.float32, 1, True),   # bulk rows at 1 warp/SM
    (16, 1001, torch.float32, 2, False),
    (16, 300, torch.float64, 1, True),
    (16, 195, torch.float32, 1, True),    # cp.async rows at >= 8 warps/SM
    (16, 197, torch.float32, 2, False),
    (16, 197, torch.float64, 1, True),    # cp.async rows at >= 4 warps/SM
])
def test_odd_sizes_fit_or_fall_back(m, n, dtype, stages, staged):
    """Rows that go by bulk copy are staged wherever one stage fits; rows
    that go by cp.async only while that keeps 32 bytes a lane in flight
    on an SM (8 warps at 4-byte granules, 4 at 8).  Past that, s, y and v
    stay in device memory, and past one stage of two warps, one stage;
    the limit on m is then the [m, m] operands alone."""
    plan = TF.launch_plan(4096, m, n, TF.KINDS[dtype, dtype], H100_SMS)
    assert plan.smem_bytes <= TF.MAX_SMEM_BYTES
    assert (plan.stages, plan.staged) == (stages, staged)
    if staged and plan.copy["s"] != "bulk":
        granule = int(plan.copy["s"].split("/")[1])
        assert plan.warps * plan.blocks_per_sm * granule >= \
            TF.CP_ASYNC_BYTES_PER_LANE
    elif not staged:
        assert {plan.copy[op] for op in ("s", "y", "v")} == {"none"}
        assert plan.copy["mat"] == plan.copy["yy"] == "bulk"


def test_below_four_warps_per_sm_more_warps_beat_more_stages():
    """At f32 n=600 one warp with two stages and two warps with one stage
    hold the same buffers per SM; the plan takes the two warps."""
    plan = TF.launch_plan(4096, 16, 600, "f32", H100_SMS)
    assert (plan.warps * plan.blocks_per_sm, plan.stages) == (2, 1)
    # an unaligned view sends the rows by cp.async: unstaged at 2 warps/SM
    assert not TF.launch_plan(4096, 16, 600, "f32", H100_SMS,
                              {"s": 4}).staged


def test_the_plan_keeps_the_most_stage_buffers_resident():
    """Every other layout that fits holds no more stage buffers per SM
    (warps per SM x stages) than the plan's."""
    for dtype, kind in ((torch.float32, "f32"), (torch.float64, "f64")):
        plan = TF.launch_plan(4096, 16, 100, TF.KINDS[dtype, dtype],
                              H100_SMS)
        held = plan.warps * plan.blocks_per_sm * plan.stages
        for stages in (1, 2):
            for warps in range(1, TF.MAX_WARPS + 1):
                smem = TF._layout(16, 100, kind, warps, stages)[2]
                if smem <= TF.MAX_SMEM_BYTES:
                    other = warps * stages * TF._blocks_per_sm(warps, smem,
                                                               kind)
                    assert other <= held


@pytest.mark.parametrize("m,n,dtype", [(170, 100, torch.float32),
                                       (128, 100, torch.float64),
                                       (168, 2000, torch.float32)])
def test_a_shape_that_cannot_fit_raises(m, n, dtype):
    with pytest.raises(ValueError,
                       match=r"needs \d+ bytes of shared memory per block, "
                             r"above the 232448 a Hopper block can have"):
        TF.launch_plan(4, m, n, TF.KINDS[dtype, dtype], H100_SMS)


@pytest.mark.parametrize("batch", [1, 5, 4097, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_persistent_walk_covers_every_instance_once(batch, dtype):
    plan = TF.launch_plan(batch, 16, 100, TF.KINDS[dtype, dtype], H100_SMS)
    seen = np.zeros(batch, dtype=np.int64)
    shares = []
    for block in range(plan.grid):
        share = plan.instances(block)
        shares.append(len(share))
        for b in share:
            seen[b] += 1
    assert (seen == 1).all()
    # every block has work, and the shares differ by at most one instance
    assert min(shares) >= 1 and max(shares) - min(shares) <= 1
    assert plan.warps <= batch
    assert plan.grid <= H100_SMS * plan.blocks_per_sm


@pytest.mark.parametrize("warps,stages", [(1, 1), (2, 2), (4, 2), (7, 1)])
def test_overrides_are_kept_and_checked(warps, stages):
    """A layout given to ``_layout_plan`` (as tests and measurements do) is
    kept as given and held to the block's limits."""
    plan = TF._layout_plan(100, 16, 100, "f32", H100_SMS, warps,
                           stages, True)
    assert (plan.warps, plan.stages) == (warps, stages)
    assert plan.smem_bytes == TF._layout(16, 100, "f32", warps, stages)[2]
    with pytest.raises(ValueError, match="shared memory"):
        TF._layout_plan(100, 16, 100, "f32", H100_SMS, 8, 2, True)
    # with rows in device memory the same layout fits
    assert not TF._layout_plan(100, 16, 100, "f32", H100_SMS, 8, 2,
                               False).staged
    with pytest.raises(ValueError, match="must be in"):
        TF._layout_plan(100, 16, 100, "f32", H100_SMS, 1, 3, True)


def test_unstaged_plans_can_be_forced_and_ignore_row_addresses():
    plan = TF._layout_plan(64, 16, 100, "f32", H100_SMS, 4, 2,
                           False, {"s": 4, "v": 4})
    assert not plan.staged
    assert plan.copy == {"s": "none", "y": "none", "mat": "bulk",
                         "yy": "bulk", "v": "none", "ys": "bulk"}
    assert plan.smem_bytes == TF._layout(16, 100, "f32", plan.warps,
                                         plan.stages, False)[2]


def test_element_misaligned_address_raises():
    with pytest.raises(ValueError, match="not a multiple of its 8-byte"):
        TF.launch_plan(4, 16, 100, "f64", H100_SMS, {"s": 4})


def test_simple_kernel_on_cpu_takes_plain_version_and_counts_nothing():
    _, th = build_both(3, 10, 4, (1, 4, 6), with_rinv=True, seed=3)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 10)))
    args = (th.s, th.y, th.ys, th.theta, th.ptr, th.ncorr, th.sy, th.yy,
            th.rinv, v)
    before = (TF.two_loop.launches, TF.two_loop_simple.launches)
    for mode in ("sweeps", "rinv"):
        assert torch.equal(TF.two_loop_simple(*args, -1.0, mode),
                           TF.two_loop_plain(*args, -1.0, mode))
    assert (TF.two_loop.launches, TF.two_loop_simple.launches) == before

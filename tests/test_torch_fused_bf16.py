"""The two-loop kernel's bf16 modes, what can be held on the CPU.

- The plain version in bf16 (every operand bf16, one rounding per op, as
  the Pallas kernel computes in its bf16 mode) against the JAX package's
  ``_batched_fused`` and ``_batched_fused_mmajor`` run in Pallas interpret
  mode on the same bf16 inputs (tiling and padding patched as in
  tests/test_fused.py).  The two frameworks round at other places (torch's
  bf16 matmul accumulates in f32 and rounds its result once, XLA's
  elementwise products round each term), so the tolerance is 2^-5 of the
  instance's largest output: a few bf16 ulps (2^-8 each).  Both are held,
  at the same 2^-5, to the same function computed in f64 from the same
  inputs (the m-major layout's 2m rounded adds of the combine reach
  2^-6 here).
- The launch plan for 2-byte rows: bf16 rows of odd n (202 bytes at
  n=101) go unstaged and do not raise, rows of n=100 go by 8-byte
  cp.async, two-byte [m, m] runs by the lanes' own loads, and the staged
  limits at m=16 hold twice the n of f32.
- The dispatch of repair 2 (``fused.route``): which calls on the card take
  the plain version, decided from types, B, m, n and the plan's fit.

The kernel itself needs the card: tests/test_torch_cuda.py and
``chip_smoke.py`` phase 18 hold it against the plain version there, and
tests/test_torch_two_loop_emulated.py runs its source on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import fused as JF
from lbfgspp_tpu_torch.ops import fused as TF
from test_torch_history import build_both

BF16 = torch.bfloat16
H100_SMS = 132
CASES = [(4, (0, 1, 3, 6)), (5, (6, 9, 2, 7, 6))]


def _bf16_inputs(batch, ncorrs, seed):
    jh, th = build_both(batch, 24, 6, ncorrs, seed=seed)
    v = np.random.default_rng(seed + 1).standard_normal((batch, 24))
    args = [th.s, th.y, th.ys, th.theta, th.ptr, th.ncorr, th.sy, th.yy,
            th.rinv, torch.as_tensor(v)]
    args = [t.to(BF16) if t is not None and t.is_floating_point() else t
            for t in args]
    return jh, args


def _relative(got, want):
    """Largest error of each instance over its largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want).max(1) / np.abs(want).max(1)).max()


@pytest.fixture(scope="module")
def pallas_outputs():
    """Both Pallas layouts in interpret mode on the bf16 inputs of every
    case, computed once for the module."""
    out = {}
    for batch, ncorrs in CASES:
        jh, args = _bf16_inputs(batch, ncorrs, seed=batch)
        j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
             for t in (args[0], args[1], args[6], args[7], args[2],
                       args[3], args[9])]
        s, y, sy, yy, ys, theta, v = j
        msy, msyT, ys_safe, vmask = JF._prep_masks(
            ys, jh.ptr, jh.ncorr, sy, yy, jnp.bfloat16)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JF, "INTERPRET", True)
            mp.setattr(JF, "B_TILE", 4)
            mp.setattr(JF, "B_TILE2", 4)
            for layout in ("_batched_fused", "_batched_fused_mmajor"):
                got = getattr(JF, layout)(s, y, msy, msyT, yy, ys_safe,
                                          vmask, theta, v, -1.0)
                assert got.dtype == jnp.bfloat16
                out[batch, layout] = np.asarray(got.astype(jnp.float32))
    return out


@pytest.mark.parametrize("layout", ["_batched_fused",
                                    "_batched_fused_mmajor"])
@pytest.mark.parametrize("batch,ncorrs", CASES)
def test_bf16_plain_matches_pallas_interpret(pallas_outputs, layout, batch,
                                             ncorrs):
    _, args = _bf16_inputs(batch, ncorrs, seed=batch)
    got = TF.two_loop_plain(*args, -1.0, "sweeps")
    assert got.dtype == BF16
    want = pallas_outputs[batch, layout]
    assert _relative(got.float().numpy(), want) <= 2.0 ** -5
    exact = TF.two_loop_plain(*[t.double() if t is not None and
                                t.is_floating_point() else t
                                for t in args], -1.0, "sweeps").numpy()
    assert _relative(got.float().numpy(), exact) <= 2.0 ** -5
    assert _relative(want, exact) <= 2.0 ** -5


@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
def test_bf16_rows_beside_f32_operands_widen_per_element(mode):
    """bf16 rows with f32 operands: the f32 function of the widened rows
    (what the JAX package's XLA path computes for a bf16-stored history),
    whole or in chunks along n."""
    _, th = build_both(3, 40, 6, (2, 6, 9), with_rinv=True, seed=8)
    v = torch.as_tensor(np.random.default_rng(9).standard_normal((3, 40)),
                        dtype=torch.float32)
    rest = [t.float() if t.is_floating_point() else t
            for t in (th.ys, th.theta, th.ptr, th.ncorr, th.sy, th.yy,
                      th.rinv)]
    s, y = th.s.to(BF16), th.y.to(BF16)
    got = TF.two_loop_plain(s, y, *rest, v, -1.0, mode)
    want = TF.two_loop_plain(s.float(), y.float(), *rest, v, -1.0, mode)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "PLAIN_CHUNK_BYTES", 16 * 3 * 6 * 4)   # 16 columns
        chunked = TF.two_loop_plain(s, y, *rest, v, -1.0, mode)
    np.testing.assert_allclose(chunked.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bf16_rows_of_odd_n_go_unstaged_without_raising(dtype):
    plan = TF.launch_plan(4097, 1, 101, TF.KINDS[BF16, dtype], H100_SMS)
    assert not plan.staged
    assert {plan.copy[op] for op in ("s", "y", "v")} == {"none"}
    assert plan.kind == ("bf16" if dtype == BF16 else "bf16rows")
    # all-bf16 at m=1: the [m, m] runs and ys are 2 bytes, copied by the
    # lanes; beside f32 operands they are 4-byte cp.async runs
    want = "lanes/2" if dtype == BF16 else "cp.async/4"
    assert plan.copy["mat"] == plan.copy["yy"] == plan.copy["ys"] == want
    assert plan.codes >> 4 & 3 == (3 if dtype == BF16 else 1)


def test_bf16_rows_of_even_n_are_staged():
    """At the main shape a bf16 row is 200 bytes, an 8-byte granule; one
    stage holds s and y at ld = 104 (n rounded up to 16 bytes of bf16)."""
    for dtype, kind, v_copy in ((BF16, "bf16", "cp.async/8"),
                                (torch.float32, "bf16rows", "bulk")):
        plan = TF.launch_plan(4096, 16, 100, TF.KINDS[BF16, dtype],
                              H100_SMS)
        assert plan.staged and plan.ld == 104 and plan.kind == kind
        assert plan.copy["s"] == plan.copy["y"] == "cp.async/8"
        assert plan.copy["v"] == v_copy
        op = 2 if dtype == BF16 else 4
        assert plan.stage_bytes == 2 * 16 * 208 + 2 * 256 * op + \
            -(-104 * op // 16) * 16 + -(-16 * op // 16) * 16 + 16
        assert plan.smem_bytes == TF._layout(16, 100, kind, plan.warps,
                                             plan.stages)[2]
        # 8-byte granules need 4 warps an SM; the registers allow 16
        assert plan.warps * plan.blocks_per_sm >= 4


@pytest.mark.parametrize("n,staged", [
    (393, False),                          # odd: no granule of 4 bytes
    (382, True), (386, False),             # 4-byte granules (f32: 195)
    (804, True), (812, False),             # 8-byte granules (f32: 414)
    (3376, True), (3384, False),           # bulk rows (f32: 1736)
])
def test_staged_limits_of_two_byte_rows(n, staged):
    """bf16 rows beside f32 operands at m=16: odd n is never staged; rows
    by cp.async need eight warps an SM at 4-byte granules and four at
    8-byte ones; bulk rows are staged while one stage of one warp fits.
    Each limit is about twice f32's n (v stays f32)."""
    plan = TF.launch_plan(4096, 16, n, "bf16rows", H100_SMS)
    assert plan.staged == staged
    if staged and plan.copy["s"] != "bulk":
        granule = int(plan.copy["s"].split("/")[1])
        assert plan.warps * plan.blocks_per_sm * granule >= \
            TF.CP_ASYNC_BYTES_PER_LANE


def test_registers_table_covers_every_instantiation():
    assert set(TF.MAX_WARPS_PER_SM_BY_REGISTERS) == set(TF.SIZES) == \
        set(TF.KINDS.values())
    # computed in f32: 128 registers a thread, 16 warps an SM; f64: 8
    for kind, (_, _, comp) in TF.SIZES.items():
        assert TF.MAX_WARPS_PER_SM_BY_REGISTERS[kind] == (16 if comp == 4
                                                          else 8)


def test_types_the_kernel_has_no_instantiation_for_raise_in_the_plan():
    for row, op in ((torch.float16, torch.float16),
                    (torch.float32, torch.float64),
                    (torch.float32, BF16)):
        assert TF.kind_of(row, op) is None
        with pytest.raises(ValueError, match="float32 or float64"):
            TF.launch_plan(8, 4, 16, TF.kind_of(row, op), H100_SMS)


def _route_args(batch, m, n, row, op):
    s = torch.zeros(batch, m, n, dtype=row)
    mm = torch.zeros(batch, m, m, dtype=op)
    return (s, s.clone(), torch.ones(batch, m, dtype=op),
            torch.ones(batch, dtype=op),
            torch.full((batch,), m, dtype=torch.int32),
            torch.zeros(batch, dtype=torch.int32), mm, mm.clone(),
            mm.clone(), torch.zeros(batch, n, dtype=op))


@pytest.mark.parametrize("batch,m,n,row,op,reason", [
    (4, 200, 100, torch.float32, torch.float32, "shared memory"),
    (4, 168, 100, torch.float32, torch.float32, "shared memory"),
    (4, 120, 100, torch.float64, torch.float64, "shared memory"),
    (4, 6, 24, torch.float16, torch.float16, "dtype"),
    (4, 6, 24, torch.float32, torch.float64, "dtype"),
    (1, 6, TF.LARGE_N + 1, torch.float32, torch.float32, "large n"),
    (2, 6, 1 << 17, BF16, torch.float32, "large n"),
    (4, 167, 100, torch.float32, torch.float32, None),
    (4, 117, 100, torch.float64, torch.float64, None),
    (1, 6, TF.LARGE_N, BF16, torch.float32, None),
    (4, 16, 100, BF16, BF16, None),
    (4, 16, 101, BF16, torch.float32, None),
])
def test_route_sends_to_plain_only_what_the_kernel_cannot_serve(
        batch, m, n, row, op, reason, monkeypatch):
    """The dispatch is static: it reads types, B, m, n and whether a plan
    fits, and launches nothing (here there is no card to launch on)."""
    monkeypatch.setattr(TF, "num_sms", lambda device: H100_SMS)
    plan, why = TF.route(*_route_args(batch, m, n, row, op), "rinv")
    assert why == reason
    assert (plan is None) == (reason is not None)
    if plan is not None:
        assert plan.kind == TF.KINDS[row, op]


@pytest.mark.parametrize("batch,row,op,reason", [
    (15, torch.float32, torch.float32, "large n"),
    (16, torch.float32, torch.float32, None),
    (15, BF16, BF16, "large n"),
    (16, BF16, BF16, None),
    (1, BF16, torch.float32, "large n"),
    (2, BF16, torch.float32, None),
    (32, torch.float64, torch.float64, "large n"),
])
def test_long_rows_take_the_kernel_from_a_batch_per_sm(batch, row, op,
                                                        reason, monkeypatch):
    """Rows longer than LARGE_N take the plain version below each type's
    batch per SM (f32 and all-bf16 16, bf16 rows 2, f64 none) and the
    kernel from it on; one SM here, so the batch is the threshold."""
    monkeypatch.setattr(TF, "num_sms", lambda device: 1)
    n = TF.LARGE_N + 1
    plan, why = TF.route(*_route_args(batch, 6, n, row, op), "rinv")
    assert why == reason
    assert (plan is None) == (reason is not None)
    per_sm = TF.LARGE_N_KERNEL_BATCH_PER_SM[TF.KINDS[row, op]]
    assert (reason is None) == (per_sm is not None and batch >= per_sm)
    # rows of LARGE_N take the kernel at any batch
    plan, why = TF.route(*_route_args(batch, 6, TF.LARGE_N, row, op),
                         "rinv")
    assert plan is not None and why is None

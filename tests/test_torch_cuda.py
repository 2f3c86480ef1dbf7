"""The CUDA two-loop kernels against their plain version, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports neither JAX nor the JAX package, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to the largest output entry: 1e-12 in f64 and 1e-5
in f32.  The kernel and the plain version sum in another order, and these
random histories are well conditioned.

The cases cover both copy paths of the main kernel (bulk copies at n=100;
``cp.async`` at n=101 and for views at an odd storage offset), its
unstaged plan (n=1000 in f64: rows read from device memory; in f32 the
rows are staged at one warp per SM), the ragged tail of
its persistent walk (B=4097), a history after the restart's soft reset,
the solver families' shapes (B=1, m=8, n=256; B=1024, m=6, n=64 and its
pair shape n=128), and the first design, ``fused.two_loop_simple``, kept
as a yardstick.  The bf16 instantiations (all bf16; bf16 rows beside f32
operands) are held against the plain version, and each plain route of
``fused.route`` (m=200 f32, m=120 f64, f16, rows longer than
``fused.LARGE_N`` in a small batch) is counted apart from the launches;
long rows in a full batch launch the kernel.  OWL-QN runs on the card
against the CPU, and its fast phase's TF32 scope is read inside the
objective.
"""

import functools

import numpy as np
import pytest
import torch

import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch.ops import fused, history
from lbfgspp_tpu_torch.utils import objectives

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def random_history(batch, n, m, ncorrs, seed):
    """A port history with ``ncorrs[b]`` accepted pairs in instance b,
    built in f64 on the CPU."""
    rng = np.random.default_rng(seed)
    h = history.init_history(batch, n, m, torch.float64, device="cpu",
                             with_rinv=True)
    for t in range(max(ncorrs)):
        s = rng.standard_normal((batch, n))
        y = s * rng.uniform(0.5, 2.0, (batch, 1)) \
            + 0.3 * rng.standard_normal((batch, n))
        y[np.einsum("bn,bn->b", s, y) < 0] *= -1.0
        h, _ = history.update_history(h, torch.as_tensor(s),
                                      torch.as_tensor(y),
                                      torch.as_tensor(t < np.asarray(ncorrs)))
    return h


@functools.lru_cache(maxsize=4)
def _cached_history(batch, n, m, ncorrs, seed):
    return random_history(batch, n, m, ncorrs, seed)


def _args(h, v):
    return (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy, h.rinv, v)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
@pytest.mark.parametrize("batch,n,m,ncorrs", [
    (5, 24, 6, (0, 6, 9, 2, 7)),      # mixed fill, wrapped rings
    (3, 40, 1, (0, 1, 3)),
    (4, 33, 33, (0, 5, 33, 70)),
    (6, 101, 16, (0, 3, 16, 20, 40, 9)),    # rows not 16-byte multiples
    (6, 1000, 16, (0, 3, 16, 20, 40, 9)),   # f64: rows in memory
    (4097, 100, 16, tuple(range(4097))),    # ragged persistent walk
    (4096, 100, 16, tuple(range(4096))),    # the main path's shape
])
def test_kernel_matches_plain(cuda, dtype, rtol, mode, batch, n, m, ncorrs):
    h = _on_card(_cached_history(batch, n, m,
                                 tuple(c % (3 * m) for c in ncorrs), m),
                 cuda, dtype)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((batch, n)),
                        dtype=dtype, device=cuda)
    before = fused.two_loop.launches
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert fused.two_loop.launches == before + 1
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


def _on_card(h, device, dtype):
    return type(h)(*(t.to(device, dtype) if t.is_floating_point()
                     else t.to(device) for t in h))


def _at_odd_offset(t):
    """The same values as a contiguous view one element into its storage,
    so its address is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
def test_kernel_matches_plain_on_misaligned_views(cuda, dtype, rtol, mode):
    batch, n, m = 9, 100, 16
    h = _on_card(random_history(batch, n, m, [0, 2, 5, 16, 17, 30, 1, 8, 40],
                                seed=2), cuda, dtype)
    h = h._replace(s=_at_odd_offset(h.s))
    v = _at_odd_offset(torch.as_tensor(
        np.random.default_rng(5).standard_normal((batch, n)), dtype=dtype,
        device=cuda))
    plan = fused.plan_for(*_args(h, v), mode)
    assert plan.copy["s"].startswith("cp.async")
    assert plan.copy["v"].startswith("cp.async")
    assert plan.copy["y"] == "bulk"
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
def test_kernel_matches_plain_after_a_soft_reset(cuda, dtype, rtol, mode):
    """The restart's soft reset (ncorr = 0, theta = 1) leaves stale rows
    and R^{-1} entries in place; three more pairs then refill the ring."""
    batch, n, m = 64, 100, 16
    h = random_history(batch, n, m, [20] * batch, seed=8)
    reset = torch.as_tensor(np.random.default_rng(9).random(batch) < 0.5)
    h = h._replace(ncorr=torch.where(reset, 0, h.ncorr),
                   theta=torch.where(reset, 1.0, h.theta))
    rng = np.random.default_rng(10)
    for _ in range(3):
        s = rng.standard_normal((batch, n))
        y = s * rng.uniform(0.5, 2.0, (batch, 1))
        h, _ = history.update_history(h, torch.as_tensor(s),
                                      torch.as_tensor(y),
                                      torch.ones(batch, dtype=torch.bool))
    h = _on_card(h, cuda, dtype)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((batch, n)),
                        dtype=dtype, device=cuda)
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_simple_kernel_matches_plain_and_counts_apart(cuda, dtype, rtol):
    h = _on_card(random_history(5, 24, 6, (0, 6, 9, 2, 7), seed=6), cuda,
                 dtype)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((5, 24)),
                        dtype=dtype, device=cuda)
    main, simple = fused.two_loop.launches, fused.two_loop_simple.launches
    got = fused.two_loop_simple(*_args(h, v), -1.0, "rinv")
    torch.cuda.synchronize()
    assert fused.two_loop.launches == main
    assert fused.two_loop_simple.launches == simple + 1
    want = fused.two_loop_plain(*_args(h, v), -1.0, "rinv")
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


@pytest.mark.parametrize("m,n", [(16, 100), (6, 24), (1, 40), (33, 33),
                                 (16, 101), (16, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_layout_agrees_with_the_kernel(cuda, m, n, dtype):
    lib = fused._library()
    plan = fused.launch_plan(64, m, n, fused.KINDS[dtype, dtype],
                             fused.num_sms(cuda))
    assert lib.lbfgs_two_loop_smem_bytes(
        m, n, int(dtype == torch.float64), plan.warps, plan.stages,
        int(plan.staged)) == plan.smem_bytes


@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
def test_forced_unstaged_plan_matches_plain(cuda, mode):
    h = _on_card(random_history(5, 24, 6, (0, 6, 9, 2, 7), seed=6), cuda,
                 torch.float64)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((5, 24)),
                        device=cuda)
    plan = fused._layout_plan(5, 6, 24, "f64", fused.num_sms(cuda),
                              2, 2, False)
    got = fused._launch(plan, *_args(h, v), -1.0, mode)
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        1e-12 * want.abs().max().item()


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
@pytest.mark.parametrize("batch", [768, 4096])
def test_kernel_matches_plain_at_the_pair_shape(cuda, dtype, rtol, mode,
                                                batch):
    """The df64 phases' input: a history lifted to pair space (n=100 ->
    200, zero lo halves) and the pair gradient [g; g]."""
    from lbfgspp_tpu_torch import batch as batch_mod
    h = _cached_history(batch, 100, 16,
                        tuple(c % 48 for c in range(batch)), 16)
    h = _on_card(batch_mod._lift_history_pairs(h, "rinv"), cuda, dtype)
    g = torch.as_tensor(np.random.default_rng(2).standard_normal((batch, 100)),
                        dtype=dtype, device=cuda)
    v = torch.cat([g, g], dim=1)
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


def test_pair_transforms_exact_on_card(cuda):
    """The card's counterpart of the JAX package's exact-under-jit test:
    each eager op rounds once, so two_sum / two_prod are exact against
    f64, ``(1 + x) - 1`` keeps x's lo word, and pair products and sums
    equal the CPU's bit for bit."""
    from lbfgspp_tpu_torch.utils import doublefloat as dfl
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(-10, 10, 1 << 16), dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(-30, 30, 1 << 16), dtype=torch.float32)
    ac, bc = a.to(cuda), b.to(cuda)
    s, e = dfl.two_sum(ac, bc * 1e-4)
    assert torch.equal(s.double() + e.double(),
                       ac.double() + (bc * 1e-4).double())
    p, e = dfl.two_prod(ac, bc)
    assert torch.equal(p.double() + e.double(), ac.double() * bc.double())
    x = dfl.DF(ac * 0.03, ac * 2.0 ** -30)
    one = dfl.lift(torch.ones_like(ac))
    back = dfl.sub(dfl.add(one, x), one)
    err = (back.hi.double() + back.lo.double()) - \
        (x.hi.double() + x.lo.double())
    assert err.abs().max().item() < 1e-13
    xa, xb = dfl.DF(a, a * 2.0 ** -26), dfl.DF(b, b * 2.0 ** -27)
    for op in (dfl.add, dfl.mul, dfl.div):
        got = op(dfl.DF(*(t.to(cuda) for t in xa)),
                 dfl.DF(*(t.to(cuda) for t in xb)))
        want = op(xa, xb)
        assert torch.equal(got.hi.cpu(), want.hi)
        assert torch.equal(got.lo.cpu(), want.lo)
    got = dfl.df_sum(dfl.DF(*(t.to(cuda) for t in xa)), (0,))
    want = dfl.df_sum(xa, (0,))
    assert torch.equal(got.hi.cpu(), want.hi)
    assert torch.equal(got.lo.cpu(), want.lo)


def test_df64_phases_launch_once_per_iteration(cuda):
    """The bench recipe on the card at a small batch: the warm polish
    launches once for its first direction and once per iteration, the deep
    stage once per iteration, and every instance ends within 1e-4."""
    from lbfgspp_tpu_torch import batch as batch_mod
    x0 = np.random.default_rng(1).uniform(-2.0, 2.0, (64, 100))
    main = lt.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16,
                          max_linesearch=2)
    full = lt.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16)
    res = lt.minimize_batched(objectives.rosenbrock,
                              torch.as_tensor(x0, dtype=torch.float32), main,
                              direction="rinv", on_ls_fail="restart",
                              device=cuda)
    before = fused.two_loop.launches
    pol = batch_mod.polish_solve(objectives.rosenbrock, res.x, full, 5,
                                 direction="rinv", warm_history=res.history,
                                 device=cuda)
    assert fused.two_loop.launches - before == 1 + int(pol.niter.max())
    merged = batch_mod._merge_polished(res, pol)
    before = fused.two_loop.launches
    deep = batch_mod.deep_polish(objectives.rosenbrock, merged, full, 12, 60,
                                 direction="rinv")
    added = deep.niter - merged.niter
    assert fused.two_loop.launches - before == int(added.max())
    assert int((added > 0).sum()) == 12
    assert (deep.x - 1.0).abs().max().item() <= 1e-4


@pytest.mark.parametrize("direction", ["sweeps", "rinv"])
def test_batched_solve_launches_once_per_iteration(cuda, direction):
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, (8, 10))
    p = lt.LBFGSParams(epsilon=1e-6, max_iterations=300)
    before = fused.two_loop.launches
    res = lt.minimize(objectives.rosenbrock, torch.as_tensor(x0), p,
                      direction=direction, device=cuda)
    assert fused.two_loop.launches - before == int(res.niter.max())
    assert (res.status == lt.Status.CONVERGED_GRAD).all()
    assert (res.x - 1.0).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
def test_kernel_matches_plain_at_the_box_shape(cuda, dtype, rtol, mode):
    """The box polish's shape: B=4096, m=6, n=20 (pair space of n=10)."""
    ncorrs = tuple(int(k) for k in np.random.default_rng(2).integers(
        0, 18, 4096))
    h = _cached_history(4096, 20, 6, ncorrs, 6)
    h = type(h)(*(t.to(cuda, dtype) if t.is_floating_point() else t.to(cuda)
                  for t in h))
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((4096, 20)),
                        dtype=dtype, device=cuda)
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


def test_box_solve_on_card_equals_cpu(cuda):
    """The box-constrained batch solve (Rosenbrock n=10 in [2, 4], B=256,
    f64, the prefix GCP) on the card and on the CPU: the same iterations
    and statuses, x to 1e-10."""
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(2.0, 4.0,
                                                          (256, 10)))
    p = lt.LBFGSBParams(epsilon=1e-6, max_iterations=60)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        runs[dev.type] = lt.minimize_b_batched(
            objectives.rosenbrock, x0.to(dev), torch.full((10,), 2.0),
            torch.full((10,), 4.0), p, device=dev)
    card, cpu = runs["cuda"], runs["cpu"]
    assert torch.equal(card.niter.cpu(), cpu.niter)
    assert torch.equal(card.status.cpu(), cpu.status)
    torch.testing.assert_close(card.x.cpu(), cpu.x, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
@pytest.mark.parametrize("batch,n,m", [
    (1, 256, 8),        # the stochastic step
    (1024, 64, 6),      # OWL-QN and the implicit adjoint's preconditioner
    (1024, 128, 6),     # OWL-QN's df64 polish (pair space)
])
def test_kernel_matches_plain_at_the_solver_family_shapes(cuda, dtype, rtol,
                                                          mode, batch, n, m):
    ncorrs = tuple(int(k) for k in np.random.default_rng(batch).integers(
        0, 3 * m, batch)) if batch > 1 else (m + 3,)
    h = _on_card(_cached_history(batch, n, m, ncorrs, n), cuda, dtype)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((batch, n)),
                        dtype=dtype, device=cuda)
    before = fused.two_loop.launches
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert fused.two_loop.launches == before + 1
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


def _separable_l1(device):
    rng = np.random.default_rng(1)
    t = torch.as_tensor(rng.uniform(-1.0, 1.0, (64, 12)), device=device)
    c = torch.as_tensor(rng.uniform(0.1, 2.0, (64, 12)), device=device)
    lam = rng.uniform(0.0, 0.3, (64, 12))
    lam[:, 0] = 0.0
    x0 = torch.as_tensor(rng.uniform(-1.0, 1.0, (64, 12)), device=device)
    return x0, torch.as_tensor(lam, device=device), (t, c)


def _separable_loss(x, d):
    return torch.sum(d[1] * ((x - d[0]) ** 2) ** 2 + 0.5 * (x - d[0]) ** 2)


def test_owlqn_on_card_equals_cpu(cuda):
    """OWL-QN, f64, a separable quartic + L1 batch with per-instance data
    and lambda: the same iterations, evaluations and statuses on the card
    and on the CPU, x to 1e-10, one kernel launch per batched
    iteration."""
    from lbfgspp_tpu_torch import owlqn
    p = lt.LBFGSParams(epsilon=1e-7, epsilon_rel=0.0, max_iterations=200)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        x0, lam, data = _separable_l1(dev)
        owlqn.COUNTS.clear()
        before = fused.two_loop.launches
        runs[dev.type] = lt.minimize_owlqn(_separable_loss, x0, lam, p,
                                           data=data, device=dev)
        if dev.type == "cuda":
            assert fused.two_loop.launches - before == \
                owlqn.COUNTS["iterations"]
    card, cpu = runs["cuda"], runs["cpu"]
    assert torch.equal(card.niter.cpu(), cpu.niter)
    assert torch.equal(card.nfev.cpu(), cpu.nfev)
    assert torch.equal(card.status.cpu(), cpu.status)
    torch.testing.assert_close(card.x.cpu(), cpu.x, rtol=0, atol=1e-10)
    assert torch.equal(card.x.cpu() == 0, cpu.x == 0)


def test_owlqn_fast_phase_scopes_tf32_on_card(cuda):
    """fast_phase_epsilon: the objective runs with TF32 allowed in phase 1
    and not in phase 2, read inside the objective on the card; the
    history's products never change the caller's flag, which is back
    after the solve."""
    flags = torch.backends.cuda.matmul
    seen = []
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(32, 48, 16, generator=gen, device=cuda) / 48 ** 0.5
    b = torch.randn(32, 48, generator=gen, device=cuda)

    def loss(x, d):
        seen.append(flags.allow_tf32)
        return 0.5 * torch.sum((d[0] @ x - d[1]) ** 2)

    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        res = lt.minimize_owlqn(
            loss, torch.zeros(32, 16, device=cuda), 0.01,
            lt.LBFGSParams(epsilon=1e-5, epsilon_rel=0.0,
                           max_iterations=150),
            data=(a, b), fast_phase_epsilon=1e-3, device=cuda)
        assert flags.allow_tf32 is False
    finally:
        flags.allow_tf32 = before
    n1 = seen.index(False)
    assert n1 > 1 and all(seen[:n1]) and not any(seen[n1:])
    assert torch.isfinite(res.x).all()


# ---------------------------------------------------------------------
# The bf16 instantiations and the static plain routes.

BF16 = torch.bfloat16


def _bf16_args(h, v, op):
    """bf16 rows; every other operand (and v) in ``op``."""
    return (h.s.to(BF16), h.y.to(BF16)) + tuple(
        t.to(op) if t.is_floating_point() else t
        for t in (h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy, h.rinv)) + \
        (v.to(op),)


@pytest.mark.parametrize("op", [BF16, torch.float32])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
@pytest.mark.parametrize("batch,n,m,ncorrs", [
    (5, 24, 6, (0, 6, 9, 2, 7)),
    (3, 40, 1, (0, 1, 3)),                  # two-byte [m, m] runs in bf16
    (6, 101, 16, (0, 3, 16, 20, 40, 9)),    # odd n: rows in memory
    (4, 33, 33, (0, 5, 33, 70)),
    (4096, 100, 16, tuple(range(4096))),    # the main path's shape
])
def test_bf16_kernel_matches_plain(cuda, op, mode, batch, n, m, ncorrs):
    """bf16 rows beside f32 operands: against the plain version on the
    same rows, 1e-5 of the largest output.  All bf16: against the plain
    version computed in f32 from the same bf16 inputs, 2^-8 of each
    instance's largest output (the kernel rounds its f32 result once)."""
    h = _on_card(_cached_history(batch, n, m,
                                 tuple(c % (3 * m) for c in ncorrs), m),
                 cuda, torch.float64)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((batch, n)),
                        device=cuda)
    args = _bf16_args(h, v, op)
    kind = fused.KINDS[BF16, op]
    before = fused.two_loop.kind_launches[kind]
    got = fused.two_loop(*args, -1.0, mode)
    torch.cuda.synchronize()
    assert fused.two_loop.kind_launches[kind] == before + 1
    assert got.dtype == op
    if op == BF16:
        want = fused.two_loop_plain(*(t.float() if t is not None and
                                      t.is_floating_point() else t
                                      for t in args), -1.0, mode)
        err = (got.float() - want).abs().amax(1) / \
            want.abs().amax(1).clamp_min(1e-30)
        assert err.max().item() <= 2.0 ** -8
    else:
        want = fused.two_loop_plain(*args, -1.0, mode)
        assert (got - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()


@pytest.mark.parametrize("m", [16, 6])
def test_bf16_plan_layout_agrees_with_the_kernel(cuda, m):
    lib = fused._library()
    for op in (BF16, torch.float32):
        for n in (100, 101, 24):
            plan = fused.launch_plan(64, m, n, fused.KINDS[BF16, op],
                                     fused.num_sms(cuda))
            assert lib.lbfgs_two_loop_smem_bytes(
                m, n, list(fused.SIZES).index(plan.kind), plan.warps,
                plan.stages, int(plan.staged)) == plan.smem_bytes


@pytest.mark.parametrize("case,reason", [
    ("m=200 f32", "shared memory"),
    ("m=120 f64", "shared memory"),
    ("f16", "dtype"),
    ("large n", "large n"),
])
def test_each_plain_route_is_counted_and_launches_nothing(cuda, case,
                                                          reason):
    batch, n, m, dtype = {"m=200 f32": (4, 100, 200, torch.float32),
                          "m=120 f64": (4, 100, 120, torch.float64),
                          "f16": (5, 24, 6, torch.float16),
                          "large n": (1, fused.LARGE_N + 8, 6,
                                      torch.float32)}[case]
    g = torch.Generator(device=cuda).manual_seed(0)
    s = torch.randn(batch, m, n, generator=g, device=cuda).to(dtype)
    y = s + 0.1 * torch.randn(batch, m, n, generator=g,
                              device=cuda).to(dtype)
    h = history.init_history(batch, n, m, dtype, device=cuda,
                             with_rinv=True)
    for k in range(3):
        h, _ = history.update_history(h, s[:, k], y[:, k],
                                      torch.ones(batch, dtype=torch.bool,
                                                 device=cuda))
    v = torch.randn(batch, n, generator=g, device=cuda).to(dtype)
    launches, routes = fused.two_loop.launches, fused.two_loop.plain_routes
    plan, why = fused.route(*_args(h, v), "rinv")
    assert plan is None and why == reason
    got = fused.two_loop(*_args(h, v), -1.0, "rinv")
    want = fused.two_loop_plain(*_args(h, v), -1.0, "rinv")
    torch.cuda.synchronize()
    assert fused.two_loop.launches == launches
    assert fused.two_loop.plain_routes == routes + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("row,op", [(torch.float32, torch.float32),
                                    (BF16, torch.float32)])
def test_long_rows_in_a_full_batch_launch_the_kernel(cuda, row, op):
    """Rows longer than LARGE_N at each type's batch threshold
    (LARGE_N_KERNEL_BATCH_PER_SM per SM) take the kernel, counted as a
    launch, and agree with the plain version."""
    per_sm = fused.LARGE_N_KERNEL_BATCH_PER_SM[fused.KINDS[row, op]]
    batch, m, n = per_sm * fused.num_sms(cuda), 6, fused.LARGE_N + 8
    g = torch.Generator(device=cuda).manual_seed(1)
    s = torch.randn(batch, m, n, generator=g, device=cuda)
    y = s + 0.1 * torch.randn(batch, m, n, generator=g, device=cuda)
    full = torch.full((batch,), m, dtype=torch.int32, device=cuda)
    mats = [0.01 * torch.randn(batch, m, m, generator=g, device=cuda)
            for _ in range(3)]
    args = (s.to(row), y.to(row),
            torch.rand(batch, m, generator=g, device=cuda) + 1.0,
            torch.ones(batch, device=cuda), full, full.clone(), *mats,
            torch.randn(batch, n, generator=g, device=cuda))
    plan, why = fused.route(*args, "rinv")
    assert why is None and plan.kind == fused.KINDS[row, op]
    launches, routes = fused.two_loop.launches, fused.two_loop.plain_routes
    got = fused.two_loop(*args, -1.0, "rinv")
    want = fused.two_loop_plain(*args, -1.0, "rinv")
    torch.cuda.synchronize()
    assert fused.two_loop.launches == launches + 1
    assert fused.two_loop.plain_routes == routes
    assert (got - want).abs().max().item() <= \
        1e-4 * want.abs().max().item()


def test_bf16_rows_solve_launches_its_kernel_once_per_iteration(cuda):
    x0 = np.random.default_rng(0).uniform(-1.0, 1.0, (8, 10))
    p = lt.LBFGSParams(epsilon=1e-4, max_iterations=300)
    fused.reset_counts()
    res = lt.minimize(objectives.rosenbrock,
                      torch.as_tensor(x0, dtype=torch.float32), p,
                      direction="rinv", history_dtype=BF16, device=cuda)
    assert res.history.s.dtype == BF16
    assert fused.two_loop.kind_launches["bf16rows"] == \
        fused.two_loop.launches == int(res.niter.max())
    assert fused.two_loop.plain_routes == 0
    assert (res.x - 1.0).abs().max().item() <= 1e-2


def test_captured_calls_launch_but_count_nothing(cuda):
    """``tools.capture.capture_calls`` stands in for ``fused.two_loop``
    during a solve: every call still goes through the dispatch and the
    kernel, and none counts on the real wrapper."""
    from lbfgspp_tpu_torch.tools.capture import capture_calls
    x0 = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (4, 10)),
                         dtype=torch.float32, device=cuda)
    fused.reset_counts()
    calls = capture_calls(lambda: lt.minimize(
        objectives.rosenbrock, x0, lt.LBFGSParams(max_iterations=5),
        history_dtype=BF16, device=cuda))
    assert len(calls) == 5 and calls[0][0].dtype == BF16
    assert fused.two_loop.launches == 0 and fused.two_loop.plain_routes == 0


# ---------------------------------------------------------------------------
# The native core on the card (csrc/native/batch.cu: one warp per instance),
# held against its host builds (csrc/native/host.cpp) on the same inputs.
# The warp sums each reduction as 32 strided partials and a butterfly, and
# nvcc and g++ (with the JAX module's -march=native) each contract
# multiply-adds into FMAs in their own places, so the default build is held
# to tolerances against the JAX-identical Serial build: the builtin
# quadratic's counts equal and x to 1e-12; on Rosenbrock in random boxes,
# whose solves stop at ~1e-5 projected gradient or a 1e-10 relative change
# of fx, the statuses equal and fx to 1e-6 relative (the parted rounding
# moves x along the flat valleys at an unchanged fx).  The build without
# contraction (contract=False: nvcc -fmad=false) is held bit for bit against
# the host's Lanes build without contraction (g++ -ffp-contract=off), which
# sums as the warp does.
# ---------------------------------------------------------------------------

from lbfgspp_tpu_torch import native  # noqa: E402


@pytest.mark.parametrize("ls", list(native.LS_KINDS))
def test_native_kernel_matches_host_on_quadratics(cuda, ls):
    x0 = np.random.default_rng(4).uniform(-2, 2, (64, 100))
    p = lt.LBFGSParams(epsilon=1e-6, max_iterations=400, max_linesearch=256,
                       m=6)
    native.reset_counts()
    card = native.minimize_batch("quadratic", x0, p, ls, device=cuda)
    torch.cuda.synchronize()
    host = native.minimize_batch("quadratic", x0, p, ls, device="cpu")
    assert native.native_lbfgs_batch.launches == 1
    for f in ("niter", "nfev", "status"):
        assert torch.equal(getattr(card, f).cpu(), getattr(host, f)), f
    assert (card.x.cpu() - host.x).abs().max().item() <= 1e-12


def test_native_rosenbrock_anchor_on_the_card(cuda):
    res = native.minimize("rosenbrock", torch.zeros(10),
                          lt.LBFGSParams(epsilon=1e-6, max_iterations=100))
    assert res.x.device.type == "cuda"
    assert res.niter.item() == 22 and res.status.item() == 1
    assert res.fx.item() <= 1e-12


def _same_bits(xa, oa, xb, ob):
    """x and every output of two native runs, equal bit for bit."""
    for a, b in zip((xa, *oa), (xb, *ob)):
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            a, b = a.view(torch.int64), b.view(torch.int64)
        assert torch.equal(a, b)


def test_native_box_kernel_matches_host(cuda):
    rng = np.random.default_rng(0)
    lb = rng.uniform(-2, 1, (64, 10))
    ub = lb + rng.uniform(0.1, 3, (64, 10))
    x0 = np.clip(rng.uniform(-2, 2, (64, 10)), lb, ub)
    p = lt.LBFGSBParams(max_iterations=200)
    for contract in (True, False):
        native.reset_counts()
        xc, xh = torch.tensor(x0, device=cuda), torch.tensor(x0)
        oc = native.native_lbfgsb_batch(
            "rosenbrock", xc, torch.tensor(lb, device=cuda),
            torch.tensor(ub, device=cuda), p, contract=contract)
        assert native.native_lbfgsb_batch.launches == 1
        if not contract:
            oh = native._lanes_b_batch("rosenbrock", xh, torch.tensor(lb),
                                       torch.tensor(ub), p)
            _same_bits(xc, oc, xh, oh)
            continue
        oh = native.native_lbfgsb_batch("rosenbrock", xh, torch.tensor(lb),
                                        torch.tensor(ub), p)
        assert torch.equal(oc.status.cpu(), oh.status)
        assert ((oc.fx.cpu() - oh.fx).abs() <= 1e-6 * oh.fx.abs()).all()
        assert torch.isfinite(xc).all()


@pytest.mark.parametrize("ls", list(native.LS_KINDS))
def test_native_multistart_bit_identical_without_contraction(cuda, ls):
    """The multistart recipe at full width (B=4096, n=100, m=6): the card's
    build without contraction and the host's Lanes build without
    contraction agree in every instance's niter, nfev and status and in x,
    bit for bit."""
    x0 = np.random.default_rng(0).uniform(-2, 2, (4096, 100))
    p = lt.LBFGSParams(m=6, max_linesearch=256, max_iterations=400)
    xc, xh = torch.tensor(x0, device=cuda), torch.tensor(x0)
    oc = native.native_lbfgs_batch("rosenbrock", xc, p, ls, contract=False)
    oh = native._lanes_batch("rosenbrock", xh, p, ls)
    _same_bits(xc, oc, xh, oh)


@pytest.mark.parametrize("case", [*native.LS_KINDS, "box"])
def test_native_warp_kernels_equal_lanes_at_b37(cuda, case):
    """37 instances (the last block ragged) of each search and of the box
    solve, with starts that converge, hit the cap and fail a search: the
    card without contraction = the Lanes build bit for bit."""
    rng = np.random.default_rng(37)
    x0 = rng.uniform(-3, 3, (37, 10))
    x0[0], x0[1] = 1.0, 1e7
    xc, xh = torch.tensor(x0, device=cuda), torch.tensor(x0)
    if case == "box":
        lb = rng.uniform(-2, 1, (37, 10))
        ub = lb + rng.uniform(0.1, 3, (37, 10))
        lb[:2], ub[:2] = -np.inf, np.inf
        xc, xh = (torch.tensor(np.clip(x0, lb, ub), device=d)
                  for d in (cuda, "cpu"))
        p = lt.LBFGSBParams(max_iterations=15, max_linesearch=3)
        oc = native.native_lbfgsb_batch(
            "rosenbrock", xc, torch.tensor(lb, device=cuda),
            torch.tensor(ub, device=cuda), p, contract=False)
        oh = native._lanes_b_batch("rosenbrock", xh, torch.tensor(lb),
                                   torch.tensor(ub), p)
    else:
        p = lt.LBFGSParams(epsilon=1e-8, max_iterations=40, max_linesearch=3)
        oc = native.native_lbfgs_batch("rosenbrock", xc, p, case,
                                       contract=False)
        oh = native._lanes_batch("rosenbrock", xh, p, case)
    assert native.plan(case == "box", 10, p, cuda).placement == "shared"
    _same_bits(xc, oc, xh, oh)
    assert {1, 3} <= set(oh.status.tolist())


@pytest.mark.parametrize("box", [False, True])
def test_native_global_workspace_at_n4096(cuda, box):
    """At n = 4096 a warp's workspace passes the block's shared-memory
    limit: the plan puts it in device memory, and the card without
    contraction = the Lanes build bit for bit (Rosenbrock, 8 random starts
    to the iteration cap; random boxes for the box solve)."""
    n = 4096
    rng = np.random.default_rng(4096)
    x0 = rng.uniform(-2, 2, (8, n))
    lb = rng.uniform(-2, 1, (8, n))
    ub = lb + rng.uniform(0.1, 3, (8, n))
    p = (lt.LBFGSBParams(max_iterations=30) if box
         else lt.LBFGSParams(max_iterations=60))
    assert native.plan(box, n, p, cuda).placement == "global"
    if box:
        x0 = np.clip(x0, lb, ub)
    xc, xh = torch.tensor(x0, device=cuda), torch.tensor(x0)
    if box:
        oc = native.native_lbfgsb_batch(
            "rosenbrock", xc, torch.tensor(lb, device=cuda),
            torch.tensor(ub, device=cuda), p, contract=False)
        oh = native._lanes_b_batch("rosenbrock", xh, torch.tensor(lb),
                                   torch.tensor(ub), p)
    else:
        oc = native.native_lbfgs_batch("rosenbrock", xc, p, contract=False)
        oh = native._lanes_batch("rosenbrock", xh, p)
    _same_bits(xc, oc, xh, oh)
    assert (oh.status == 3).all()


@pytest.mark.parametrize("ls", ["nocedalwright", "bracketing"])
def test_native_probed_kernel_equals_default(cuda, ls):
    """The multistart recipe at B=4096 through the probed kernel
    (native.probing) and the default one: x and every output bit for bit,
    the same plan, and one summary whose phases fit in the slots' cycles,
    whose instances fit in the launch's warp slots and whose SM clock is
    1-2 GHz."""
    x0 = np.random.default_rng(0).uniform(-2, 2, (4096, 100))
    p = lt.LBFGSParams(m=6, max_linesearch=256, max_iterations=400)
    pl = native.plan(False, 100, p, cuda)
    assert native.plan(False, 100, p, cuda, probed=True) == pl
    native.reset_counts()
    xd, xp = (torch.tensor(x0, device=cuda) for _ in range(2))
    with native.probing(False):
        od = native.native_lbfgs_batch("rosenbrock", xd, p, ls)
    assert native.probe_records() == []
    with native.probing():
        op = native.native_lbfgs_batch("rosenbrock", xp, p, ls)
    _same_bits(xd, od, xp, op)
    (rec,) = native.probe_records()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert rec["batch"] == 4096
    assert rec["slots"] == sms * pl.blocks_per_sm * pl.warps
    assert 0 < rec["eval"] and 0 < rec["search"] and 0 < rec["direction"]
    assert rec["eval"] + rec["search"] + rec["direction"] <= rec["total"]
    assert 0 < rec["busy_ns"] <= rec["slots"] * rec["span_ns"]
    assert 1.0 < rec["total"] / rec["busy_ns"] < 2.0
    assert rec["host_ns"] > 0


def test_native_launch_with_too_many_warps_raises(cuda):
    """A block of 64 warps (2048 threads) is refused by the card; the
    wrapper raises, counts no launch and leaves x as it was: nothing falls
    back to the host build or the eager solver."""
    x0 = torch.rand(37, 10, dtype=torch.float64, device=cuda)
    xs = x0.clone()
    p = lt.LBFGSParams()
    native.reset_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        native._launch(native._device_lib(), False, 0, xs, p, 2,
                       native._outputs(37, cuda), warps=64)
    torch.cuda.synchronize()
    assert torch.equal(xs, x0) and native.native_lbfgs_batch.launches == 0


def test_native_box_recipe_on_the_card(cuda):
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(2, 4, (256, 10)),
                         device=cuda)
    res = native.native_lbfgsb_batch("rosenbrock", x0, torch.full_like(x0, 2),
                                     torch.full_like(x0, 4),
                                     lt.LBFGSBParams())
    xstar = torch.tensor([2.0, 4.0] * 5, dtype=torch.float64, device=cuda)
    assert (res.status == 1).all()
    assert (x0 - xstar).abs().max().item() <= 1e-4


def test_native_multistart_quality_on_the_card(cuda):
    """The multistart recipe (n=100, m=6, max_linesearch=256,
    max_iterations=400) at full width, B=4096: every x finite, and the
    card's share within 1e-4 of the optimum within 0.004 of the host
    build's."""
    x0 = np.random.default_rng(0).uniform(-2, 2, (4096, 100))
    p = lt.LBFGSParams(m=6, max_linesearch=256, max_iterations=400)
    card = native.minimize_batch("rosenbrock", x0, p, device=cuda).x.cpu()
    host = native.minimize_batch("rosenbrock", x0, p, device="cpu").x
    assert torch.isfinite(card).all()

    def frac(x):
        return ((x - 1).abs().max(1).values <= 1e-4).double().mean().item()

    assert abs(frac(card) - frac(host)) <= 0.004

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
and the first design,
``fused.two_loop_simple``, kept as a yardstick.
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
    plan = fused.launch_plan(64, m, n, dtype, fused.num_sms(cuda))
    assert lib.lbfgs_two_loop_smem_bytes(
        m, n, int(dtype == torch.float64), plan.warps, plan.stages,
        int(plan.staged)) == plan.smem_bytes


@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
def test_forced_unstaged_plan_matches_plain(cuda, mode):
    h = _on_card(random_history(5, 24, 6, (0, 6, 9, 2, 7), seed=6), cuda,
                 torch.float64)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((5, 24)),
                        device=cuda)
    plan = fused._layout_plan(5, 6, 24, torch.float64, fused.num_sms(cuda),
                              2, 2, False)
    got = fused._launch(plan, *_args(h, v), -1.0, mode)
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= \
        1e-12 * want.abs().max().item()


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

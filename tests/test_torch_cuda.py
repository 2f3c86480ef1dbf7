"""The CUDA two-loop kernel against its plain version, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports neither JAX nor the JAX package, so it
also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to the largest output entry: 1e-12 in f64 and 1e-5
in f32.  The kernel and the plain version sum in another order, and these
random histories are well conditioned.
"""

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


def _args(h, v):
    return (h.s, h.y, h.ys, h.theta, h.ptr, h.ncorr, h.sy, h.yy, h.rinv, v)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", ["sweeps", "rinv"])
@pytest.mark.parametrize("batch,n,m,ncorrs", [
    (5, 24, 6, (0, 6, 9, 2, 7)),      # mixed fill, wrapped rings
    (3, 40, 1, (0, 1, 3)),
    (4, 33, 33, (0, 5, 33, 70)),
])
def test_kernel_matches_plain(cuda, dtype, rtol, mode, batch, n, m, ncorrs):
    h = random_history(batch, n, m, ncorrs, seed=m)
    h = type(h)(*(t.to(cuda, dtype) if t.is_floating_point() else t.to(cuda)
                  for t in h))
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((batch, n)),
                        dtype=dtype, device=cuda)
    before = fused.two_loop.launches
    got = fused.two_loop(*_args(h, v), -1.0, mode)
    torch.cuda.synchronize()
    assert fused.two_loop.launches == before + 1
    want = fused.two_loop_plain(*_args(h, v), -1.0, mode)
    assert (got - want).abs().max().item() <= \
        rtol * want.abs().max().item()


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

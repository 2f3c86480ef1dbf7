"""The native core's Lanes policy (csrc/native/core.h) on the host, against
the JAX package's native module (lbfgspp_tpu.native).

The card runs the core one warp per instance, each reduction as 32 strided
partials and a butterfly (the Warp policy); the host's Lanes build sums the
same way on one thread, and without multiply-add contraction it is the
card's build without contraction bit for bit (tests/test_torch_cuda.py,
chip_smoke.py phase 26, and the emulated kernels of
tests/test_torch_native_emulated.py).  Here it is held against the JAX
module, which sums in index order (as the port's Serial build does, bit
for bit: tests/test_torch_native.py):

* the builtin quadratic (n = 37, the warp's last lane group ragged):
  niter, nfev and status equal, x to 1e-12;
* Rosenbrock at n = 10 and 100 from random starts, each search, to an
  absolute gradient test of 1e-9: both converge (status 1) and x agrees to
  1e-8 (the two summation orders take different paths: niter differs);
* the reference box example (the chained Rosenbrock as a callable, n = 25):
  13 iterations and fx equal, x to 1e-10;
* the Lanes builds with and without contraction agree on quadratics
  (counts equal, x to 1e-12), as the Serial builds do.
"""

import numpy as np
import pytest
import torch

from lbfgspp_tpu_torch import LBFGSBParams, LBFGSParams, native
from lbfgspp_tpu import native as jnative

from test_torch_native import (box_example, jax_params, np_chained_fg,
                               on_tensors)

LS = list(native.LS_KINDS)


@pytest.mark.parametrize("ls", LS)
def test_lanes_quadratic_counts_equal_jax(ls):
    x0 = np.random.default_rng(37).uniform(-5, 40, (8, 37))
    p = LBFGSParams(epsilon=1e-10, max_iterations=100)
    xs = torch.tensor(x0)
    out = native._lanes_batch("quadratic", xs, p, ls, contract=True)
    for b in range(len(x0)):
        ref = jnative.minimize("quadratic", x0[b], jax_params(p),
                               line_search=ls)
        for f in ("niter", "nfev", "status"):
            assert getattr(out, f)[b].item() == getattr(ref, f), (b, f)
        np.testing.assert_allclose(xs[b].numpy(), ref.x, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ls", LS)
@pytest.mark.parametrize("n", [10, 100])
def test_lanes_rosenbrock_converges_with_jax(ls, n):
    x0 = np.random.default_rng(n).uniform(-2, 2, (6, n))
    p = LBFGSParams(epsilon=1e-9, epsilon_rel=0.0, max_iterations=1000,
                    max_linesearch=256)
    xs = torch.tensor(x0)
    out = native._lanes_batch("rosenbrock", xs, p, ls, contract=True)
    assert (out.status == 1).all()
    for b in range(len(x0)):
        ref = jnative.minimize("rosenbrock", x0[b], jax_params(p),
                               line_search=ls)
        assert ref.status == 1
        np.testing.assert_allclose(xs[b].numpy(), ref.x, rtol=0, atol=1e-8)


def test_lanes_box_example_matches_jax():
    x0, lb, ub = box_example()
    x = torch.tensor(x0)
    status, fx, _, niter, _ = native._ctypes_minimize_b(
        on_tensors(np_chained_fg), x, torch.tensor(lb), torch.tensor(ub),
        LBFGSBParams(), lanes=True)
    ref = jnative.minimize_b(np_chained_fg, x0, lb, ub)
    assert (status, niter) == (ref.status, ref.niter) == (1, 13)
    np.testing.assert_allclose(fx, ref.fx, rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), ref.x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", [*LS, "box"])
def test_lanes_with_and_without_contraction_agree_on_quadratics(case):
    rng = np.random.default_rng(9)
    x0 = rng.uniform(-2, 40, (16, 37))
    lb, ub = torch.full((16, 37), 0.5, dtype=torch.float64), \
        torch.full((16, 37), 20.5, dtype=torch.float64)
    runs = []
    for contract in (True, False):
        if case == "box":
            xs = torch.tensor(x0).clamp(0.5, 20.5)
            out = native._lanes_b_batch(
                "quadratic", xs, lb, ub, LBFGSBParams(epsilon=1e-8),
                contract=contract)
        else:
            xs = torch.tensor(x0)
            out = native._lanes_batch("quadratic", xs,
                                      LBFGSParams(epsilon=1e-8), case,
                                      contract=contract)
        runs.append((xs, out))
    (xa, a), (xb, b) = runs
    for f in ("niter", "nfev", "status"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.status == 1).all()
    assert (xa - xb).abs().max().item() <= 1e-12

"""The port's full pair-space solve ``minimize_df64`` against the JAX
package's, and the bench recipe (tests/test_polish.py:445-461) through the
port on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lbfgspp_tpu as J
import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch.utils import doublefloat as dfl
from lbfgspp_tpu_torch.utils import objectives as to

from test_torch_polish import JFG, N, TFG, assert_counts_equal, starts


def test_minimize_df64_matches_jax():
    """f64 pairs on the quadratic: counts equal JAX's; one start [n] drops
    the batch axis as minimize does."""
    x0s = starts(8)
    p = dict(epsilon=1e-9, max_iterations=100, m=6)
    want = jax.vmap(lambda x: J.minimize_df64(
        fun_and_grad=JFG, x0=x, params=J.LBFGSParams(**p)))(
        jnp.asarray(x0s))
    got = T.minimize_df64(fun_and_grad=TFG, x0=torch.as_tensor(x0s),
                          params=T.LBFGSParams(**p), device="cpu")
    assert_counts_equal(got, want)
    one = T.minimize_df64(fun_and_grad=TFG, x0=torch.as_tensor(x0s[0]),
                          params=T.LBFGSParams(**p), device="cpu")
    assert one.x.shape == (N,) and int(one.niter) == int(got.niter[0])


def test_minimize_df64_rosenbrock_reaches_f64_quality():
    """From f32 inputs the pair-space solve reaches far below the f32
    floor (the JAX file's bars)."""
    p = T.LBFGSParams(epsilon=1e-7, epsilon_rel=1e-7, max_iterations=500)
    res = T.minimize_df64(to.rosenbrock, torch.full((10,), -1.5), p,
                          device="cpu")
    assert int(res.status) == T.Status.CONVERGED_GRAD
    assert res.x.dtype == torch.float32
    assert (res.x.double() - 1.0).abs().max().item() < 1e-6
    assert float(res.fx) < 1e-12


def test_bench_recipe_meets_the_every_run_criterion():
    """tests/test_polish.py:445-461 through the port on the CPU: a
    trial-capped restart main phase, 5 warm df64 polish iterations at the
    full budget and the deep stage on 19% of the batch leave every
    instance within 1e-4."""
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(rng.uniform(-2.0, 2.0, (64, 100)),
                          dtype=torch.float32)
    main = T.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16,
                         max_linesearch=2)
    full = T.LBFGSParams(epsilon=1e-5, max_iterations=162, m=16)
    dfl.FALLBACKS.clear()
    res = T.minimize_batched(to.rosenbrock, x0s, main, polish_iters=5,
                             polish_warm=True, direction="rinv",
                             on_ls_fail="restart", polish_params=full,
                             deep_frac=0.19, deep_iters=60,
                             polish_line_search="morethuente", device="cpu")
    err = (res.x.double() - 1.0).abs().max(dim=1).values
    assert res.x.dtype == torch.float32
    assert torch.isfinite(res.x).all()
    assert (err <= 1e-4).double().mean().item() == 1.0
    assert sum(dfl.FALLBACKS.values()) == 0

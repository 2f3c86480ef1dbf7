"""Every option of the port's ``minimize_batched`` but ``mesh``, against
the JAX package's, in f64 on a diagonal quadratic: per-instance counts
and statuses equal JAX's (the bars of tests/test_torch_polish.py)."""

import jax.numpy as jnp
import pytest
import torch

import lbfgspp_tpu_torch as T
from lbfgspp_tpu import LBFGSParams as JParams
from lbfgspp_tpu import batch as JB
from lbfgspp_tpu_torch import batch as TB

from test_torch_polish import (JFG, P_MAIN, P_POL, TFG, assert_counts_equal,
                               jfg_offset, starts, tfg_offset)

OPTION_SETS = {
    "polish_warm_rinv": dict(polish_iters=8, polish_warm=True,
                             direction="rinv"),
    "polish_shift_restarts": dict(polish_iters=3, polish_shift=True,
                                  polish_restarts=2,
                                  polish_on_ls_fail="restart"),
    "polish_params_fixed": dict(polish_iters=6, drive="fixed"),
    "refine": dict(refine_frac=0.25, refine_iters=10),
    "refine_polish_deep": dict(refine_frac=0.25, refine_iters=3,
                               polish_iters=2, deep_frac=0.25,
                               deep_iters=15),
    "deep_hstep": dict(polish_iters=2, polish_warm=True, direction="rinv",
                       deep_frac=0.25, deep_iters=15, deep_selection="hstep"),
    "on_ls_fail": dict(on_ls_fail="restart", polish_iters=3,
                       params=dict(epsilon=1e-8, max_iterations=6, m=5,
                                   max_linesearch=1)),
}


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_minimize_batched_options_match_jax(name):
    """Every option of minimize_batched but ``mesh``, in f64 on the
    quadratic: per-instance counts and statuses equal JAX's."""
    opts = dict(OPTION_SETS[name])
    pmain = opts.pop("params", P_MAIN)
    polish_params = None
    if name == "polish_params_fixed":
        polish_params = P_POL
    fg_j, fg_t = (jfg_offset, tfg_offset) if "shift" in name else (JFG, TFG)
    x0s = starts(6, 16)
    want = JB.minimize_batched(
        fun_and_grad=fg_j, x0s=jnp.asarray(x0s),
        params=JParams(**pmain),
        polish_params=None if polish_params is None
        else JParams(**polish_params), **opts)
    got = T.minimize_batched(
        fun_and_grad=fg_t, x0s=torch.as_tensor(x0s),
        params=T.LBFGSParams(**pmain),
        polish_params=None if polish_params is None
        else T.LBFGSParams(**polish_params), device="cpu", **opts)
    assert_counts_equal(got, want)


def test_polish_line_search_option():
    """``polish_line_search`` runs the df64 phases on their own search,
    as bench.py does (Nocedal-Wright main, More-Thuente polish): the same
    as the main phase followed by polish_solve with that search."""
    x0s = torch.as_tensor(starts(7))
    p = T.LBFGSParams(**P_MAIN)
    q = T.LBFGSParams(**P_POL)
    got = T.minimize_batched(fun_and_grad=TFG, x0s=x0s, params=p,
                             polish_iters=6, polish_params=q,
                             polish_line_search="morethuente", device="cpu")
    main = T.minimize_batched(fun_and_grad=TFG, x0s=x0s, params=p,
                              device="cpu")
    pol = TB.polish_solve(None, main.x, q, 6, fun_and_grad=TFG,
                          line_search="morethuente", device="cpu")
    want = TB._merge_polished(main, pol)
    for a, b in zip(got[:7], want[:7]):
        assert torch.equal(a, b)

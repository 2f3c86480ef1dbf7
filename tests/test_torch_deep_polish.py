"""The port's deep stage and phase merge (lbfgspp_tpu_torch.batch)
against the JAX package's, with the helpers and bars of
tests/test_torch_polish.py: in f64 on a diagonal quadratic the counts and
statuses equal JAX's per instance and the iterates agree to 1e-10."""

import jax
import numpy as np
import pytest

import lbfgspp_tpu as J
import lbfgspp_tpu_torch as T
from lbfgspp_tpu import batch as JB
from lbfgspp_tpu_torch import batch as TB

from test_torch_polish import (JFG, P_MAIN, P_POL, TFG, assert_counts_equal,
                               main_phase_jax, starts, to_port)


@pytest.mark.parametrize("selection,direction", [("gnorm", "sweeps"),
                                                 ("hstep", "rinv")])
def test_deep_polish_matches_jax(selection, direction):
    """The same k_deep instances are selected for the same carried-over
    input, refined to the same counts, and soft-reset."""
    jmain = main_phase_jax(starts(3, 16), J.LBFGSParams(**P_MAIN),
                           direction=direction)
    main = to_port(jmain)
    jp, tp = J.LBFGSParams(**P_POL), T.LBFGSParams(**P_POL)
    want = JB.deep_polish(None, jmain, jp, 5, 20, fun_and_grad=JFG,
                          direction=direction, selection=selection)
    got = TB.deep_polish(None, main, tp, 5, 20, fun_and_grad=TFG,
                         direction=direction, selection=selection)
    refined = np.asarray(want.history.ncorr) == 0
    assert refined.sum() == 5
    np.testing.assert_array_equal(got.history.ncorr.numpy() == 0, refined)
    assert (got.history.theta.numpy()[refined] == 1.0).all()
    keep = ~refined
    np.testing.assert_array_equal(got.history.s.numpy()[keep],
                                  main.history.s.numpy()[keep])
    np.testing.assert_array_equal(got.x.numpy()[keep], main.x.numpy()[keep])
    assert_counts_equal(got, want)
    with pytest.raises(ValueError, match="selection"):
        TB.deep_polish(None, main, tp, 2, 5, fun_and_grad=TFG,
                       selection="bogus")


def test_merge_polished():
    jmain = main_phase_jax(starts(4), J.LBFGSParams(**P_MAIN))
    main = to_port(jmain)
    pol = TB.polish_solve(None, main.x, T.LBFGSParams(**P_POL), 10,
                          fun_and_grad=TFG, device="cpu")
    merged = TB._merge_polished(main, pol)
    want = JB._merge_polished(jmain, jax.jit(jax.vmap(
        lambda x: JB.polish_solve(None, x, J.LBFGSParams(**P_POL), 10,
                                  fun_and_grad=JFG)))(jmain.x))
    assert_counts_equal(merged, want)
    assert merged.history is main.history

"""``native.minimize_b_batch`` on the host, and the box cell's plain
reference.

The host batch is held bit for bit against ``native.minimize_b`` row by row
(both the ``Serial`` host build) with ``[n]`` and ``[B, n]`` bounds,
infinite bounds and pinned coordinates.  The benchmark's plain reference
(``portbench/reference/rosenbrock10_box.py``) is held iteration for
iteration against the repository's scalar oracle (``tests/oracle_b.py``),
from which it was transcribed, on seeded n = 10 starts of the box cell's
problem (every coordinate in [2, 4] but x[2]); it imports no JAX; and the
card's arithmetic on the host (the ``Lanes`` build of the box kernel,
``native._lanes_b_batch``) agrees with it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import oracle_b
from lbfgspp_tpu_torch import LBFGSBParams, native
from portbench.reference import rosenbrock10_box as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 10
BOUNDS = [[2.0, 4.0]] * N
BOUNDS[2] = [None, None]
OVER = dict(m=6, epsilon=1e-6, max_iterations=60)
PARAMS = LBFGSBParams(**OVER)


def _box_case(case, batch, rng):
    """Starts and bounds of a case: ``lb, ub`` of shape ``[n]`` or
    ``[B, n]``."""
    x0 = rng.uniform(-1, 4, (batch, N))
    lb, ub = ref.box(BOUNDS)
    if case == "rows":
        lb = rng.uniform(-2, 1, (batch, N))
        ub = lb + rng.uniform(0.1, 3, (batch, N))
    elif case == "infinite":
        lb[[0, 5]], ub[[3, 8]] = -np.inf, np.inf
    elif case == "pinned":
        lb = np.tile(lb, (batch, 1))
        ub = np.tile(ub, (batch, 1))
        lb[:, 4] = ub[:, 4] = 3.0
        lb[::2, 7] = ub[::2, 7] = 2.5
    return x0, lb, ub


@pytest.mark.parametrize("case", ["shared", "rows", "infinite", "pinned"])
def test_host_batch_equals_singles(case):
    """Every row of the threaded host batch is its single solve, bit for
    bit: x, fx, niter, nfev and status; the caller's starts untouched."""
    x0, lb, ub = _box_case(case, 12, np.random.default_rng(16))
    x0s = torch.tensor(x0)
    res = native.minimize_b_batch("rosenbrock", x0s, lb, ub, PARAMS,
                                  threads=3, device="cpu")
    assert torch.equal(x0s, torch.tensor(x0))
    assert res.x.shape == (12, N) and res.x.dtype == torch.float64
    for b in range(12):
        rows = [t if t.ndim == 1 else t[b] for t in (lb, ub)]
        one = native.minimize_b("rosenbrock", x0[b], *rows, PARAMS,
                                device="cpu")
        assert torch.equal(res.x[b].view(torch.int64),
                           one.x.view(torch.int64))
        assert res.fx[b].item() == one.fx.item()
        for k in ("niter", "nfev", "status"):
            assert getattr(res, k)[b].item() == getattr(one, k).item(), k
    assert set(res.status.tolist()) <= {1, 2, 3}


@pytest.mark.parametrize("call, error", [
    (lambda: native.minimize_b_batch(lambda x: (x.sum(), x), torch.ones(
        2, N), 0.0, 1.0, device="cpu"), TypeError),
    (lambda: native.minimize_b_batch("rosenbrock", torch.ones(N), 0.0, 1.0,
                                     device="cpu"), ValueError),
])
def test_refusals(call, error):
    """A Python callable (its callbacks would serialize on the interpreter
    lock), and starts that are not [B, n]."""
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_the_oracle_iteration_for_iteration(seed):
    """The reference stopped after each iteration k (``max_iterations``
    k) gives the oracle's iterate k bit for bit, up to the solve's end."""
    x0 = np.random.default_rng(seed).uniform(2, 4, N)
    p = ref.params(dict(OVER, bounds=BOUNDS))
    x, _, status = ref.solve(x0, p)
    assert status in (ref.CONVERGED, ref.CONVERGED_DELTA)
    k = 1
    while True:
        po = oracle_b.default_b_params(**dict(OVER, max_iterations=k))
        want = oracle_b.lbfgsb_minimize(ref.fg, x0, po, p["lb"], p["ub"])
        got = ref.solve(x0, dict(p, max_iterations=k))
        assert np.array_equal(got[0], want[0]), k
        assert got[1] == want[1], k
        if np.array_equal(got[0], x):
            break
        k += 1
    assert k > 5


def test_reference_imports_no_jax():
    code = ("import sys; import portbench.reference.rosenbrock10_box; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'lbfgspp_tpu', 'lbfgspp_tpu_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lanes_build_agrees_with_the_reference():
    """The box kernel's arithmetic on the host (Lanes, no contraction) on
    the cell's problem: each instance ends where the reference's ends,
    within 1e-8, and both meet the cell's bar."""
    x0 = np.random.default_rng(7).uniform(2, 4, (24, N))
    lb, ub = ref.box(BOUNDS)
    xs = torch.tensor(x0)
    out = native._lanes_b_batch("rosenbrock", xs,
                                *(torch.tensor(np.tile(t, (24, 1)))
                                  for t in (lb, ub)), PARAMS)
    p = ref.params(dict(OVER, bounds=BOUNDS))
    want = np.stack([ref.solve(row, p)[0] for row in x0])
    star = np.array([2, 4, 1.4136961582637277, 2, 2, 4, 2, 4, 2, 4])
    assert np.abs(xs.numpy() - want).max() <= 1e-8
    assert np.abs(want - star).max() <= 1e-4
    assert set(out.status.tolist()) <= {1, 2}

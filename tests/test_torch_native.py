"""The port's native core (lbfgspp_tpu_torch.native) on the host, against
the JAX package's (lbfgspp_tpu.native), the NumPy oracles and the port's
own batched solvers.

Every test of tests/test_native.py, on ``device="cpu"`` (the host build
of ``csrc/native/core.h`` / ``lbfgsb.h``), and beside each the JAX
module's result on the same inputs: the host build takes that module's
compiler flags and keeps every arithmetic expression, so x, fx, gnorm,
niter, nfev and status are bit-identical (the four searches at n = 2 and
10, the box example, random boxes, pinned and infinite bounds).  A Python
callable gets an f64 CPU tensor; the JAX module's gets the same numbers as
a numpy array.
"""

import numpy as np
import pytest
import torch

import lbfgspp_tpu_torch as T
from lbfgspp_tpu_torch import LBFGSBParams, LBFGSParams, native
from lbfgspp_tpu_torch.utils import objectives
from lbfgspp_tpu import native as jnative
import lbfgspp_tpu as J

import oracle
import oracle_b

LS = ["backtracking", "bracketing", "nocedalwright", "morethuente"]
FIELDS = ("fx", "gnorm", "niter", "nfev", "status")


def np_rosenbrock(x):
    xe, xo = x[0::2], x[1::2]
    t1, t2 = 1.0 - xe, 10.0 * (xo - xe * xe)
    g = np.zeros_like(x)
    g[1::2] = 20.0 * t2
    g[0::2] = -2.0 * (xe * g[1::2] + t1)
    return float(np.sum(t1 * t1 + t2 * t2)), g


def np_chained_fg(x):
    fx = (x[0] - 1) ** 2 + np.sum(4 * (x[1:] - x[:-1] ** 2) ** 2)
    g = np.zeros_like(x)
    g[0] = 2 * (x[0] - 1) + 16 * (x[0] ** 2 - x[1]) * x[0]
    g[1:] = 8 * (x[1:] - x[:-1] ** 2)
    g[1:-1] += 16 * (x[1:-1] ** 2 - x[2:]) * x[1:-1]
    return float(fx), g


def on_tensors(np_fg):
    """The port's callable form of a numpy objective."""
    return lambda x: np_fg(x.numpy())


def jax_params(p):
    """The JAX package's params with the same fields."""
    cls = J.LBFGSBParams if isinstance(p, LBFGSBParams) else J.LBFGSParams
    return cls(**{f: getattr(p, f) for f in p.__dataclass_fields__})


def assert_same_as_jax(res, ref):
    """The port's NativeResult bit-identical to the JAX module's."""
    assert np.array_equal(res.x.numpy(), ref.x)
    for f in FIELDS:
        assert getattr(res, f).item() == getattr(ref, f), f


@pytest.mark.parametrize("ls", LS)
@pytest.mark.parametrize("n", [2, 10])
def test_matches_oracle_exactly_short_horizon(ls, n):
    """Iteration-exact parity with the oracle over a 25-iteration window,
    and bit-identity with the JAX module on every trial."""
    params = LBFGSParams(epsilon=1e-6, max_iterations=25, max_linesearch=60)
    pdict = oracle.default_params(epsilon=1e-6, max_iterations=25,
                                  max_linesearch=60)
    rng = np.random.default_rng(n)
    for trial in range(5):
        x0 = rng.uniform(-1, 1, n)
        res = native.minimize("rosenbrock", x0, params, line_search=ls,
                              device="cpu")
        out = oracle.lbfgs_minimize(np_rosenbrock, x0, pdict, ls)
        assert res.niter == out["niter"], (ls, n, trial)
        assert res.nfev == out["nfev"], (ls, n, trial)
        np.testing.assert_allclose(res.x.numpy(), out["x"], rtol=1e-6,
                                   atol=1e-8)
        assert_same_as_jax(res, jnative.minimize(
            "rosenbrock", x0, jax_params(params), line_search=ls))


@pytest.mark.parametrize("ls", LS)
def test_full_runs_converge(ls):
    """Full-horizon runs hit the reference multistart tolerance."""
    params = LBFGSParams(epsilon=1e-6, max_iterations=400,
                         max_linesearch=256)
    rng = np.random.default_rng(7)
    for trial in range(20):
        x0 = rng.uniform(-1, 1, 10)
        res = native.minimize("rosenbrock", x0, params, line_search=ls,
                              device="cpu")
        assert np.max(np.abs(res.x.numpy() - 1.0)) <= 1e-4, (ls, trial)


def test_callback_objective_matches_builtin():
    params = LBFGSParams(epsilon=1e-6, max_iterations=100)
    x0 = np.zeros(10)
    r1 = native.minimize("rosenbrock", x0, params, device="cpu")
    r2 = native.minimize(on_tensors(np_rosenbrock), x0, params, device="cpu")
    assert r1.niter == r2.niter == 22
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), rtol=1e-12)
    assert_same_as_jax(r2, jnative.minimize(np_rosenbrock, x0,
                                            jax_params(params)))


def test_matches_jax_solver_exactly():
    import jax.numpy as jnp
    from lbfgspp_tpu.utils.objectives import rosenbrock_fg

    params = LBFGSParams(epsilon=1e-6, max_iterations=100)
    res_j = J.minimize(fun_and_grad=rosenbrock_fg, x0=jnp.zeros(10),
                       params=jax_params(params))
    res_n = native.minimize("rosenbrock", np.zeros(10), params, device="cpu")
    assert res_n.niter == int(res_j.niter)
    assert res_n.status == int(res_j.status)
    np.testing.assert_allclose(res_n.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-12)
    np.testing.assert_allclose(res_n.fx.item(), float(res_j.fx), rtol=1e-10,
                               atol=1e-18)


def test_quadratic_builtin():
    params = LBFGSParams(epsilon=1e-8)
    res = native.minimize("quadratic", np.zeros(12), params, device="cpu")
    np.testing.assert_allclose(res.x.numpy(), np.arange(12.0), atol=1e-6)
    assert res.status in (1, 2)
    assert res.x.dtype == res.fx.dtype == torch.float64
    assert res.niter.dtype == torch.int32


def test_status_codes():
    """An always-NaN objective drives backtracking to its failure statuses
    (max_linesearch / step_too_small), surfaced as codes, not crashes."""
    def bad(x):
        return float("nan"), torch.ones_like(x)

    res = native.minimize(bad, np.ones(4), LBFGSParams(max_iterations=50),
                          line_search="backtracking", device="cpu")
    assert res.status in (12, 13)


def test_callable_errors_are_raised_after_the_solve():
    def broken(x):
        raise KeyError("inside the objective")

    with pytest.raises(KeyError, match="inside the objective"):
        native.minimize(broken, np.ones(4), device="cpu")


@pytest.mark.parametrize("kind", [np.asarray, torch.as_tensor])
@pytest.mark.parametrize("entry", ["minimize", "minimize_b",
                                   "minimize_batch"])
def test_does_not_mutate_x0(kind, entry):
    x0 = kind(np.zeros((2, 10)) if entry == "minimize_batch"
              else np.zeros(10))
    p = LBFGSParams(max_iterations=50)
    if entry == "minimize":
        res = native.minimize("rosenbrock", x0, p, device="cpu")
    elif entry == "minimize_b":
        res = native.minimize_b("rosenbrock", x0, -1.0, 0.5, device="cpu")
    else:
        res = native.minimize_batch("rosenbrock", x0, p, device="cpu")
    assert not np.array_equal(np.asarray(res.x), np.zeros_like(res.x))
    np.testing.assert_array_equal(np.asarray(x0), np.zeros(x0.shape))


def box_example():
    n = 25
    lb = np.full(n, 2.0)
    ub = np.full(n, 4.0)
    lb[2], ub[2] = -np.inf, np.inf
    x0 = np.full(n, 3.0)
    x0[0] = x0[1] = 2.0
    x0[5] = x0[7] = 4.0
    return x0, lb, ub


def test_lbfgsb_box_example_matches_oracle():
    """Reference box example (example-rosenbrock-box.cpp setup): exact
    iteration parity with the index-set oracle, bit-identity with the JAX
    module."""
    x0, lb, ub = box_example()
    res = native.minimize_b(on_tensors(np_chained_fg), x0, lb, ub,
                            device="cpu")
    xo, fo, go, pgo, ko = oracle_b.lbfgsb_minimize(
        np_chained_fg, x0, oracle_b.default_b_params(), lb, ub)
    assert res.niter == ko
    np.testing.assert_allclose(res.x.numpy(), xo, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(res.fx.item(), fo, rtol=1e-11)
    assert_same_as_jax(res, jnative.minimize_b(np_chained_fg, x0, lb, ub))


@pytest.mark.parametrize("seed", range(4))
def test_lbfgsb_random_matches_oracle(seed):
    """Random coupled quadratics with random bounds: trajectory parity with
    the oracle, bit-identity with the JAX module."""
    rng = np.random.default_rng(300 + seed)
    n = 9
    a_half = rng.standard_normal((n, n)) / np.sqrt(n)
    a = a_half @ a_half.T + 0.5 * np.eye(n)
    b = rng.standard_normal(n)
    lb = rng.standard_normal(n) - 1.5
    ub = lb + 1.0 + rng.random(n)
    x0 = np.clip(rng.standard_normal(n), lb, ub)

    def fg(x):
        ax = a @ x
        return float(0.5 * x @ ax + b @ x), ax + b

    res = native.minimize_b(on_tensors(fg), x0, lb, ub, device="cpu")
    xo, fo, go, pgo, ko = oracle_b.lbfgsb_minimize(
        fg, x0, oracle_b.default_b_params(), lb, ub)
    assert res.niter == ko, seed
    np.testing.assert_allclose(res.x.numpy(), xo, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(res.fx.item(), fo, rtol=1e-10, atol=1e-12)
    assert_same_as_jax(res, jnative.minimize_b(fg, x0, lb, ub))


@pytest.mark.parametrize("objective", ["callable", "quadratic"])
def test_lbfgsb_pinned_and_infinite(objective):
    n = 8
    lb = np.full(n, -5.0)
    ub = np.full(n, 5.0)
    lb[3] = ub[3] = 2.5
    lb[6], ub[6] = -np.inf, np.inf
    d = np.arange(n, dtype=float)

    def fg(x):
        r = x - d
        return float(r @ r), 2.0 * r

    p = LBFGSBParams(epsilon=1e-8, epsilon_rel=0.0)
    fun, jfun = (on_tensors(fg), fg) if objective == "callable" \
        else ("quadratic", "quadratic")
    res = native.minimize_b(fun, np.zeros(n), lb, ub, p, device="cpu")
    want = np.clip(d, lb, ub)
    np.testing.assert_allclose(res.x.numpy(), want, atol=1e-5)
    assert res.x[3] == 2.5
    assert_same_as_jax(res, jnative.minimize_b(jfun, np.zeros(n), lb, ub,
                                               jax_params(p)))


def test_random_boxes_builtin_match_jax():
    """The builtin Rosenbrock over random boxes (chip_smoke.py phase 26's
    check, at B = 16), single solves and the wrapper's host path, against
    the JAX module."""
    rng = np.random.default_rng(11)
    lb = rng.uniform(-2, 1, (16, 10))
    ub = lb + rng.uniform(0.1, 3, (16, 10))
    x0 = np.clip(rng.uniform(-2, 2, (16, 10)), lb, ub)
    p = LBFGSBParams(max_iterations=200)
    xs = torch.tensor(x0)
    out = native.native_lbfgsb_batch("rosenbrock", xs, torch.tensor(lb),
                                     torch.tensor(ub), p)
    for b in range(16):
        ref = jnative.minimize_b("rosenbrock", x0[b], lb[b], ub[b],
                                 jax_params(p))
        res = native.NativeResult(xs[b], *(t[b] for t in out))
        assert_same_as_jax(res, ref)


def test_fastcall_matches_ctypes_path():
    """The CPython binding and the ctypes binding are two bindings of the
    same host build and return identical results."""
    p = LBFGSParams(epsilon=1e-6, max_iterations=100)
    fast = native.minimize("rosenbrock", np.zeros(10), p, device="cpu")
    x = torch.zeros(10, dtype=torch.float64)
    slow = native._ctypes_minimize("rosenbrock", x, p, "nocedalwright")
    assert slow == tuple(getattr(fast, f).item() for f in
                         ("status", "fx", "gnorm", "niter", "nfev"))
    assert torch.equal(fast.x, x)

    lb, ub = np.full(10, 2.0), np.full(10, 4.0)
    fastb = native.minimize_b("rosenbrock", np.full(10, 3.0), lb, ub,
                              device="cpu")
    xb = torch.full((10,), 3.0, dtype=torch.float64)
    slowb = native._ctypes_minimize_b("rosenbrock", xb, torch.tensor(lb),
                                      torch.tensor(ub), LBFGSBParams())
    assert slowb == tuple(getattr(fastb, f).item() for f in
                          ("status", "fx", "gnorm", "niter", "nfev"))
    assert torch.equal(fastb.x, xb)


@pytest.mark.parametrize("threads", [1, None])
def test_minimize_batch_matches_singles(threads):
    """The threaded batch is the same core fanned over threads: every
    instance bit-identical to its single solve, at one thread and at one
    per core."""
    rng = np.random.default_rng(5)
    x0s = rng.uniform(-2.0, 2.0, (32, 10))
    p = LBFGSParams(epsilon=1e-6, max_iterations=200)
    rb = native.minimize_batch("rosenbrock", x0s, p, threads=threads,
                               device="cpu")
    for i in range(8):
        s = native.minimize("rosenbrock", x0s[i], p, device="cpu")
        assert s.niter == rb.niter[i] and s.fx == rb.fx[i]
        assert s.status == rb.status[i] and s.nfev == rb.nfev[i]
        assert torch.equal(s.x, rb.x[i])
    with pytest.raises(TypeError):
        native.minimize_batch(lambda x: (0.0, x), x0s, p, device="cpu")


@pytest.mark.parametrize("entry", ["minimize", "minimize_b"])
@pytest.mark.parametrize("device", [None, "cuda"])
def test_callable_on_the_card_raises(entry, device):
    """A callable runs on the host build only: on the default device (the
    card) it raises instead of moving to the host."""
    def fg(x):
        return float((x * x).sum()), 2 * x

    call = (lambda **kw: native.minimize(fg, np.ones(4), **kw)) \
        if entry == "minimize" else \
        (lambda **kw: native.minimize_b(fg, np.ones(4), -1.0, 1.0, **kw))
    with pytest.raises(ValueError, match="device='cpu'"):
        call(device=device)


def test_bad_builtin_arguments_raise():
    with pytest.raises(ValueError, match="even"):
        native.minimize("rosenbrock", np.zeros(5), device="cpu")
    with pytest.raises(ValueError, match="unknown builtin"):
        native.minimize("himmelblau", np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="unknown line search"):
        native.minimize("quadratic", np.zeros(4), line_search="wolfe",
                        device="cpu")


@pytest.mark.parametrize("ls", LS)
def test_batch_equals_plain_batched_lbfgs_on_quadratics(ls):
    """The native batch against the port's batched lbfgs.minimize (the
    kernel's plain version) on the builtin quadratic: counts and statuses
    equal instance for instance, x to 1e-12."""
    rng = np.random.default_rng(21)
    x0s = rng.uniform(-5, 5, (6, 12))
    p = LBFGSParams(epsilon=1e-10, max_iterations=50, m=5)
    res = native.minimize_batch("quadratic", x0s, p, ls, device="cpu")
    ref = T.minimize(fun_and_grad=objectives.quadratic_fg,
                     x0=torch.tensor(x0s), params=p, line_search=ls,
                     device="cpu")
    for f in ("niter", "nfev", "status"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-12)


def test_box_example_equals_plain_lbfgsb():
    """The box example through the native core and the port's
    lbfgsb.minimize(gcp="scan"): iteration for iteration."""
    x0, lb, ub = box_example()

    def chained(x):
        return objectives.rosenbrock_chained_fg(x)

    res = native.minimize_b(lambda x: tuple(
        t.item() if t.dim() == 0 else t for t in chained(x)), x0, lb, ub,
        device="cpu")
    ref = T.minimize_b(fun_and_grad=chained, x0=torch.tensor(x0),
                       lb=torch.tensor(lb), ub=torch.tensor(ub), gcp="scan",
                       device="cpu")
    assert res.niter == ref.niter and res.status == ref.status
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("threads", [1, None])
def test_builds_without_contraction_agree_on_quadratics(threads):
    """``contract=False`` takes the host build compiled with
    ``-ffp-contract=off`` (the card's counterpart is nvcc's
    ``-fmad=false``): on quadratics it takes the default build's counts
    and agrees in x to 1e-12, through both batch wrappers."""
    rng = np.random.default_rng(8)
    x0 = rng.uniform(-2, 2, (16, 12))
    p = LBFGSParams(epsilon=1e-8, max_iterations=100)
    pb = LBFGSBParams(epsilon=1e-8, max_iterations=100)
    lb, ub = torch.full((16, 12), -0.5, dtype=torch.float64), \
        torch.full((16, 12), 0.5, dtype=torch.float64)
    runs = []
    for contract in (True, False):
        xs, xb = torch.tensor(x0), torch.tensor(x0).clamp(-0.5, 0.5)
        out = native.native_lbfgs_batch("quadratic", xs, p, "morethuente",
                                        threads=threads, contract=contract)
        outb = native.native_lbfgsb_batch("quadratic", xb, lb, ub, pb,
                                          threads=threads,
                                          contract=contract)
        runs.append((xs, out, xb, outb))
    (xs, out, xb, outb), (xs0, out0, xb0, outb0) = runs
    for a, b in ((out, out0), (outb, outb0)):
        for f in ("niter", "nfev", "status"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert (a.status == 1).all()
    assert (xs - xs0).abs().max().item() <= 1e-12
    assert (xb - xb0).abs().max().item() <= 1e-12

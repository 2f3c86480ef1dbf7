"""The port's double-float arithmetic and df64 interpreter against the JAX
package's (lbfgspp_tpu.utils.doublefloat) and against f64.

The error-free transforms, the pair ops and the compensated sums run the
same operations in the same order as the JAX package, so on the same numpy
inputs they must agree BIT FOR BIT, in f32 and f64 pairs.  The
transcendentals too, except that ``log`` seeds its Newton steps with the
base library's log, which differs from XLA's by an ulp on some inputs:
there they are bit-identical where the seeds agree and within pair
precision elsewhere.  The interpreter runs an aten graph where JAX runs a
jaxpr, so its results agree to 1 f32 ulp (up to the JAX interpreter's own
error, see test_pair_oracle_matches_jax) and meet the JAX file's bars
against f64.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.utils import doublefloat as J
from lbfgspp_tpu.utils import objectives as jo
from lbfgspp_tpu_torch import make_fun_and_grad
from lbfgspp_tpu_torch.utils import doublefloat as T
from lbfgspp_tpu_torch.utils import objectives as to

DTYPES = [np.float32, np.float64]


def pairs(seed, size, dtype, lo_scale=1.0, positive=False, scale=5.0):
    """Random (hi, lo) numpy pairs with fl(hi + lo) == hi."""
    rng = np.random.default_rng(seed)
    hi = rng.uniform(0.0 if positive else -scale, scale, size).astype(dtype)
    lo = (hi * rng.uniform(-0.5, 0.5, size) * np.finfo(dtype).eps
          * lo_scale).astype(dtype)
    return hi, lo


def both(hi, lo):
    return (J.DF(jnp.asarray(hi), jnp.asarray(lo)),
            T.DF(torch.as_tensor(hi), torch.as_tensor(lo)))


def same_bits(j, t, mask=None):
    jh, jl = np.asarray(j.hi), np.asarray(j.lo)
    th, tl = t.hi.numpy(), t.lo.numpy()
    if mask is not None:
        jh, jl, th, tl = jh[mask], jl[mask], th[mask], tl[mask]
    for a, b in ((th, jh), (tl, jl)):
        np.testing.assert_array_equal(np.ravel(a).view(np.uint8),
                                      np.ravel(b).view(np.uint8))


def value(p):
    return np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64)


def test_two_sum_two_prod_exact_against_f64():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(-10, 10, 4096), dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(-1e-4, 1e-4, 4096), dtype=torch.float32)
    s, e = T.two_sum(a, b)
    np.testing.assert_array_equal(s.double() + e.double(),
                                  a.double() + b.double())
    b = torch.as_tensor(rng.uniform(-30, 30, 4096), dtype=torch.float32)
    p, e = T.two_prod(a, b)
    np.testing.assert_array_equal(p.double() + e.double(),
                                  a.double() * b.double())


def test_f64_pair_transforms_exact_against_rationals():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.uniform(-10, 10, 64))
    b = torch.as_tensor(rng.uniform(-10, 10, 64))
    p, e = T.two_prod(a, b)
    s, f = T.two_sum(a, b * 1e-9)
    for i in range(64):
        fa, fb = fractions.Fraction(a[i].item()), fractions.Fraction(b[i].item())
        assert fractions.Fraction(p[i].item()) + \
            fractions.Fraction(e[i].item()) == fa * fb
        assert fractions.Fraction(s[i].item()) + \
            fractions.Fraction(f[i].item()) == \
            fa + fractions.Fraction((b[i] * 1e-9).item())


def test_constant_operand_and_square_patterns_exact():
    """The two patterns compilers break (doublefloat.py:80-101): a square,
    held against rationals, and a sum with a constant operand,
    ``1 + x``, whose residual a compiler folds away; eager ops round once
    each, so both equal the JAX package's eager results bit for bit."""
    hi_np = np.linspace(-0.34, 0.34, 64).astype(np.float32)
    lo_np = np.linspace(1e-9, -1e-9, 64).astype(np.float32)
    ja, a = both(hi_np, lo_np)
    sq = T.mul(a, a)
    for i in range(64):
        v = fractions.Fraction(float(hi_np[i])) + \
            fractions.Fraction(float(lo_np[i]))
        got = fractions.Fraction(sq.hi[i].item()) + \
            fractions.Fraction(sq.lo[i].item())
        assert abs(float(got - v * v)) < 1e-15
    same_bits(J.mul(ja, ja), sq)
    one = T.add(T.lift(torch.ones_like(a.hi)), a)
    assert (one.lo != 0).any()
    same_bits(J.add(J.lift(jnp.ones_like(ja.hi)), ja), one)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "neg", "sqrt"])
def test_pair_ops_bit_identical_to_jax(op, dtype):
    (ja, ta) = both(*pairs(2, 4096, dtype, positive=op == "sqrt"))
    (jb, tb) = both(*pairs(3, 4096, dtype))
    if op in ("neg", "sqrt"):
        same_bits(getattr(J, op)(ja), getattr(T, op)(ta))
    else:
        same_bits(getattr(J, op)(ja, jb), getattr(T, op)(ta, tb))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape,axes", [((1025,), (0,)), ((37, 100), (1,)),
                                        ((5, 7, 9), (0, 2)), ((0,), (0,))])
def test_df_sum_bit_identical_to_jax(shape, axes, dtype):
    size = int(np.prod(shape))
    hi, lo = pairs(4, size, dtype)
    ja, ta = both(hi.reshape(shape), lo.reshape(shape))
    same_bits(J.df_sum(ja, axes), T.df_sum(ta, axes))


def test_df_dot_bit_identical_to_jax():
    for dtype in DTYPES:
        ja, ta = both(*pairs(5, 1024, dtype))
        jb, tb = both(*pairs(6, 1024, dtype))
        same_bits(J.df_dot(ja, jb), T.df_dot(ta, tb))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("op", ["exp", "expm1", "logistic", "tanh", "log",
                                "log1p"])
def test_transcendentals_bit_identical_to_jax(op, dtype):
    hi, lo = pairs(7, 4096, dtype, positive=op in ("log", "log1p"),
                   scale=30.0 if op != "log1p" else 3.0)
    ja, ta = both(hi, lo)
    mask = None
    if op in ("log", "log1p"):
        seed_in = hi if op == "log" else np.array(
            J.add(J.lift(jnp.ones_like(ja.hi)), ja).hi)
        mask = np.asarray(jnp.log(jnp.asarray(seed_in))) == \
            torch.log(torch.as_tensor(seed_in)).numpy()
        assert mask.mean() > 0.5
    jo_, to_ = getattr(J, op)(ja), getattr(T, op)(ta)
    same_bits(jo_, to_, mask)
    err = np.abs(value(jo_) - value(to_)) / np.maximum(np.abs(value(jo_)), 1)
    assert err.max() < (5e-14 if dtype == np.float32 else 1e-28)


def test_transcendental_pair_accuracy_through_the_interpreter():
    """The JAX file's bar: |err| / max(|f|, 1) < 5e-12 against f64, f32
    pairs, through df64ify of torch functions."""
    c01 = np.float64(np.float32(0.01))
    c17 = np.float64(np.float32(1.7))
    c05 = np.float64(np.float32(0.5))
    x32 = torch.as_tensor(np.linspace(-10, 10, 81), dtype=torch.float32)
    cases = [
        (torch.exp, np.exp),
        (lambda v: torch.log(torch.abs(v) + 0.5),
         lambda v: np.log(np.abs(v) + c05)),
        (lambda v: torch.log1p(v * 0.01), lambda v: np.log1p(v * c01)),
        (lambda v: torch.expm1(v * 0.01), lambda v: np.expm1(v * c01)),
        (torch.sigmoid, lambda v: 1 / (1 + np.exp(-v))),
        (torch.tanh, np.tanh),
        (lambda v: torch.log1p(torch.exp(v)), lambda v: np.logaddexp(0, v)),
        (lambda v: (torch.abs(v) + 0.5) ** 1.7,
         lambda v: (np.abs(v) + c05) ** c17),
        (lambda v: torch.exp2(v * 0.5), lambda v: np.exp2(v * c05)),
    ]
    T.FALLBACKS.clear()
    for fn, ref in cases:
        out = T.df64ify(fn, to_native=False)(x32)
        got = out.hi.double().numpy() + out.lo.double().numpy()
        want = ref(x32.double().numpy())
        err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
        assert err < 5e-12, (fn, err)
    assert sum(T.FALLBACKS.values()) == 0, dict(T.FALLBACKS)


def test_f64_pair_exp_log_identity():
    x = T.lift(torch.as_tensor(np.linspace(0.1, 30, 31)))
    d = T.sub(T.log(T.exp(x)), x)
    diff = d.hi.abs() + d.lo.abs()
    assert (diff / x.hi).max().item() < 1e-25


def test_exp2_of_integer_is_exact():
    k = torch.as_tensor(np.arange(-30, 31), dtype=torch.float32)
    out = T.exp(T.mul(T.lift(k), T._ln2(k)))
    got = out.hi.double() + out.lo.double()
    np.testing.assert_allclose(got.numpy(), np.exp2(np.arange(-30, 31.0)),
                               rtol=3e-14)
    for dtype in (torch.float32, torch.float64):
        kk = torch.arange(-140, 128, dtype=dtype)
        np.testing.assert_array_equal(
            T._pow2(kk, dtype).double().numpy(),
            np.exp2(kk.double().numpy()))


def test_saturation_guards():
    x = torch.tensor([-100.0, -88.0, 0.0, 88.0, 100.0])
    s = T.df64ify(torch.sigmoid, to_native=False)(x)
    got = s.hi.double() + s.lo.double()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               1 / (1 + np.exp(-x.double().numpy())),
                               atol=1e-13)
    e = T.df64ify(torch.expm1, to_native=False)(torch.tensor([100.0, -100.0]))
    assert torch.isinf(e.hi[0]) and abs(e.hi[1].item() + 1.0) < 1e-6
    pw = T.df64ify(lambda v: v ** 2.0, to_native=False)(
        torch.tensor([-3.0, 0.0]))
    np.testing.assert_allclose(pw.hi.numpy(), [9.0, 0.0], atol=1e-6)
    t = T.df64ify(torch.tanh, to_native=False)(torch.tensor([-100.0, 100.0]))
    np.testing.assert_allclose((t.hi.double() + t.lo.double()).numpy(),
                               [-1.0, 1.0], atol=1e-14)


def test_nonfinite_matches_native():
    def L(v):
        return T.lift(torch.tensor(v, dtype=torch.float32))

    def tf(p):
        return T.to_float(p).item()

    inf = float("inf")
    assert tf(T.add(L(inf), L(1.0))) == inf
    assert tf(T.sub(L(-inf), L(5.0))) == -inf
    assert tf(T.mul(L(inf), L(2.0))) == inf
    assert tf(T.div(L(inf), L(2.0))) == inf
    assert tf(T.div(L(1.0), L(0.0))) == inf
    assert tf(T.sqrt(L(inf))) == inf
    assert np.isnan(tf(T.add(L(inf), L(-inf))))
    assert np.isnan(tf(T.div(L(inf), L(inf))))
    assert np.isnan(tf(T.mul(L(float("nan")), L(2.0))))
    assert abs(tf(T.mul(L(1e35), L(1e-10))) - 1e25) < 1e19
    assert tf(T.add(L(3e38), L(3e38))) == inf


def test_interpreter_nonfinite_compare_and_minmax():
    x = torch.tensor([1.0, float("inf"), float("-inf")])
    out = T.df64ify(lambda v: torch.where(torch.isinf(v), -1.0, v * 2.0))(x)
    np.testing.assert_array_equal(out.numpy(), [2.0, -1.0, -1.0])
    lt = T.df64ify(lambda v: (v < 0).to(torch.float32))(x)
    np.testing.assert_array_equal(lt.numpy(), [0.0, 0.0, 1.0])
    xn = torch.tensor([float("nan"), -2.0, 3.0])
    mx = T.df64ify(lambda v: torch.clamp(v, min=0.0))(xn).numpy()
    assert np.isnan(mx[0]) and mx[1] == 0.0 and mx[2] == 3.0
    mn = T.df64ify(lambda v: torch.minimum(v, torch.zeros_like(v)))(xn)
    assert np.isnan(mn[0].item()) and mn[1] == -2.0 and mn[2] == 0.0


def test_empty_reduction_and_half_precision():
    z = T.df64ify(torch.sum)(torch.zeros(0))
    assert z.item() == 0.0

    def mixed(v):
        y = v.to(torch.bfloat16) * 2.0
        return torch.sum(y.to(torch.float32) * v)

    T.FALLBACKS.clear()
    out = T.df64ify(mixed)(torch.tensor([1.0, 2.0]))
    assert abs(out.item() - 10.0) < 1e-5
    # rounding to bfloat16 is an op without a pair rule
    assert T.FALLBACKS["_to_copy"] == 1


def ulp_diff(got, want):
    """|got - want| in f32 ulps of ``want``."""
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float64) - want.astype(np.float64)) / \
        np.spacing(np.abs(want)).astype(np.float64)


def assert_close_to_jax(got, jax_out, f64):
    """Within 1 f32 ulp of JAX's result plus JAX's own ulps from f64,
    and within 1 ulp of f64 (rounded to f32)."""
    ref = np.asarray(f64).astype(np.float32)
    jerr = ulp_diff(jax_out, ref)
    assert (ulp_diff(got, jax_out) <= 1.0 + jerr).all()
    assert (ulp_diff(got, ref) <= 1.0).all()


def _structural(x):
    a, b = x[0::2], x[1::2]
    c = torch.where(a > b, a, b)
    return torch.sum(torch.cat([c, a[:3]]).reshape(-1) ** 3) + \
        torch.dot(x[:4], x[4:8])


def _jstructural(x):
    a, b = x[0::2], x[1::2]
    c = jnp.where(a > b, a, b)
    return jnp.sum(jnp.concatenate([c, a[:3]]).reshape(-1) ** 3) + \
        jnp.dot(x[:4], x[4:8])


OBJECTIVES = {
    "rosenbrock": (dict(fun=to.rosenbrock), dict(fun=jo.rosenbrock),
                   jo.rosenbrock),
    "rosenbrock_fg": (dict(fun_and_grad=to.rosenbrock_fg),
                      dict(fun_and_grad=jo.rosenbrock_fg), jo.rosenbrock),
    "quadratic": (dict(fun=to.quadratic), dict(fun=jo.quadratic),
                  jo.quadratic),
    "structural": (dict(fun=_structural), dict(fun=_jstructural),
                   _jstructural),
}


def _f64_value_and_grad(f64, x):
    fx, g = jax.vmap(jax.value_and_grad(f64))(jnp.asarray(x, jnp.float64))
    return np.asarray(fx), np.asarray(g)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_pair_oracle_matches_jax(name):
    """fx and the gradient within 1 f32 ulp of JAX's, up to JAX's own
    error against f64, and within 1 ulp of f64.  The JAX interpreter
    rounds two primitives to f32 for want of a rule: ``add_any`` (AD's
    sum of cotangents) and ``jit`` (``jnp.where`` is one), so where they
    occur the port, whose aten graph has ``add`` and ``where``, is the
    closer to f64.  Both meet the JAX file's bars."""
    tkw, jkw, f64 = OBJECTIVES[name]
    rng = np.random.default_rng(8)
    hi = rng.uniform(-2, 2, (16, 20)).astype(np.float32)
    lo = (hi * rng.uniform(-0.5, 0.5, hi.shape) * 2.0 ** -24).astype(
        np.float32)
    x2 = np.concatenate([hi, lo], axis=1)
    T.FALLBACKS.clear()
    fx, g = T.df64_pair_fun_and_grad(**tkw)(torch.as_tensor(x2))
    if "fun" in jkw:
        jfg2 = J.df64_pair_fun_and_grad(jkw["fun"])
    else:
        jfg2 = J.df64_pair_fun_and_grad(fun_and_grad=jkw["fun_and_grad"])
    jfx, jg = jax.vmap(jfg2)(jnp.asarray(x2))
    exact = hi.astype(np.float64) + lo.astype(np.float64)
    fx64, g64 = _f64_value_and_grad(f64, exact)
    g64 = np.concatenate([g64, g64], axis=1)
    assert sum(T.FALLBACKS.values()) == 0, dict(T.FALLBACKS)
    assert_close_to_jax(fx.numpy(), jfx, fx64)
    assert_close_to_jax(g.numpy(), jg, g64)
    # the JAX file's value bar against f64
    assert np.all(np.abs(fx.numpy() - fx64) <=
                  2 * np.finfo(np.float32).eps * np.abs(fx64) + 1e-9)


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_df64ify_matches_jax(name):
    """``df64ify`` of the batched value-and-gradient at native f32 points,
    against the JAX interpreter's (same bars as above)."""
    tkw, jkw, f64 = OBJECTIVES[name]
    x = np.random.default_rng(9).uniform(-2, 2, (16, 20)).astype(np.float32)
    fx, g = T.df64ify(make_fun_and_grad(**tkw))(torch.as_tensor(x))
    jvg = jax.value_and_grad(jkw["fun"]) if "fun" in jkw \
        else jkw["fun_and_grad"]
    jfx, jg = jax.vmap(J.df64ify(jvg))(jnp.asarray(x))
    fx64, g64 = _f64_value_and_grad(f64, x)
    assert_close_to_jax(fx.numpy(), jfx, fx64)
    assert_close_to_jax(g.numpy(), jg, g64)


def test_pair_gradient_near_optimum_beats_f32():
    """The JAX file's bar: near x = 1 the f32 gradient carries ~1e-5 of
    rounding noise; the pair gradient is accurate to the f32 rounding of
    the true one."""
    rng = np.random.default_rng(42)
    x32 = (1.0 + rng.uniform(-1e-4, 1e-4, (4, 100))).astype(np.float32)
    _, g_true = jax.vmap(jo.rosenbrock_fg)(jnp.asarray(x32, jnp.float64))
    g_true = np.asarray(g_true)
    _, g32 = make_fun_and_grad(to.rosenbrock)(torch.as_tensor(x32))
    _, gdf = T.df64_fun_and_grad(to.rosenbrock)(torch.as_tensor(x32))
    err32 = np.max(np.abs(g32.double().numpy() - g_true))
    errdf = np.max(np.abs(gdf.double().numpy() - g_true))
    assert errdf < err32 / 50.0 and errdf < 5e-8


def test_fallbacks_are_counted_and_graphs_cached():
    """The main path's objective takes no fallback; an op without a rule
    is counted; a second call at the same shape reuses the graph."""
    T.FALLBACKS.clear()
    fg2 = T.df64_pair_fun_and_grad(to.rosenbrock)
    x2 = torch.zeros(6, 40)
    fg2(x2)
    traces = len(T._TRACES)
    fg2(x2 + 1.0)
    T.df64_pair_fun_and_grad(to.rosenbrock)(x2)
    assert len(T._TRACES) == traces
    assert sum(T.FALLBACKS.values()) == 0
    T.df64ify(lambda v: torch.floor(v * 3.0))(torch.ones(3))
    assert T.FALLBACKS["floor"] == 1


def test_pair_to_float_and_shift():
    x2 = torch.tensor([[1.0, 2.0, 0.5, -0.25]])
    np.testing.assert_array_equal(T.pair_to_float(x2).numpy(),
                                  [[1.5, 1.75]])
    x = torch.full((2, 6), 1.5)
    ref = T.df64_value(to.rosenbrock)(x)
    fx, _ = T.df64_pair_fun_and_grad(to.rosenbrock, shift=tuple(ref))(
        torch.cat([x, torch.zeros_like(x)], dim=1))
    np.testing.assert_array_equal(fx.numpy(), [0.0, 0.0])

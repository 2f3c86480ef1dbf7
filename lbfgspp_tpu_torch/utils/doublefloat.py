"""Double-float ("df64") arithmetic and the df64 interpreter.

The port's counterpart of ``lbfgspp_tpu.utils.doublefloat``: the classical
error-free transforms (Dekker 1971, Knuth TAOCP 4.2.2, Hida-Li-Bailey's QD)
over pairs ``(hi, lo)`` of native floats with ``fl(hi + lo) == hi``, about
twice the base mantissa, and an interpreter that re-evaluates a traced
objective with every arithmetic op replaced by its pair rule.  The df64
polish of :mod:`..batch` runs on it.

Two layers, as in the JAX package:

* pair ops on tensors: :func:`two_sum`, :func:`two_prod`, :func:`add`,
  :func:`mul`, :func:`div`, :func:`sqrt`, the transcendentals and
  :func:`df_sum` (a halving tree, in the JAX package's order, so the
  sums are bit-identical to its sums);
* :func:`df64ify`: records an aten graph of a (batched) function with
  ``make_fx`` and interprets it node by node with pair rules.  Data
  movement applies to both words; an op without a rule falls back to the
  hi word and is counted in :data:`FALLBACKS`.

Exactness on the card.  Each pair op is a chain of eager PyTorch ops, one
rounding each; nothing here is compiled, so no compiler can fold
``(x + c) - c`` or contract ``a * b + e`` into an FMA (the two hazards the
JAX package pins its transforms against, doublefloat.py:80-101).  This
module must therefore never run under ``torch.compile``, and it emits only
plain binary ``+ - * /`` (no ``alpha``, ``addcmul``, ``addcdiv`` or
``lerp``).  Divisors are tensors on the operands' device, never Python
scalars: a CUDA division by a CPU scalar is a multiplication by its
reciprocal.  Powers of two come from the exponent bits, as
``torch.ldexp``/``torch.exp2`` are not guaranteed exact on the card.
"""

from __future__ import annotations

import collections
import fractions
import math
import operator
from functools import lru_cache
from typing import Callable, NamedTuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.node import Node, map_arg
from torch.utils import _pytree as pytree

from ..types import make_fun_and_grad

Tensor = torch.Tensor

# Ops without a pair rule that were evaluated through their hi+lo words
# (rounded to the base precision), by op name, since the last clear().
FALLBACKS: collections.Counter = collections.Counter()

_DF_DTYPES = (torch.float32, torch.float64)
# Dekker split factor 2^ceil(p/2) + 1 (p = mantissa bits incl. hidden).
_SPLIT = {torch.float32: float(2 ** 12 + 1), torch.float64: float(2 ** 27 + 1)}
# (exponent bias, mantissa bits, integer type of the same width)
_BITS = {torch.float32: (127, 23, torch.int32),
         torch.float64: (1023, 52, torch.int64)}


class DF(NamedTuple):
    """A double-float tensor: value = hi + lo, with fl(hi + lo) = hi."""

    hi: Tensor
    lo: Tensor

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape


def lift(x) -> DF:
    """A native float tensor as a pair (exact)."""
    x = torch.as_tensor(x)
    return DF(x, torch.zeros_like(x))


def _const(like: Tensor, value: float) -> Tensor:
    """``value`` as a 0-d tensor of ``like``'s type on its device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _guard_err(err: Tensor) -> Tensor:
    """A non-finite EFT residual carries no information: zero it, so the
    pair degrades to base precision exactly where base arithmetic
    saturates (lbfgspp_tpu/utils/doublefloat.py:110-131)."""
    return torch.where(torch.isfinite(err), err, torch.zeros_like(err))


def two_sum(a: Tensor, b: Tensor):
    """Error-free sum: a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a: Tensor, b: Tensor):
    """Error-free sum assuming |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def two_prod(a: Tensor, b: Tensor):
    """Error-free product via Dekker splitting: a * b = p + err exactly."""
    p = a * b
    split = _SPLIT[p.dtype]
    c = split * a
    ah = c - (c - a)
    al = a - ah
    c = split * b
    bh = c - (c - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(x: DF, y: DF) -> DF:
    """Pair sum (QD's sloppy add: two_sum + residual fold + renorm)."""
    s, e = two_sum(x.hi, y.hi)
    e = _guard_err(e + (x.lo + y.lo))
    return DF(*quick_two_sum(s, e))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def mul(x: DF, y: DF) -> DF:
    """Pair product (two_prod + cross terms + renorm, Dekker/QD)."""
    p, e = two_prod(x.hi, y.hi)
    e = _guard_err(e + (x.hi * y.lo + x.lo * y.hi))
    return DF(*quick_two_sum(p, e))


def _finite_or_plain(out: DF, plain: Tensor) -> DF:
    """Defer to the base-dtype result wherever it is non-finite."""
    ok = torch.isfinite(plain)
    return DF(torch.where(ok, out.hi, plain),
              torch.where(ok, out.lo, torch.zeros_like(plain)))


def div(x: DF, y: DF) -> DF:
    """One coarse quotient and two corrections (QD's div)."""
    q1 = x.hi / y.hi
    r = sub(x, mul(lift(q1), y))
    q2 = r.hi / y.hi
    r = sub(r, mul(lift(q2), y))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return _finite_or_plain(add(DF(s, e), lift(q3)), q1)


def _sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded sqrt.  The card's is; the CPU build's
    vectorized sqrt is within 0.5001 ulp, so there an f32 sqrt goes
    through f64 and an f64 one takes one exact-residual correction."""
    s = torch.sqrt(x)
    if x.is_cuda:
        return s
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    p, e = two_prod(s, s)
    corr = ((x - p) - e) / (s + s)
    fixed = s + corr
    return torch.where(torch.isfinite(fixed) & (s > 0), fixed, s)


def sqrt(x: DF) -> DF:
    """Karp-Markstein refinement of the base sqrt; non-finite and
    non-positive inputs keep the base sqrt's semantics."""
    s0 = _sqrt_rn(x.hi)
    ok = (s0 > 0) & torch.isfinite(s0)
    safe = torch.where(ok, s0, torch.ones_like(s0))
    d = sub(x, mul(lift(safe), lift(safe)))
    corr = d.hi / (safe + safe)
    hi, lo = quick_two_sum(safe, corr)
    ok = ok & torch.isfinite(hi)
    return DF(torch.where(ok, hi, s0), torch.where(ok, lo, torch.zeros_like(lo)))


def to_float(x: DF) -> Tensor:
    """Round back to the base dtype; a non-finite hi word stands alone."""
    if not x.hi.is_floating_point():
        return x.hi
    return torch.where(torch.isfinite(x.hi), x.hi + x.lo, x.hi)


# ---------------------------------------------------------------------------
# transcendentals
# ---------------------------------------------------------------------------

# ln 2 to ~200 bits as an exact rational.
_LN2_FRAC = fractions.Fraction(
    "0.69314718055994530941723212145817656807550013436025525412068")
_LN2 = float(_LN2_FRAC)


def _round_to(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (nearest even), as a Python float."""
    return torch.tensor(value, dtype=torch.float64).to(dtype).item()


@lru_cache(maxsize=None)
def _const_pair(num: int, den: int, dtype) -> tuple:
    """The (hi, lo) split of the rational num/den in ``dtype``, as Python
    floats (lbfgspp_tpu/utils/doublefloat.py:253-266)."""
    frac = fractions.Fraction(num, den)
    hi = _round_to(float(frac), dtype)
    lo = _round_to(float(frac - fractions.Fraction(hi)), dtype)
    return hi, lo


def _pair_like(like: Tensor, pair: tuple) -> DF:
    return DF(torch.full_like(like, pair[0]), torch.full_like(like, pair[1]))


def _ln2(like: Tensor) -> DF:
    return _pair_like(like, _const_pair(_LN2_FRAC.numerator,
                                        _LN2_FRAC.denominator, like.dtype))


def _pow2(k: Tensor, dtype) -> Tensor:
    """2^k for integral ``k`` (a float tensor), exactly: two factors built
    from the exponent bits, so any k whose power is representable (down
    to the subnormals) comes out exact, and larger k overflow to inf."""
    bias, mant, itype = _BITS[dtype]
    ki = k.clamp(-4 * bias, 4 * bias).to(itype)
    half = torch.div(ki, 2, rounding_mode="floor")
    e1 = ((half + bias).clamp(0, 2 * bias + 1) << mant).view(dtype)
    e2 = ((ki - half + bias).clamp(0, 2 * bias + 1) << mant).view(dtype)
    return e1 * e2


def exp(x: DF) -> DF:
    """``exp(x) = 2^k exp(r)`` with ``r = x - k ln2`` pair-exact and a
    Taylor series with exact reciprocal-factorial pair constants
    (lbfgspp_tpu/utils/doublefloat.py:281-309)."""
    dt = x.hi.dtype
    k = torch.round(x.hi / torch.full_like(x.hi, _LN2))
    r = sub(x, mul(lift(k), _ln2(k)))
    terms = 14 if dt == torch.float32 else 26
    acc = lift(torch.ones_like(x.hi))
    term = lift(torch.ones_like(x.hi))
    for i in range(1, terms + 1):
        term = mul(term, r)
        c = _pair_like(term.hi, _const_pair(1, math.factorial(i), dt))
        acc = add(acc, mul(term, c))
    scale = _pow2(k, dt)
    out = DF(acc.hi * scale, acc.lo * scale)
    plain = torch.exp(x.hi)
    ok = torch.isfinite(x.hi) & torch.isfinite(plain) & (plain > 0)
    return DF(torch.where(ok, out.hi, plain),
              torch.where(ok, out.lo, torch.zeros_like(plain)))


def log(x: DF) -> DF:
    """Base-precision seed and two Newton steps
    ``y <- y + (x exp(-y) - 1)``.  The seed is the base library's log,
    which can differ from another library's by an ulp; the pair result
    agrees to pair precision either way."""
    y0 = torch.log(x.hi)
    ok = (x.hi > 0) & torch.isfinite(y0)
    y0s = torch.where(ok, y0, torch.zeros_like(y0))
    y = lift(y0s)
    for _ in range(2):
        e = exp(neg(y))
        y = add(y, sub(mul(x, e), lift(torch.ones_like(y0s))))
    return DF(torch.where(ok, y.hi, y0),
              torch.where(ok, y.lo, torch.zeros_like(y0)))


def log1p(x: DF) -> DF:
    return log(add(lift(torch.ones_like(x.hi)), x))


def expm1(x: DF) -> DF:
    """``exp(x) - 1`` in pairs; the base expm1 above the cut-off (80 for
    f32 pairs, the JAX package's reference behaviour; 700 for f64)."""
    out = sub(exp(x), lift(torch.ones_like(x.hi)))
    cut = 80.0 if x.hi.dtype == torch.float32 else 700.0
    big = x.hi > cut
    plain = torch.expm1(x.hi)
    return DF(torch.where(big, plain, out.hi),
              torch.where(big, torch.zeros_like(plain), out.lo))


def _abs(x: DF) -> DF:
    negative = x.hi < 0
    return DF(torch.where(negative, -x.hi, x.hi),
              torch.where(negative, -x.lo, x.lo))


def logistic(x: DF) -> DF:
    """Two-branch stable sigmoid on ``e = exp(-|x|) <= 1``."""
    ax = DF(torch.abs(x.hi), torch.where(x.hi < 0, -x.lo, x.lo))
    e = exp(neg(ax))
    one = lift(torch.ones_like(x.hi))
    denom = add(one, e)
    pos = div(one, denom)
    negb = div(e, denom)
    nonneg = x.hi >= 0
    return DF(torch.where(nonneg, pos.hi, negb.hi),
              torch.where(nonneg, pos.lo, negb.lo))


def tanh(x: DF) -> DF:
    """Overflow-free tanh of |x| with the sign restored; saturated beyond
    |x| > 20 (f32 pairs) or 40 (f64 pairs)."""
    ax = DF(torch.abs(x.hi), torch.where(x.hi < 0, -x.lo, x.lo))
    e2 = exp(neg(add(ax, ax)))
    one = lift(torch.ones_like(x.hi))
    t = div(sub(one, e2), add(one, e2))
    sat_cut = 20.0 if x.hi.dtype == torch.float32 else 40.0
    sat = torch.abs(x.hi) > sat_cut
    hi = torch.where(sat, torch.ones_like(t.hi), t.hi)
    lo = torch.where(sat, torch.zeros_like(t.lo), t.lo)
    sgn = torch.sign(x.hi)
    return DF(sgn * hi, sgn * lo)


def _tree_fold(x: DF, axis: int) -> DF:
    """Compensated reduction along ``axis`` by repeated halving, in the
    JAX package's pairing (lbfgspp_tpu/utils/doublefloat.py:391-412)."""
    hi = x.hi.movedim(axis, 0)
    lo = x.lo.movedim(axis, 0)
    n = hi.shape[0]
    if n == 0:
        z = hi.new_zeros(hi.shape[1:])
        return DF(z, z)
    while n > 1:
        half = (n + 1) // 2
        pad = half * 2 - n
        if pad:
            zpad = hi.new_zeros((pad,) + tuple(hi.shape[1:]))
            hi = torch.cat([hi, zpad], dim=0)
            lo = torch.cat([lo, zpad], dim=0)
        s = add(DF(hi[:half], lo[:half]), DF(hi[half:], lo[half:]))
        hi, lo = s.hi, s.lo
        n = half
    return DF(hi[0], lo[0])


def df_sum(x: DF, axes) -> DF:
    """Compensated sum over ``axes`` (ints, the last first)."""
    out = x
    for ax in sorted((a % max(x.hi.dim(), 1) for a in axes), reverse=True):
        out = _tree_fold(out, ax)
    return out


def df_dot(a: DF, b: DF) -> DF:
    """Compensated dot product along the last axis."""
    return df_sum(mul(a, b), (-1,))


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------

def _is_df(v) -> bool:
    return isinstance(v, DF)


def _wrap(v):
    """An input or constant value as the interpreter holds it: float
    tensors of a pair dtype become pairs, everything else stays as is."""
    if isinstance(v, Tensor) and v.dtype in _DF_DTYPES:
        return lift(v)
    return v


def _map(fn, v):
    """``fn`` on every leaf of nested lists and tuples; a pair is a leaf.
    Lists stay lists and tuples become plain tuples."""
    if _is_df(v):
        return fn(v)
    if isinstance(v, list):
        return [_map(fn, o) for o in v]
    if isinstance(v, tuple):
        return tuple(_map(fn, o) for o in v)
    if isinstance(v, dict):
        return {k: _map(fn, o) for k, o in v.items()}
    return fn(v)


def _lift_out(v):
    return _map(_wrap, v)


def _words(v, which: int):
    """The hi (0) or lo (1) word of every pair inside ``v``."""
    return _map(lambda o: o[which] if _is_df(o) else o, v)


def _natives(v):
    """Every pair inside ``v`` rounded to its base dtype."""
    return _map(lambda o: to_float(o) if _is_df(o) else o, v)


def _has_df(v) -> bool:
    if _is_df(v):
        return True
    if isinstance(v, (list, tuple)):
        return any(_has_df(o) for o in v)
    if isinstance(v, dict):
        return any(_has_df(o) for o in v.values())
    return False


def _as_pair(v, like: Tensor) -> DF:
    """An operand of a pair rule as a pair of ``like``'s type: scalars lift
    in the base dtype (JAX's weak-typed literals), integer and boolean
    tensors convert exactly."""
    if _is_df(v):
        if v.hi.dtype != like.dtype:
            return DF(v.hi.to(like.dtype), v.lo.to(like.dtype))
        return v
    if isinstance(v, Tensor):
        v = v.to(device=like.device, dtype=like.dtype)
        return DF(v, torch.zeros_like(v))
    c = _const(like, v)
    return DF(c, torch.zeros_like(c))


def _pair_operands(*vals):
    """The operands of a pair rule, all as pairs of the widest pair type
    among them."""
    dfs = [v for v in vals if _is_df(v)]
    like = dfs[0].hi
    for v in dfs[1:]:
        if v.hi.dtype == torch.float64:
            like = v.hi
    return [_as_pair(v, like) for v in vals]


def _structural(op, args, kwargs):
    """Data movement: the op on each word (exact).  Integer operands
    (indices) feed both."""
    his = op(*_words(args, 0), **_words(kwargs, 0))
    los = op(*_words(args, 1), **_words(kwargs, 1))
    if isinstance(his, (list, tuple)):
        return [DF(h, lo) for h, lo in zip(his, los)]
    return DF(his, los)


def _integer_pow(x: DF, k: int) -> DF:
    """Square-and-multiply (lbfgspp_tpu/utils/doublefloat.py:466-482)."""
    if k == 0:
        return lift(torch.ones_like(x.hi))
    neg_pow = k < 0
    k = -k if neg_pow else k
    result, base = None, x
    while k:
        if k & 1:
            result = base if result is None else mul(result, base)
        k >>= 1
        if k:
            base = mul(base, base)
    if neg_pow:
        result = div(lift(torch.ones_like(x.hi)), result)
    return result


def _pow(a: DF, b: DF) -> DF:
    """``exp(b log a)`` for a > 0; the base pow elsewhere."""
    out = exp(mul(b, log(a)))
    ok = a.hi > 0
    plain = torch.pow(to_float(a), to_float(b))
    return DF(torch.where(ok, out.hi, plain),
              torch.where(ok, out.lo, torch.zeros_like(plain)))


def _df_ge(a: DF, b: DF) -> Tensor:
    d = sub(a, b)
    return (d.hi > 0) | ((d.hi == 0) & (d.lo >= 0))


def _select(pred: Tensor, a: DF, b: DF) -> DF:
    return DF(torch.where(pred, a.hi, b.hi), torch.where(pred, a.lo, b.lo))


def _minmax(a: DF, b: DF, is_max: bool) -> DF:
    """max/min that propagate a NaN from either operand, as the native
    ones do."""
    ge = _df_ge(a, b)
    out = _select(ge, a, b) if is_max else _select(ge, b, a)
    bad = torch.isnan(a.hi) | torch.isnan(b.hi)
    return DF(torch.where(bad, a.hi + b.hi, out.hi),
              torch.where(bad, torch.zeros_like(out.lo), out.lo))


_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


def _cmp(name: str, a: DF, b: DF) -> Tensor:
    """Compare the full pair values through their difference; where the
    difference is NaN from equal infinities, the native comparison."""
    d = sub(a, b)
    out = _CMP[name](to_float(d), torch.zeros_like(d.hi))
    native = torch.isnan(d.hi) & ~(torch.isnan(a.hi) | torch.isnan(b.hi))
    return torch.where(native, _CMP[name](a.hi, b.hi), out)


def _contract(a: DF, b: DF, a_batch, a_con, b_batch, b_con) -> DF:
    """A compensated contraction: products by pair ``mul`` and a tree sum
    over the contracted axes, as ``_rule_dot_general`` does
    (lbfgspp_tpu/utils/doublefloat.py:489-515).  No cuBLAS, no TF32."""
    def arrange(x: DF, batch, con):
        other = [d for d in range(x.hi.dim()) if d not in batch and
                 d not in con]
        perm = list(batch) + list(con) + other
        return DF(x.hi.permute(perm), x.lo.permute(perm))

    a2, b2 = arrange(a, a_batch, a_con), arrange(b, b_batch, b_con)
    nb, nc = len(a_batch), len(a_con)
    a_sh, b_sh = tuple(a2.hi.shape), tuple(b2.hi.shape)
    bshape, cshape = a_sh[:nb], a_sh[nb:nb + nc]
    mshape, nshape = a_sh[nb + nc:], b_sh[nb + nc:]
    ash = bshape + cshape + mshape + (1,) * len(nshape)
    bsh = bshape + cshape + (1,) * len(mshape) + nshape
    prod = mul(DF(a2.hi.reshape(ash), a2.lo.reshape(ash)),
               DF(b2.hi.reshape(bsh), b2.lo.reshape(bsh)))
    return df_sum(prod, tuple(range(nb, nb + nc)))


def _reduce_dims(x: DF, dims, keepdim: bool):
    nd = x.hi.dim()
    dims = list(range(nd)) if not dims else [d % nd for d in dims]
    return dims, keepdim


def _rule_sum(x: DF, dims=None, keepdim=False, dtype=None):
    dims, keepdim = _reduce_dims(x, dims, keepdim)
    out = df_sum(x, dims)
    if keepdim:
        for d in sorted(dims):
            out = DF(out.hi.unsqueeze(d), out.lo.unsqueeze(d))
    return out


def _rule_mean(x: DF, dims=None, keepdim=False, dtype=None):
    dims, _ = _reduce_dims(x, dims, keepdim)
    count = math.prod(x.hi.shape[d] for d in dims)
    total = _rule_sum(x, dims, keepdim)
    return div(total, _as_pair(float(count), total.hi))


def _binary(fn):
    def rule(a, b, *, alpha=1):
        a, b = _pair_operands(a, b)
        if alpha != 1:
            b = mul(b, _as_pair(alpha, b.hi))
        return fn(a, b)
    return rule


def _rule_rsub(a, b, *, alpha=1):
    a, b = _pair_operands(a, b)
    if alpha != 1:
        a = mul(a, _as_pair(alpha, a.hi))
    return sub(b, a)


def _rule_div(a, b, *, rounding_mode=None):
    if rounding_mode is not None:
        return None
    a, b = _pair_operands(a, b)
    return div(a, b)


def _rule_pow(a, b):
    if _is_df(a) and not _is_df(b) and not isinstance(b, Tensor) \
            and float(b).is_integer():
        return _integer_pow(a, int(b))
    a, b = _pair_operands(a, b)
    return _pow(a, b)


def _rule_where(cond, a, b):
    a, b = _pair_operands(a, b)
    return _select(cond, a, b)


def _rule_clamp(x, lo=None, hi=None):
    out = x
    if lo is not None:
        out = _minmax(*_pair_operands(out, lo), True)
    if hi is not None:
        out = _minmax(*_pair_operands(out, hi), False)
    return out


def _rule_addmm(bias, a, b, *, beta=1, alpha=1):
    if beta != 1 or alpha != 1:
        return None
    bias, a, b = _pair_operands(bias, a, b)
    return add(bias, _contract(a, b, (), (1,), (), (0,)))


def _cmp_rule(name):
    def rule(a, b):
        return _cmp(name, *_pair_operands(a, b))
    return rule


_RULES = {
    "add": _binary(add),
    "sub": _binary(sub),
    "rsub": _rule_rsub,
    "mul": _binary(mul),
    "div": _rule_div,
    "neg": neg,
    "sqrt": sqrt,
    "rsqrt": lambda a: div(lift(torch.ones_like(a.hi)), sqrt(a)),
    "reciprocal": lambda a: div(lift(torch.ones_like(a.hi)), a),
    "square": lambda a: mul(a, a),
    "abs": _abs,
    # the sign of a normalized pair is its hi word's (lo is 0 where hi is)
    "sign": lambda a: lift(torch.sign(a.hi)),
    "sgn": lambda a: lift(torch.sign(a.hi)),
    "maximum": lambda a, b: _minmax(*_pair_operands(a, b), True),
    "minimum": lambda a, b: _minmax(*_pair_operands(a, b), False),
    "clamp": _rule_clamp,
    "clamp_min": lambda x, lo: _rule_clamp(x, lo=lo),
    "clamp_max": lambda x, hi: _rule_clamp(x, hi=hi),
    "pow": _rule_pow,
    "where": _rule_where,
    "sum": _rule_sum,
    "mean": _rule_mean,
    "dot": lambda a, b: _contract(*_pair_operands(a, b), (), (0,), (), (0,)),
    "mv": lambda a, b: _contract(*_pair_operands(a, b), (), (1,), (), (0,)),
    "mm": lambda a, b: _contract(*_pair_operands(a, b), (), (1,), (), (0,)),
    "bmm": lambda a, b: _contract(*_pair_operands(a, b), (0,), (2,), (0,),
                                  (1,)),
    "addmm": _rule_addmm,
    "exp": exp,
    "log": log,
    "log1p": log1p,
    "expm1": expm1,
    "sigmoid": logistic,
    "tanh": tanh,
    "exp2": lambda a: exp(mul(a, _ln2(a.hi))),
    "log2": lambda a: div(log(a), _ln2(a.hi)),
}
_RULES.update({name: _cmp_rule(name) for name in _CMP})

# Data movement, applied to each word.  The scatters and *_backward ops
# are the AD transposes of indexing; with the unique indices AD generates
# they only move data.
_STRUCTURAL = {
    "view", "_unsafe_view", "reshape", "expand", "expand_copy", "select",
    "slice", "cat", "stack", "permute", "t", "transpose", "squeeze",
    "unsqueeze", "clone", "alias", "detach", "lift_fresh_copy",
    "contiguous", "flip", "roll", "repeat", "narrow", "split",
    "split_with_sizes", "unbind", "chunk", "diagonal", "index_select",
    "gather", "index", "movedim", "select_backward", "slice_backward",
    "slice_scatter", "select_scatter", "diagonal_backward", "index_put",
    "index_add", "scatter", "scatter_add", "constant_pad_nd", "new_empty",
    "view_as", "expand_as", "unfold",
}
# Creation from a tensor's shape or type: the native op on the hi word,
# with a zero lo word.
_CREATION_LIKE = {"ones_like", "zeros_like", "full_like", "empty_like",
                  "new_zeros", "new_ones", "new_full", "empty_strided"}


def _fallback(op, name: str, args, kwargs):
    """Evaluate through the rounded words (base precision) and count it."""
    FALLBACKS[name] += 1
    return _lift_out(op(*_natives(args), **_natives(kwargs)))


def _apply(op, args, kwargs):
    """One graph node under pair rules."""
    if op is operator.getitem:
        return args[0][args[1]]
    if not _has_df(args) and not _has_df(kwargs):
        return _lift_out(op(*args, **kwargs))
    name = op.overloadpacket.__name__ if hasattr(op, "overloadpacket") \
        else getattr(op, "__name__", str(op))
    if name in _RULES:
        kw = {k: v for k, v in kwargs.items()
              if k in ("alpha", "rounding_mode", "beta", "keepdim", "dtype")}
        out = _RULES[name](*args, **kw)
        if out is not None:
            return out
    elif name in _STRUCTURAL:
        return _structural(op, args, kwargs)
    elif name in _CREATION_LIKE:
        return _lift_out(op(*_words(args, 0), **_words(kwargs, 0)))
    elif name == "_to_copy":
        dtype = kwargs.get("dtype")
        if dtype is None or dtype in _DF_DTYPES:
            return _structural(op, args, kwargs)
    return _fallback(op, name, args, kwargs)


def _interpret(gm: torch.fx.GraphModule, args):
    """Run the recorded graph on pair inputs."""
    env = {}
    inputs = iter(args)

    def read(node):
        return env[node]

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = _wrap(next(inputs))
        elif node.op == "get_attr":
            value = gm
            for part in node.target.split("."):
                value = getattr(value, part)
            env[node] = _wrap(value)
        elif node.op == "call_function":
            env[node] = _apply(node.target, map_arg(node.args, read),
                               map_arg(node.kwargs, read))
        elif node.op == "output":
            return map_arg(node.args[0], read)
        else:
            raise NotImplementedError(f"df64: graph node {node.op!r}")
    raise ValueError("df64: the graph has no output")


_TRACES: "collections.OrderedDict" = collections.OrderedDict()
_MAX_TRACES = 32


def _traced(key, fn, examples) -> torch.fx.GraphModule:
    """The aten graph of ``fn`` at these inputs' shapes, types and devices,
    recorded once per ``key`` (an LRU of :data:`_MAX_TRACES` graphs)."""
    full = (key,) + tuple((tuple(e.shape), e.dtype, e.device)
                          for e in examples)
    gm = _TRACES.get(full)
    if gm is None:
        gm = make_fx(fn)(*examples)
        _TRACES[full] = gm
        while len(_TRACES) > _MAX_TRACES:
            _TRACES.popitem(last=False)
    else:
        _TRACES.move_to_end(full)
    return gm


def df64ify(fun: Callable, to_native: bool = True) -> Callable:
    """Re-evaluate ``fun`` (a function of tensors) with all arithmetic in
    pairs.  The graph is recorded at the first call for each input shape,
    type and device and reused after.  With ``to_native`` the outputs are
    rounded back to the base dtype; otherwise pair outputs are :class:`DF`.
    ``df64ify(make_fun_and_grad(f))`` is a batched ``fun_and_grad`` whose
    value and gradient carry about twice the base mantissa."""

    def wrapped(*args):
        examples = [a.hi if _is_df(a) else a for a in args]
        gm = _traced(("df64ify", fun), fun, examples)
        out = _interpret(gm, [a if _is_df(a) else lift(a) for a in args])
        return _natives(out) if to_native else out

    return wrapped


def df64_fun_and_grad(fun: Callable) -> Callable:
    """The batched ``x [B, n] -> (fx [B], grad [B, n])`` of the
    per-instance ``fun``, evaluated in pairs and rounded back."""
    return df64ify(make_fun_and_grad(fun))


def _recorded_oracle(fun, fun_and_grad, data):
    """``(fg, leaves, key)``: the batched oracle to record, the data
    tensors it takes after ``x`` and its trace key.  With ``data`` (a
    tensor or tree of tensors with a leading ``[B]`` axis, the objective
    ``fun(x[n], data_i)``) the data's leaves are graph inputs, not
    recorded constants, so one graph serves every batch of data of the
    same shapes."""
    if data is None:
        return make_fun_and_grad(fun, fun_and_grad), [], \
            ("pair", fun, fun_and_grad)
    leaves, spec = pytree.tree_flatten(data)
    fgd = make_fun_and_grad(fun, fun_and_grad, with_data=True)

    def fg(x, *parts):
        return fgd(x, pytree.tree_unflatten(list(parts), spec))

    return fg, leaves, ("pair", fun, fun_and_grad, str(spec))


def df64_pair_fun_and_grad(fun: Callable = None,
                           fun_and_grad: Callable = None,
                           shift=None, pin=None, data=None) -> Callable:
    """Lift the per-instance ``fun`` (or ``fun_and_grad``) to the paired
    parameter space ``x2 = [hi; lo]`` of a batch, ``x2 [B, 2n]``.

    The objective is evaluated at the exact sum ``hi + lo`` in pair
    arithmetic, so sub-ulp moves accumulate in ``lo``; ``dF/dhi = dF/dlo =
    f'(hi + lo)``, so the gradient is the pair gradient on both halves
    (lbfgspp_tpu/utils/doublefloat.py:723-751).  Returns ``(fx [B],
    grad [B, 2n])``; :func:`pair_to_float` collapses the halves.

    ``shift``: an optional per-instance pair ``(chi [B], clo [B])``
    subtracted from the value inside the pair arithmetic, as
    ``(fx - chi) - clo`` (the shifted polish of :mod:`..batch`).

    ``pin``: an optional ``(active [B, n] bool, xpin [B, n])``: the
    objective is evaluated at ``where(active, xpin, hi + lo)`` and its
    gradient is zero on the active coordinates, the pair evaluation of the
    JAX package's ``fun(where(active, xpin, z))`` (the box polish,
    lbfgspp_tpu/batch.py:292-299).  Both enter as data, outside the
    recorded graph, which stays the unpinned objective's.

    ``data``: every instance's own data for ``fun(x[n], data_i)`` (see
    :func:`..types.make_fun_and_grad`), graph inputs like ``x``; exact
    constants of the pair arithmetic (zero lo words).
    """
    fg, leaves, key = _recorded_oracle(fun, fun_and_grad, data)

    def fg2(x2: Tensor):
        n = x2.shape[-1] // 2
        s, e = two_sum(x2[:, :n], x2[:, n:])
        if pin is not None:
            active, xpin = pin
            s = torch.where(active, xpin, s)
            e = torch.where(active, 0.0, e)
        gm = _traced(key, fg, [s] + leaves)
        fx, g = _interpret(gm, [DF(s, e)] + leaves)
        if shift is not None:
            fx = sub(sub(fx, lift(shift[0])), lift(shift[1]))
        g1 = to_float(g)
        if pin is not None:
            g1 = torch.where(pin[0], 0.0, g1)
        return to_float(fx), torch.cat([g1, g1], dim=-1)

    return fg2


def df64_value(fun: Callable = None, fun_and_grad: Callable = None,
               data=None):
    """``x [B, n] -> DF fx [B]``: the per-instance objective's value in
    pairs at the (exact) native ``x``; ``data`` as in
    :func:`df64_pair_fun_and_grad`."""
    fg, leaves, key = _recorded_oracle(fun, fun_and_grad, data)

    def value(x: Tensor) -> DF:
        gm = _traced(key, fg, [x] + leaves)
        fx, _ = _interpret(gm, [lift(x)] + leaves)
        return fx

    return value


def pair_to_float(x2: Tensor) -> Tensor:
    """Collapse a paired iterate ``[hi; lo]`` (last axis) to the base
    dtype."""
    n = x2.shape[-1] // 2
    return x2[..., :n] + x2[..., n:]

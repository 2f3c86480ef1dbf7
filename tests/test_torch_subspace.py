"""The port's BOXCQP subspace step (lbfgspp_tpu_torch.ops.subspace)
against the NumPy index-set oracle (tests/oracle_b.py) and the JAX
package's, in f64.

Bars: the direction equals the JAX function's at rtol 1e-10 and the
oracle's at rtol 1e-8 (tests/test_cauchy_subspace.py's bar); a batch
equals its instances solved one at a time, although they take different
numbers of active-set iterations; ``unroll=True`` gives the loop's
values; an infeasible start that does not converge takes each level of
the 3-level fallback (SubspaceMin.h:276-296), as the JAX function does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbfgspp_tpu.ops import subspace as jsub
from lbfgspp_tpu_torch.ops import bmat as tbmat
from lbfgspp_tpu_torch.ops import cauchy as tcauchy
from lbfgspp_tpu_torch.ops import subspace as tsub
from lbfgspp_tpu_torch.types import tree_map
from oracle_b import cauchy_point as oracle_cauchy
from oracle_b import subspace_minimize as oracle_subspace

from test_torch_bmat import make_histories
from test_torch_cauchy import box_case

N, M = 15, 6
NCORRS = (0, 3, 6, 9, 4, 7, 2, 8)


def as_t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.fixture(scope="module")
def case():
    th, jh, oh, _ = make_histories(N, M, NCORRS, seed=77)
    rng = np.random.default_rng(8)
    cols = [box_case(N, rng, "random") for _ in NCORRS]
    x0, g, lb, ub = (np.stack(c) for c in zip(*cols))
    cp = tcauchy.cauchy_point(th, *as_t(x0, g, lb, ub))
    return th, jh, oh, x0, g, lb, ub, cp


def run_port(th, x0, g, lb, ub, cp, maxit=10, unroll=False):
    return tsub.subspace_minimize(th, *as_t(x0), cp.xcp, *as_t(g, lb, ub),
                                  cp.vecc, cp.newact_mask, cp.free_mask,
                                  maxit, unroll=unroll)


def run_jax(h, b, x0, g, lb, ub, cp, maxit=10):
    j = [jnp.asarray(np.asarray(a[b])) for a in (x0, cp.xcp, g, lb, ub,
                                                 cp.vecc, cp.newact_mask,
                                                 cp.free_mask)]
    return jsub.subspace_minimize(h, *j, maxit)


def test_matches_jax_and_oracle(case):
    th, jh, oh, x0, g, lb, ub, cp = case
    drt, info = run_port(th, x0, g, lb, ub, cp)
    looped = 0
    for b, (h, o) in enumerate(zip(jh, oh)):
        want, winfo = run_jax(h, b, x0, g, lb, ub, cp)
        np.testing.assert_allclose(drt[b].numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12)
        assert int(info[b]) == int(winfo)
        xcp_o, vecc_o, newact_o, fv_o = oracle_cauchy(o, x0[b], g[b], lb[b],
                                                      ub[b])
        drt_o = oracle_subspace(o, x0[b], xcp_o, g[b], lb[b], ub[b],
                                vecc_o, newact_o, fv_o, 10)
        np.testing.assert_allclose(drt[b].numpy(), drt_o, rtol=1e-8,
                                   atol=1e-9)
        looped += not np.allclose(drt[b].numpy(), cp.xcp[b].numpy() - x0[b])
    assert looped > 0


def test_batch_equals_instances_and_unroll(case):
    """Instances that converge after different numbers of iterations: the
    lockstep batch freezes each at its own exit, and counts the
    iterations each instance took."""
    th, jh, oh, x0, g, lb, ub, cp = case
    taken = tsub.COUNTS["instance_iterations"]
    drt, _ = run_port(th, x0, g, lb, ub, cp)
    taken = tsub.COUNTS["instance_iterations"] - taken
    unrolled, _ = run_port(th, x0, g, lb, ub, cp, unroll=True)
    assert torch.equal(drt, unrolled)
    iters = []
    for b in range(len(NCORRS)):
        hb = tree_map(lambda t: t[b:b + 1], th)
        cpb = tcauchy.CauchyResult(*(t[b:b + 1] for t in cp))
        before = tsub.COUNTS["lockstep"]
        one, _ = run_port(hb, *(a[b:b + 1] for a in (x0, g, lb, ub)), cpb)
        iters.append(tsub.COUNTS["lockstep"] - before)
        np.testing.assert_allclose(one[0].numpy(), drt[b].numpy(),
                                   rtol=1e-13, atol=1e-15)
    assert len(set(iters)) >= 2, iters
    assert taken == sum(iters)


def _fallback_case(seed, with_jax=False):
    """An instance whose BOXCQP loop does not converge in one iteration,
    with an idle last coordinate (at its bound, neither free nor newly
    active) whose ``xcp`` shifts ``drt . g`` without touching the loop."""
    n = 10
    th, jh, _, rng = make_histories(n, M, (7,), seed=seed,
                                    with_jax=with_jax)
    x0, g, lb, ub = box_case(n, rng, "random")
    lb[-1], ub[-1], x0[-1] = 0.0, 1.0, 0.0
    lb[:-1], ub[:-1] = x0[:-1] - 0.05, x0[:-1] + 0.05   # a tight box
    cp = tcauchy.cauchy_point(th, *as_t(x0[None], g[None], lb[None],
                                        ub[None]))
    free = cp.free_mask.clone()
    free[0, -1] = False
    act = cp.newact_mask.clone()
    act[0, -1] = False
    cp = cp._replace(free_mask=free, newact_mask=act)
    return th, jh[0], x0, g, lb, ub, cp


def test_fallback_takes_each_level():
    """maxit=1 leaves the loop unconverged; the idle coordinate's
    contribution to ``drt . g`` then decides the level: the projected
    iterate (a), the projected unconstrained solve (b) or the
    unconstrained solve itself (c)."""
    for seed in range(200):
        th, jh, x0, g, lb, ub, cp = _fallback_case(seed)
        free = cp.free_mask[0].numpy()
        vecl = np.where(free, lb - x0, 0.0)
        vecu = np.where(free, ub - x0, 0.0)
        vecc = tbmat.compute_ftbab(th, cp.free_mask, cp.newact_mask,
                                   cp.vecc, cp.xcp - torch.as_tensor(x0))
        vecc = torch.where(cp.free_mask, vecc + torch.as_tensor(g), 0.0)
        y0 = tbmat.solve_ptbp(th, cp.free_mask, -vecc)[0][0].numpy()
        if np.all((y0[free] >= vecl[free]) & (y0[free] <= vecu[free])):
            continue                        # feasible: no loop
        g2 = g.copy()
        g2[-1] = 1.0

        def pulled(shift):
            """The free part of drt with the idle coordinate's share of
            drt . g at ``shift``."""
            xcp = cp.xcp.clone()
            xcp[0, -1] = x0[-1] + shift          # g2[-1] = 1
            drt, _ = run_port(th, x0[None], g2[None], lb[None], ub[None],
                              cp._replace(xcp=xcp), maxit=1)
            return drt[0].numpy()[free]

        # pulled hard either way: level a, and level c only if the loop
        # did not converge
        ya = pulled(-1e6)
        if np.allclose(ya, pulled(1e6)):
            continue                        # converged in one iteration
        # the other fixed coordinates' share of drt . g
        rest = (~free) & (np.arange(len(x0)) < len(x0) - 1)
        fixed = (cp.xcp[0].numpy() - x0)[rest] @ g2[rest]
        dg_a = ya @ g2[free] + fixed
        dg_b = np.clip(y0, vecl, vecu)[free] @ g2[free] + fixed
        if not dg_b < dg_a - 1e-6:
            continue
        shifts = {"a": -dg_a - 1.0, "b": -(dg_a + dg_b) / 2, "c": -dg_b + 1.0}
        want = {"a": ya, "b": np.clip(y0, vecl, vecu)[free], "c": y0[free]}
        jh = _fallback_case(seed, with_jax=True)[1]
        for level, shift in shifts.items():
            xcp = cp.xcp.clone()
            xcp[0, -1] = x0[-1] + shift          # g2[-1] = 1
            cpl = cp._replace(xcp=xcp)
            drt, _ = run_port(th, x0[None], g2[None], lb[None], ub[None],
                              cpl, maxit=1)
            np.testing.assert_allclose(drt[0].numpy()[free], want[level],
                                       rtol=1e-12, atol=1e-14)
            jdrt, _ = run_jax(jh, 0, x0[None], g2[None], lb[None], ub[None],
                              cpl, maxit=1)
            np.testing.assert_allclose(drt[0].numpy(), np.asarray(jdrt),
                                       rtol=1e-10, atol=1e-12)
        return
    pytest.fail("no seed gave an unconverged loop with distinct levels")

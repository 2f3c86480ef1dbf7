"""Cases of the feature-split and ``mesh=`` paths, run on every rank of a
group by :mod:`.spawn_ranks` (the CPU tests hold them against JAX's
``shard_map`` on a 2-device mesh; ``chip_smoke.py`` phase 24 runs them on
two gloo ranks sharing the card).

Each case takes its data as numpy arrays (the same global arrays on every
rank), solves with the port and returns numpy: the feature-split solves
return this rank's block of ``x`` beside the replicated fields, and the
all-reduce counts of :data:`..parallel.collectives.COUNTS` by site.  The
objectives are module-level so that the reference side can build the
same ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import lbfgspp_tpu_torch as lt
from lbfgspp_tpu_torch.parallel import collectives as coll
from lbfgspp_tpu_torch.utils import objectives


def _t(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


def _solve_fields(res, counts=None) -> dict:
    out = {"x": res.x, "fx": res.fx, "niter": res.niter, "nfev": res.nfev,
           "status": res.status, "gnorm": res.gnorm}
    if counts is not None:
        out["counts"] = dict(counts)
    return out


def collective_inputs(seed: int, rank: int) -> dict:
    """The local operands of :func:`collectives` on ``rank``."""
    rng = np.random.default_rng(seed + 17 * rank)
    return {"a": rng.standard_normal((3, 5)),
            "b": rng.standard_normal((3, 5)),
            "mat": rng.standard_normal((3, 4, 5)),
            "flags": rng.random(3) < 0.8}


def collectives(seed: int = 0, device: str = "cpu") -> dict:
    """Every collective of :mod:`..parallel.collectives` on this rank's
    operands, and the per-site counts they leave."""
    group = dist.group.WORLD
    d = {k: _t(v, device) for k, v in
         collective_inputs(seed, dist.get_rank()).items()}
    a, b, mat = d["a"], d["b"], d["mat"]
    coll.COUNTS.clear()
    out = {
        "psum": coll.psum(a, group),
        "pdot": coll.pdot(a, b, group),
        "psqnorm": coll.psqnorm(a, group),
        "pnorm": coll.pnorm(a, group),
        "pmax": coll.pmax(a, group),
        "pmin": coll.pmin(a, group),
        "pall": coll.pall(d["flags"], group),
        "pmax_abs": coll.pmax_abs(a, group),
        "pdot2": torch.stack(coll.pdot2(a, b, b, b, group), 1),
        "pmatvec": coll.pmatvec(mat, a, group),
        "pgram": coll.pgram(mat, group),
        "pfused": torch.cat([p.reshape(3, -1) for p in coll.pfused(
            [a, mat], group)], 1),
        "unchanged": a,
    }
    # rows lo..hi of a batch of 5 hold their own index
    lo, hi = coll.block(5, group)
    rows = torch.arange(lo, hi, dtype=a.dtype, device=a.device)
    out["gather_rows"] = coll.gather_rows(rows[:, None].expand(-1, 2), 5,
                                          group)
    out["gather_bool"] = coll.gather_rows(rows > 2, 5, group)
    out["counts"] = dict(coll.COUNTS)
    return out


def quartic(x, c):
    """``sum c (x - 1)^2 + 0.1 (x - 1)^4``: separable, so a block's
    partial is the same function of its block."""
    r = x - 1.0
    return torch.sum(c * r * r + 0.1 * r ** 4)


def quadratic(x, d):
    """``sum (x - d)^2``."""
    r = x - d
    return torch.sum(r * r)


def sharded_solves(data: dict, device: str = "cpu") -> dict:
    """The feature-split solves of ``tests/test_torch_sharded.py``, each
    with its all-reduce counts: ``data`` holds the global arrays."""
    dev = torch.device(device)
    lo, hi = coll.block(data["n"], dist.group.WORLD)
    out = {}

    def run(name, fn):
        coll.COUNTS.clear()
        res = fn()
        out[name] = _solve_fields(res, coll.COUNTS)
        if res.history is not None and hasattr(res.history, "rinv"):
            out[name]["has_rinv"] = res.history.rinv is not None

    d_loc = _t(data["d"], dev)[lo:hi]
    c_loc = _t(data["c"], dev)[lo:hi]
    p8 = lt.LBFGSParams(epsilon=1e-8, max_iterations=50)
    p6 = lt.LBFGSParams(epsilon=1e-6, max_iterations=200)
    run("quadratic", lambda: lt.minimize_sharded(
        lambda x: quadratic(x, d_loc), _t(data["x0"], dev), p8,
        device=dev))
    run("quartic", lambda: lt.minimize_sharded(
        lambda x: quartic(x, c_loc), _t(data["zeros"], dev), p8,
        device=dev))
    # the other searches, schedules and options on the quartic
    variants = {"morethuente": dict(line_search="morethuente"),
                "backtracking": dict(line_search="backtracking"),
                "bracketing": dict(line_search="bracketing"),
                "speculative": dict(line_search="speculative"),
                "doubling": dict(direction="doubling"),
                "bf16_rows": dict(history_dtype=torch.bfloat16),
                "restart": dict(on_ls_fail="restart")}
    for name, kw in variants.items():
        pv = lt.LBFGSParams(epsilon=1e-8, max_iterations=50,
                            max_linesearch=1 if name == "restart" else 20)
        run(f"quartic_{name}", lambda kw=kw, pv=pv: lt.minimize_sharded(
            lambda x: quartic(x, c_loc), _t(data["x0"], dev), pv,
            device=dev, **kw))
    run("rosenbrock", lambda: lt.minimize_sharded(
        objectives.rosenbrock, _t(data["zeros"], dev), p6, device=dev))
    run("rosenbrock_rinv", lambda: lt.minimize_sharded(
        objectives.rosenbrock, _t(data["zeros"], dev), p6,
        direction="rinv", device=dev))
    a_loc = _t(data["a"], dev)[:, lo:hi].contiguous()
    fg = objectives.make_sharded_logreg(a_loc, _t(data["b"], dev),
                                        dist.group.WORLD)
    run("logreg", lambda: lt.minimize_sharded(
        local_fun_and_grad=fg, x0=_t(data["zeros"], dev),
        params=lt.LBFGSParams(epsilon=1e-6, max_iterations=500),
        device=dev))
    pb = lt.LBFGSBParams(epsilon=1e-8, max_iterations=100)
    for gcp in ("walk", "walk_chunked", "auto"):
        run(f"box_{gcp}", lambda gcp=gcp: lt.minimize_b_sharded(
            objectives.rosenbrock, _t(data["box_x0"], dev),
            _t(data["lb"], dev), _t(data["ub"], dev), pb, gcp=gcp,
            device=dev))
    run("owlqn", lambda: lt.minimize_owlqn_sharded(
        lambda x: quartic(x, c_loc), _t(data["x0"], dev), data["l1"],
        lt.LBFGSParams(epsilon=1e-8, max_iterations=100), device=dev))
    return out


def implicit_objective(x_local, th, lo: int, hi: int):
    """This rank's partial of ``sum 0.5 (x - th)^2 + 0.1 (x - th)^4 +
    0.05 x^2``: tests/test_collective_audit.py:184-187's objective with a
    small ridge, so that the optimal value moves with ``th``."""
    r = x_local - th[lo:hi]
    return torch.sum(0.5 * r * r + 0.1 * r ** 4 + 0.05 * x_local * x_local)


def implicit(theta, precondition: bool = True,
             device: str = "cpu") -> dict:
    """``d (sum(x*^2) + f(x*)) / d theta`` through
    ``implicit_minimize_sharded`` and the all-reduce counts of the forward
    and backward passes."""
    dev = torch.device(device)
    th = torch.as_tensor(theta, device=dev).clone().requires_grad_(True)
    n = th.shape[0]
    lo, hi = coll.block(n, dist.group.WORLD)
    coll.COUNTS.clear()
    res = lt.implicit_minimize_sharded(
        lambda x, t: implicit_objective(x, t, lo, hi),
        torch.zeros(n, dtype=th.dtype, device=dev), th,
        lt.LBFGSParams(epsilon=1e-8, max_iterations=50),
        precondition=precondition, device=dev)
    forward = dict(coll.COUNTS)
    coll.COUNTS.clear()
    # Every rank's loss: its block's sum of squares, and the replicated
    # value once.
    ((res.x ** 2).sum() + res.fx).backward()
    return {"x": res.x, "niter": res.niter, "grad": th.grad,
            "forward": forward, "backward": dict(coll.COUNTS)}


def batch_mesh(cases, device: str = "cpu") -> dict:
    """``minimize_batched(mesh=)`` and ``minimize_b_batched(mesh=)`` on
    the default group for each of ``cases`` (name -> ``(x0s, c, lb, ub,
    options)``, ``lb`` None for an unconstrained case), with the counts
    of the all-reduces each made."""
    dev = torch.device(device)
    out = {}
    for name, (x0s, c, lb, ub, options) in cases.items():
        ct, options = _t(c, dev), dict(options)

        def fun(x):
            return quartic(x, ct)

        coll.COUNTS.clear()
        if lb is None:
            res = lt.minimize_batched(
                fun, _t(x0s, dev), lt.LBFGSParams(**options.pop("params")),
                mesh=dist.group.WORLD, device=dev, **options)
        else:
            res = lt.minimize_b_batched(
                fun, _t(x0s, dev), _t(lb, dev), _t(ub, dev),
                lt.LBFGSBParams(**options.pop("params")),
                mesh=dist.group.WORLD, device=dev, **options)
        out[name] = _solve_fields(res, coll.COUNTS)
    return out


def weighted(x, d):
    """``sum (x - d)^2 (1 + 0.1 d^2)`` and its gradient, batched over the
    rows of ``x`` and ``d`` (tests/test_sharded.py:179-182)."""
    r = x - d
    w = 1.0 + 0.1 * d * d
    return torch.sum(r * r * w, -1), 2.0 * r * w


def mesh_2d(d, x0, params: dict, feat: int = 2, device: str = "cpu") -> dict:
    """The 2-D batch x feature composition (tests/test_sharded.py:152-212)
    on the default group: ``world / feat`` batch blocks, each a group of
    ``feat`` ranks that split its instances' features.  Every rank builds
    the same subgroups (all ranks call ``new_group`` for every group, in
    one order): the feature group of rank r holds ranks ``feat * (r //
    feat)`` onwards, its batch group the ranks with its feature index.  It
    solves its ``[B / blocks, n / feat]`` block with the batched L-BFGS
    under ``group=`` its feature group, the objective's partial values
    summed by ``collectives.psum_scalar``; returns its block of x, the
    replicated fields and the rows and columns it held."""
    dev = torch.device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    feat_groups = [dist.new_group(list(range(k, k + feat)))
                   for k in range(0, world, feat)]
    batch_groups = [dist.new_group(list(range(j, world, feat)))
                    for j in range(feat)]
    fgroup, bgroup = feat_groups[rank // feat], batch_groups[rank % feat]
    lo, hi = coll.block(np.shape(d)[0], bgroup)
    d_block = lt.shard(_t(d, dev)[lo:hi], fgroup).contiguous()

    def fg(x):
        fx, grad = weighted(x, d_block)
        return coll.psum_scalar(fx, fgroup, "objective"), grad

    res = lt.minimize_sharded(local_fun_and_grad=fg, x0=_t(x0, dev)[lo:hi],
                              params=lt.LBFGSParams(**params), mesh=fgroup,
                              device=dev)
    cols = coll.block(np.shape(d)[1], fgroup)
    return {**_solve_fields(res), "rows": (lo, hi), "cols": cols}


def audit(device: str = "cpu") -> dict:
    """The cases of tests/test_collective_audit.py on this group, n = 16
    per rank: each solve's all-reduce calls by site, beside its niter and
    nfev."""
    dev = torch.device(device)
    n = 16 * dist.get_world_size()
    out = {}

    def run(name, fn):
        coll.COUNTS.clear()
        res = fn()
        out[name] = {"counts": dict(coll.COUNTS), "niter": res.niter,
                     "nfev": res.nfev}

    def local_fun(x):
        return torch.sum((x - 1.0) ** 2) + 0.1 * torch.sum(x ** 4)

    x0 = torch.zeros(n, dtype=torch.float64, device=dev)
    p = lt.LBFGSParams(epsilon=1e-8, max_iterations=50)
    for direction in ("sweeps", "rinv"):
        run(f"lbfgs_{direction}", lambda d=direction: lt.minimize_sharded(
            local_fun, x0, p, direction=d, device=dev))
    # The box cases: JAX's audit quadratic ends in 2 iterations without
    # the BOXCQP loop, so Rosenbrock in a random box, which runs every
    # site of the path, takes its place.
    rng = np.random.default_rng(0)
    lb = _t(rng.uniform(-1.5, -0.2, n), dev)
    ub = _t(rng.uniform(0.3, 0.9, n), dev)
    pb = lt.LBFGSBParams(epsilon=1e-8, max_iterations=100)
    for gcp in ("walk", "walk_chunked", "auto"):
        run(f"box_{gcp}", lambda g=gcp: lt.minimize_b_sharded(
            objectives.rosenbrock, torch.full_like(x0, 0.25), lb, ub, pb,
            gcp=g, device=dev))
    run("owlqn", lambda: lt.minimize_owlqn_sharded(local_fun, x0, 0.1, p,
                                                   device=dev))
    rng = np.random.default_rng(3)
    theta = rng.uniform(-1.0, 1.0, n)
    for pre in (True, False):
        res = implicit(theta, pre, device)
        out[f"implicit_{pre}"] = {"counts": {**res["forward"],
                                             **res["backward"]}}
    return out


def ridge_logreg(a_local, b, group):
    """``sum log(1 + exp(-b A w)) + 0.5 lam ||w||^2`` with A split on its
    columns, batched over ``w_local [B, n_local]`` and the per-instance
    ``lam [B]``: the logits' and the penalty's all-reduces have a
    backward (:func:`..parallel.collectives.psum_grad`)."""
    def fg(w, lam):
        logits = coll.psum_grad(w @ a_local.T, group, "ridge.logits")
        z = -b * logits
        ridge = coll.psum_grad(0.5 * lam * (w * w).sum(-1), group,
                               "ridge.penalty")
        fx = torch.logaddexp(torch.zeros_like(z), z).sum(-1) + ridge
        return fx, (-b * torch.sigmoid(z)) @ a_local + lam[:, None] * w
    return fg


def implicits(theta, a, b, lam, device: str = "cpu") -> dict:
    """:func:`implicit` with and without the preconditioner, and the
    gradients of ``sum(x*^2) + f(x*)`` in lam through :func:`ridge_logreg`
    (``implicit_minimize_sharded(local_fun_and_grad=)``) and in theta
    through :func:`implicit_objective`."""
    out = {pre: implicit(theta, pre, device) for pre in (True, False)}
    dev = torch.device(device)
    a = _t(a, dev)
    lo, hi = coll.block(a.shape[1], dist.group.WORLD)
    lam_t = torch.as_tensor(lam, dtype=a.dtype, device=dev)
    lam_t.requires_grad_(True)
    res = lt.implicit_minimize_sharded(
        local_fun_and_grad=ridge_logreg(a[:, lo:hi].contiguous(),
                                        _t(b, dev), dist.group.WORLD),
        x0=torch.zeros(a.shape[1], dtype=a.dtype, device=dev),
        theta=lam_t, params=lt.LBFGSParams(epsilon=1e-10,
                                           max_iterations=200),
        device=dev)
    # the loss sum(w^2) + fx: this rank's block and the replicated value
    ((res.x ** 2).sum() + res.fx).backward()
    out["ridge"] = {"x": res.x, "niter": res.niter, "grad": lam_t.grad}
    # the same loss through a partial objective
    th = torch.as_tensor(theta, device=dev).clone().requires_grad_(True)
    lo, hi = coll.block(th.shape[0], dist.group.WORLD)
    res = lt.implicit_minimize_sharded(
        lambda x, t: implicit_objective(x, t, lo, hi),
        torch.zeros_like(th), th,
        lt.LBFGSParams(epsilon=1e-8, max_iterations=50), device=dev)
    ((res.x ** 2).sum() + res.fx).backward()
    out["partial_fx"] = {"x": res.x, "niter": res.niter, "grad": th.grad}
    return out


def make_chained_rosenbrock(group, lo: int, hi: int):
    """The feature-split chained Rosenbrock of the box example
    (example-rosenbrock-box.cpp:12-35), ``(x_0 - 1)^2 + sum_i 4 (x_i -
    x_{i-1}^2)^2``, as a batched ``local_fun_and_grad`` on the block
    ``[lo, hi)``: the coupling term at ``lo`` needs the previous block's
    last coordinate, and its gradient there belongs to that block, so an
    evaluation takes one all-reduce of the blocks' edges and one of the
    partial values with the edges' gradients."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def fg(x):
        batch = x.shape[0]
        edges = x.new_zeros(batch, world)
        edges[:, rank] = x[:, -1]
        edges = coll.psum(edges, group, "chained.edges")
        grad = torch.zeros_like(x)
        back = x.new_zeros(batch)
        if rank == 0:
            left = x[:, :-1]
            r = x[:, 1:] - left * left
            fx = (x[:, 0] - 1.0) ** 2 + 4.0 * (r * r).sum(1)
            grad[:, 0] = 2.0 * (x[:, 0] - 1.0)
            grad[:, 1:] += 8.0 * r
            grad[:, :-1] += -16.0 * left * r
        else:
            prev = edges[:, rank - 1]
            r = x - torch.cat([prev[:, None], x[:, :-1]], 1) ** 2
            fx = 4.0 * (r * r).sum(1)
            grad += 8.0 * r
            grad[:, :-1] += -16.0 * x[:, :-1] * r[:, 1:]
            back = -16.0 * prev * r[:, 0]          # d / d x_{lo - 1}
        parts = x.new_zeros(batch, 1 + world)
        parts[:, 0] = fx
        parts[:, rank] += back if rank > 0 else 0.0
        red = coll.psum(parts, group, "chained.value")
        if rank + 1 < world:
            grad[:, -1] += red[:, rank + 1]
        return red[:, 0], grad

    return fg


def make_sharded_lasso(a_local, b, group):
    """``0.5 ||A x - b||^2`` with A split on its columns, batched: one
    all-reduce of the ``[B, rows]`` products per evaluation."""
    def fg(x):
        r = coll.psum(x @ a_local.T, group, "lasso.residual") - b
        return 0.5 * (r * r).sum(-1), r @ a_local
    return fg


def chip_cases(n: int, device: str = "cuda") -> dict:
    """The feature-split cases of ``chip_smoke.py`` phase 24 at size n,
    f64, on the default group (two gloo ranks sharing a card, or the
    parent's group of one): the logistic regression through
    ``minimize_sharded``, the chained Rosenbrock in [2, 4] through
    ``minimize_b_sharded(gcp="auto")`` from its lower bound, a lasso
    through ``minimize_owlqn_sharded`` and ``implicit_minimize_sharded``'s
    hypergradient.  The data are made on the device from seeded
    generators, the whole problem on every rank, each rank taking its
    block."""
    dev = torch.device(device)
    group = dist.group.WORLD
    lo, hi = coll.block(n, dist.group.WORLD)
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=f64, device=dev)

    out = {}

    def run(name, fn):
        cauchy_rounds = _walk_rounds()
        coll.COUNTS.clear()
        res = fn()
        out[name] = _solve_fields(res, coll.COUNTS)
        out[name]["walk_rounds"] = _walk_rounds() - cauchy_rounds

    a = randn(32, n) / n ** 0.5
    b = torch.sign(a @ randn(n) + 0.1 * randn(32))
    fg = objectives.make_sharded_logreg(a[:, lo:hi].contiguous(), b, group)
    zeros = torch.zeros(n, dtype=f64, device=dev)
    run("logreg", lambda: lt.minimize_sharded(
        local_fun_and_grad=fg, x0=zeros,
        params=lt.LBFGSParams(epsilon=1e-6, max_iterations=200),
        device=dev))
    run("box_auto", lambda: lt.minimize_b_sharded(
        local_fun_and_grad=make_chained_rosenbrock(group, lo, hi),
        x0=torch.full_like(zeros, 2.0), lb=2.0, ub=4.0,
        params=lt.LBFGSBParams(epsilon=1e-6, max_iterations=100),
        gcp="auto", device=dev))
    a2 = randn(64, n) / n ** 0.5
    b2 = a2[:, :32] @ randn(32)
    lam = 0.5 * float((a2.T @ b2).abs().max())
    run("owlqn", lambda: lt.minimize_owlqn_sharded(
        local_fun_and_grad=make_sharded_lasso(a2[:, lo:hi].contiguous(), b2,
                                              group),
        x0=zeros, l1=lam,
        params=lt.LBFGSParams(epsilon=1e-8, max_iterations=500),
        device=dev))
    theta = torch.rand(n, generator=gen, dtype=f64, device=dev) * 2 - 1
    out["implicit"] = implicit(theta, True, device)
    return out


def _walk_rounds() -> int:
    from lbfgspp_tpu_torch.ops import cauchy
    return cauchy.WALK_COUNTS["rounds"]

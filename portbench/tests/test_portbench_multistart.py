"""The multistart cells end to end at a tiny size on the CPU (the native
core's host build), their controls, and each fault the cells can have,
planted under the entry: every one comes out not correct.  The entries in
no cell yet (the eager batched path, the box paths) run too."""

import copy
import types

import pytest
import torch

from lbfgspp_tpu_torch import native
from portbench import control, run
from portbench.reference import rosenbrock100_multistart as rosenbrock

SEED = 2 ** 33 + 17
CELLS = ["rosen100.native", "rosen100.native_bracketing"]


def small(name, batch=48):
    spec, cell, cfg, traffic = run.resolve(name)
    traffic = copy.deepcopy(traffic)
    traffic["batch"] = batch
    traffic["check"].update(per_unit=32, sample=24)
    return spec, cell, cfg, traffic


def go(name, answers=None, **kw):
    spec, cell, cfg, traffic = small(name, **kw)
    return run.run_cell(spec, cell, cfg, traffic, SEED, 0.0, False, "cpu",
                        answers=answers)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    out = go(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 48 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[:6] == ["correct", "attempted", "failed", "metrics",
                             "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    spec, cell, cfg, traffic = small(name)
    traffic, answers = control.setup(traffic)
    out = run.run_cell(spec, cell, cfg, traffic, SEED, 0.0, False, "cpu",
                       answers=answers)
    assert not out["correct"], out["checks"]


def _broken(fault, solve):
    """``solve(x0s) -> x`` with the fault planted where x is produced."""
    def wrap(x0s):
        x0s = torch.as_tensor(x0s)
        if fault == "unchanged":
            return x0s.clone()
        if fault == "half":
            h = x0s.shape[0] // 2
            return torch.cat([solve(x0s[:h]), x0s[h:].clone()])
        x = solve(x0s)
        x[:, 0] += 1e-3
        return x
    return wrap


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_native_faults(monkeypatch, fault, name):
    real = native.minimize_batch

    def fake(fun, x0s, params, line_search, device=None):
        x = _broken(fault, lambda x0: real(fun, x0, params, line_search,
                                            device=device).x)(x0s)
        fx = torch.tensor([float(rosenbrock.fg(r.numpy())[0]) for r in x],
                          dtype=torch.float64)
        z = torch.zeros(len(x), dtype=torch.int32)
        return native.NativeBatchResult(x, fx, z, z, z)
    monkeypatch.setattr(native, "minimize_batch", fake)
    out = go(name)
    assert not out["correct"], out["checks"]


def test_reference_searches_agree_with_the_host_build():
    """The plain reference's two searches against the native core's host
    build from the same starts: the same instances reach the bar."""
    from lbfgspp_tpu_torch import LBFGSParams
    x0s = torch.rand(6, 20, dtype=torch.float64) * 4 - 2
    over = dict(m=6, max_linesearch=256, max_iterations=400)
    for search in rosenbrock.SEARCHES:
        res = native.minimize_batch("rosenbrock", x0s, LBFGSParams(**over),
                                    search, device="cpu")
        p = rosenbrock.params(dict(over, line_search=search))
        for x0, x in zip(x0s.numpy(), res.x.numpy()):
            ref = rosenbrock.solve(x0, p)[0]
            assert abs(ref - 1).max() <= 1e-4
            assert abs(x - ref).max() <= 1e-4


# the eager batched recipe (bench.py:81-116) at a tiny size; no cell
# runs it yet (PERF.md, open questions)
EAGER = dict(
    entry="eager_batched", objective="rosenbrock", batch=24,
    dtype="float32", trace_units=1,
    params=dict(epsilon=1e-5, max_iterations=162, m=16, max_linesearch=2),
    polish_params=dict(epsilon=1e-5, max_iterations=162, m=16),
    options=dict(line_search="nocedalwright", direction="rinv",
                 on_ls_fail="restart", polish_iters=5, polish_warm=True,
                 polish_line_search="morethuente"),
    check=dict(per_unit=24, sample=12, reference=dict(
        m=6, epsilon=1e-10, epsilon_rel=0.0, max_linesearch=256,
        max_iterations=2000)),
    limits=dict(disputed=0.15))


def test_eager_entry_and_its_readers():
    """The eager entry through the harness, traced, with its per-layer
    readers and a cell's own name of ``solves_per_s``."""
    cfg = run.load_json(run.HERE, "configs", "rosenbrock100_multistart.json")
    names = ["aten_ops_per_batch", "two_loop_launches_per_batch",
             "two_loop_roofline", "idle_share.eager"]
    spec = dict(end_to_end=[dict(name="solves_per_s.eager",
                                 unit="solves/s")],
                per_layer=[dict(name=n, unit="x") for n in names])
    cell = dict(name="eager", config=cfg["name"])
    out = run.run_cell(spec, cell, cfg, EAGER, SEED, 0.0, True, "cpu")
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["aten_ops_per_batch"]["value"] > 1000
    # no kernel on the CPU: the roofline finds nothing to read
    assert "two_loop_roofline" not in m
    assert "two_loop_launches_per_batch" in m
    out = run.run_cell(spec, cell, cfg, EAGER, SEED, 0.0, False, "cpu")
    assert out["metrics"]["solves_per_s.eager"]["value"] > 0


@pytest.mark.parametrize("entry", ["native_box_batch", "eager_box_batched"])
def test_box_entries_run(entry):
    cfg = dict(n=10, start_box=[2.0, 4.0], bounds=[2.0, 4.0], bar=1e-3,
               x_star=1.0)
    traffic = dict(batch=16, check=dict(per_unit=4, sample=4),
                   params=dict(max_iterations=60), dtype="float64",
                   options=dict(gcp="scan"))
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=SEED, device=torch.device("cpu"),
        trace=False, objective=run.load_module("objectives", "rosenbrock"))
    e = run.load_module("entries", entry).make(ctx)
    e.warm()
    attempted, failed, good = e.unit(0)
    assert (attempted, failed) == (16, 0)
    assert e.sample()["x"].shape == (4, 10)
    assert e.counters()

"""The box cell ``rosen10box.native`` end to end at a tiny size on the CPU
(``native.minimize_b_batch`` on the host build), its float32 control, and
faulted answers in the program's place: each comes out not correct."""

import copy

import numpy as np
import pytest

from portbench import control, run

SEED = 2 ** 33 + 29
CELL = "rosen10box.native"


def small(batch=48):
    spec, cell, cfg, traffic = run.resolve(CELL)
    traffic = copy.deepcopy(traffic)
    traffic["batch"] = batch
    traffic["check"].update(per_unit=24, sample=24)
    return spec, cell, cfg, traffic


def go(answers=None, trace=False):
    spec, cell, cfg, traffic = small()
    return run.run_cell(spec, cell, cfg, traffic, SEED, 0.0, trace, "cpu",
                        answers=answers)


def test_cell_runs_and_is_correct():
    out = go()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 48 and out["failed"] == 0
    assert set(out["metrics"]) == {"solves_per_s", "batch_p90_s", "setup_s"}
    n = out["numbers"]
    assert n["sample"] == 24 and n["infeasible"] == 0
    assert n["frac_program"] == n["frac_reference"] == 1.0
    assert n["x_gap"] <= 1e-10
    assert out["counters"]["native_box_launches"] == 0   # the host build


def test_traced_run_counts_the_box_flops():
    """Traced on the CPU: no kernel and no probe, so the card's metrics
    find nothing to read; the entry still counts the yardstick's flops."""
    out = go(trace=True)
    assert out["correct"], out["checks"]
    assert out["extras"]["native_flops"] > 0
    assert out["extras"]["native_bytes"] == 48 * (4 * 10 * 8 + 28)
    assert "native_box_roofline" not in out["metrics"]
    assert "native_box_cauchy_share" not in out["metrics"]


def _fault(kind):
    def answers(sample, ctx):
        x, fx = sample["x"].copy(), sample["fx"].copy()
        if kind == "outside":
            x[0, 0] = 2.0 - 1e-12
        elif kind == "x2":
            x[:, 2] += 1e-6
        else:
            fx += 1e-6
        return dict(sample, x=x, fx=fx)
    return answers


@pytest.mark.parametrize("kind, number", [("outside", "infeasible"),
                                          ("x2", "x_gap_median"),
                                          ("fx", "disputed")])
def test_faulted_answers_are_not_correct(kind, number):
    """One coordinate of one answer 1e-12 outside its box; x[2] of every
    answer moved by 1e-6; every reported fx off by 1e-6."""
    out = go(answers=_fault(kind))
    assert not out["correct"]
    check = out["checks"][number]
    assert check["value"] > check["limit"], out["checks"]


def test_float32_control_is_not_correct():
    spec, cell, cfg, traffic = small()
    traffic, answers = control.setup(traffic)
    out = run.run_cell(spec, cell, cfg, traffic, SEED, 0.0, False, "cpu",
                       answers=answers)
    assert not out["correct"], out["checks"]
    assert out["checks"]["x_gap_median"]["value"] > \
        out["checks"]["x_gap_median"]["limit"]


def test_reference_refuses_other_bounds():
    """The traffic's reference bounds must be the configuration's."""
    spec, cell, cfg, traffic = small()
    ref = run.load_module("reference", cfg["name"])
    check = copy.deepcopy(traffic["check"])
    check["reference"]["bounds"][2] = [2.0, 4.0]
    sample = dict(x0=np.full((1, 10), 3.0), x=np.full((1, 10), 3.0),
                  fx=np.zeros(1))
    with pytest.raises(ValueError):
        ref.compare(sample, cfg, check)

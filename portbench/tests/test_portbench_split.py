"""The split logistic-regression cell through the multi-rank harness, on
gloo CPU ranks at a tiny size (n = 4096, 2048 rows): one sound line on 2
and on 4 ranks; a rank that raises and a rank that hangs each end the run
with a non-zero code inside its limit; the four controls and each fault
the cell can have come out not correct; and the yardstick's byte count."""

import copy
import time

import pytest
import torch

from portbench import hashed_rows, run, yardstick

SEED = 2 ** 33 + 5
CELL = "logreg1e9.split4"
HOOKS = "portbench.tests.split_faults:hooks"


def small():
    spec, cell, cfg, traffic = run.resolve(CELL)
    cfg = dict(cfg, n=4096, rows=2048, block_rows=512)
    return spec, cell, cfg, copy.deepcopy(traffic)


def go(world=2, trace=False, hooks=None, args=(), limit_s=120):
    spec, cell, cfg, traffic = small()
    return run.launch(spec, cell, cfg, traffic, SEED, 0.2, trace, world,
                      kind="cpu", backend="gloo", hooks=hooks,
                      hook_args=args, limit_s=limit_s)


@pytest.mark.parametrize("world", [2, 4])
def test_sound_line(world):
    rc, out = go(world)
    assert rc == 0 and out["correct"], out and out["checks"]
    assert out["device"]["count"] == world
    assert out["attempted"] == out["units"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"iters_per_s", "setup_s"}
    assert list(out)[:6] == ["correct", "attempted", "failed", "metrics",
                             "device", "checks"]
    line = run.line_of(out)
    assert line.index('"checks"') > line.index('"device"')


def test_traced_line_takes_the_least_busy_card():
    rc, out = go(2, trace=True)
    assert rc == 0 and out["correct"]
    assert "breakdown" in out and "window_s" in out["device"]
    # no device on the CPU: the device readers find nothing to read
    assert set(out["metrics"]) == {"idle_share.split"}


@pytest.mark.parametrize("fault", ["raise", "hang"])
def test_a_failing_rank_ends_the_run(fault):
    t0 = time.monotonic()
    rc, out = go(2, hooks=HOOKS, args=[fault], limit_s=25)
    assert out is None
    assert rc == (run.EXIT_RANK if fault == "raise" else run.EXIT_LIMIT)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("kind", ["pairs_m_minus_1", "unreduced_logits",
                                  "design_bf16", "history_bf16"])
def test_control_is_not_correct(kind):
    rc, out = go(2, hooks="portbench.control:hooks", args=[kind])
    assert rc == 0 and not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange",
                                   "altered"])
def test_fault_is_not_correct(fault):
    rc, out = go(2, hooks=HOOKS, args=[fault])
    assert rc == 0 and not out["correct"], out["checks"]


def test_eval_bytes_count_each_pass_once():
    nnz, rows, n_local, touched = 10, 4, 6, 5
    assert yardstick.logreg_eval_bytes(nnz, rows, n_local, touched) == (
        2 * 8 * nnz + 4 * (rows + 1) + 4 * (n_local + 1) + 4 * touched +
        20 * rows + 8 * n_local)


def test_local_design_is_the_rows_split():
    """Two ranks' blocks of the design, side by side, are the rows; the
    transpose holds the same entries; the same seed draws the same."""
    _, _, cfg, _ = small()
    dense = torch.zeros(cfg["rows"], cfg["n"])
    for b in range(hashed_rows.block_count(cfg)):
        c, v, _ = hashed_rows.block(cfg, SEED, b, "cpu")
        rows = torch.arange(c.shape[0])[:, None].expand_as(c) + \
            b * cfg["block_rows"]
        dense.index_put_((rows.reshape(-1), c.reshape(-1)), v.reshape(-1),
                         accumulate=True)
    half = cfg["n"] // 2
    for rank in range(2):
        d = hashed_rows.local_design(cfg, SEED, rank * half, half, "cpu")
        a = torch.sparse_csr_tensor(d["crow"], d["col"], d["val"],
                                    (d["rows"], half)).to_dense()
        at = torch.sparse_csr_tensor(d["tcrow"], d["trow"], d["tval"],
                                     (half, d["rows"])).to_dense()
        part = dense[:, rank * half:(rank + 1) * half]
        assert torch.equal(a, part) and torch.equal(at, part.T)
        assert d["nnz"] == int((d["crow"][1:] - d["crow"][:-1]).sum())
    again = hashed_rows.block(cfg, SEED, 1, "cpu")
    first = hashed_rows.block(cfg, SEED, 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(again, first))
    assert (first[0].shape[1] == cfg["integer_fields"] +
            cfg["categorical_fields"] + 1)

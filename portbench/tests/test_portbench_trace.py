"""The traced window's arithmetic: busy time is a union clipped to the
window span, never a sum, and the self-check refuses what lies outside
(0, window]."""

import pytest

from portbench import trace as tr

MS = 1_000_000


def ev(name, kind, start_ms, end_ms, device=0):
    return tr.Event(name, kind, device, int(start_ms * MS), int(end_ms * MS))


def window_events():
    """A 100 ms window; a compute stream busy 10-60 ms; a second stream
    overlapping it 40-80 ms; an NCCL-like kernel that starts before the
    window and ends after it (it waits for its peers); another device's
    kernel; the harness's spans."""
    return [
        ev(tr.WINDOW_SPAN, "span", 0, 100, -1),
        ev("portbench.unit", "span", 0, 100, -1),
        ev("portbench.check", "span", 85, 95, -1),
        ev("gemm", "device", 10, 60),
        ev("axpy", "device", 40, 80),
        ev("ncclDevKernel_AllReduce_Sum_f32", "device", -20, 30),
        ev("ncclDevKernel_AllReduce_Sum_f32", "device", 90, 130),
        ev("other card", "device", 0, 100, device=1),
        ev("aten::mul", "cpu", 5, 6, -1),
        ev("aten::add", "cpu", 150, 151, -1),
    ]


def test_union_with_overlapping_streams_stays_inside_the_window():
    s = tr.summarize(window_events(), device=0)
    total = sum(v[0] for v in s["by_kernel"].values())
    assert s["window_s"] == pytest.approx(0.100)
    # 0-30 (NCCL, clipped), 10-80 (two streams), 90-100 (NCCL, clipped)
    assert s["busy_s"] == pytest.approx(0.090)
    assert 0 < s["busy_s"] <= s["window_s"]
    raw = (60 - 10) + (80 - 40) + (30 + 20) + (130 - 90)
    assert raw * 1e-3 > s["window_s"]        # the sum would exceed it
    assert total == pytest.approx(0.130)     # per-kernel sums, clipped
    assert s["aten_ops"] == 1
    tr.check_busy(s["busy_s"], s["window_s"])


def test_idle_gaps_named_by_the_open_span():
    s = tr.summarize(window_events(), device=0)
    assert s["breakdown"]["idle_gaps"] == [
        ["portbench.check", pytest.approx(0.010)]]
    assert s["breakdown"]["device_ops"][0][0] == "gemm"


def test_union_helpers():
    assert tr.merge([(5, 9), (1, 3), (2, 4), (9, 10)]) == [(1, 4), (5, 10)]
    assert tr.union_ns([(0, 10), (5, 15)], 2, 12) == 10
    assert tr.idle_gaps([(2, 4), (6, 8)], 0, 10) == [(0, 2), (4, 6), (8, 10)]
    assert tr.union_ns([], 0, 10) == 0


@pytest.mark.parametrize("busy,window", [
    (0.0, 1.0), (-1.0, 1.0), (1.5, 1.0), (float("nan"), 1.0),
    (0.5, float("inf")), (None, 1.0)])
def test_self_check_refuses(busy, window):
    with pytest.raises(tr.BusyCheckError):
        tr.check_busy(busy, window)


def test_self_check_takes_the_edges():
    tr.check_busy(1.0, 1.0)
    tr.check_busy(1e-9, 1.0)


def test_no_window_span_is_refused():
    with pytest.raises(tr.BusyCheckError):
        tr.summarize([ev("gemm", "device", 0, 1)], device=0)

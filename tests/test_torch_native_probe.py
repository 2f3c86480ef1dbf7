"""The probe of the native L-BFGS kernel, on the CPU.

The switch (a recording ``torch.profiler``, and ``native.probing``), the
reduction of a launch's records, ``probe_records`` and ``reset_counts``,
the card path's span ``lbfgspp.native.launch`` and its summary with the
C launch stubbed, and the arithmetic of the six portbench readers on
hand-made summaries.  The probed kernel itself runs in
``test_torch_native_emulated.py`` (emulated, bit for bit against the
default kernel) and ``test_torch_cuda.py`` (on the card).
"""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lbfgspp_tpu_torch import LBFGSParams, native
from portbench import run as portbench

# two launches' summaries, as probe_records gives them
RECORDS = [
    dict(batch=120000, slots=1584, span_ns=200_000_000, busy_ns=300 * 10**9,
         total=510 * 10**9, eval=100 * 10**9, search=200 * 10**9,
         direction=150 * 10**9, host_ns=400_000),
    dict(batch=120000, slots=1584, span_ns=250_000_000, busy_ns=360 * 10**9,
         total=612 * 10**9, eval=110 * 10**9, search=250 * 10**9,
         direction=160 * 10**9, host_ns=600_000),
]
# each reader's value on RECORDS, worked by hand
READINGS = {
    "native_slot_use": 100 * 660 / (1584 * 0.45),
    "native_eval_share": 100 * 210 / 1122,
    "native_search_share": 100 * 450 / 1122,
    "native_direction_share": 100 * 310 / 1122,
    "native_sm_ghz": 1122 / 660,
    "native_host_ms": 0.5,
}


@pytest.mark.parametrize("name", list(READINGS))
def test_reader_arithmetic(monkeypatch, name):
    """Each reader on hand-made summaries; None with no records, and None
    from a program without the probe (a parent commit's)."""
    read = portbench.reader(name).read
    monkeypatch.setattr(native, "probe_records", lambda: RECORDS)
    assert read({}) == pytest.approx(READINGS[name], rel=1e-12)
    monkeypatch.setattr(native, "probe_records", list)
    assert read({}) is None
    monkeypatch.delattr(native, "probe_records")
    assert read({}) is None


def test_probe_summary_on_cpu():
    """The reduction of a [B, 6] record buffer, against a loop."""
    g = torch.Generator().manual_seed(0)
    start = torch.randint(10**18, 10**18 + 10**6, (37,), generator=g)
    probe = torch.stack([start, start + torch.randint(0, 10**6, (37,),
                                                      generator=g)]
                        + [torch.randint(0, 10**9, (37,), generator=g)
                           for _ in range(4)], 1)
    rows = probe.tolist()
    want = [max(r[1] for r in rows) - min(r[0] for r in rows),
            sum(r[1] - r[0] for r in rows),
            *(sum(r[k] for r in rows) for k in range(2, 6))]
    got = native.probe_summary(probe)
    assert got.dtype == torch.int64 and got.tolist() == want
    assert len(native.SUMMARY_FIELDS) == 3 + len(got)


def test_probing_follows_the_profiler_and_the_override():
    assert not native.is_probing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert native.is_probing()
        with native.probing(False):
            assert not native.is_probing()
        assert native.is_probing()
    assert not native.is_probing()
    with native.probing():
        assert native.is_probing()
        with native.probing(False):
            assert not native.is_probing()
        assert native.is_probing()
    assert not native.is_probing()


@pytest.fixture
def stubbed_card(monkeypatch):
    """The card path with the C launch replaced: a probed launch fills its
    records with known values; returns the launches' probe arguments."""
    seen = []
    fake = torch.tensor([[100, 900, 5000, 1000, 2000, 1500],
                         [300, 1000, 4000, 900, 1800, 1100],
                         [200, 700, 3000, 500, 900, 800]])

    def launch(lib, box, bid, xs, params, ls, out, probe=None):
        seen.append(probe)
        if probe is not None:
            probe.copy_(fake[torch.arange(len(probe)) % len(fake)])
        return native.Plan(1, 12, 16928)

    monkeypatch.setattr(native, "_device_lib", lambda contract: None)
    monkeypatch.setattr(native, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    native.reset_counts()
    yield seen
    native.reset_counts()


def _card(xs):
    return native._card_batch(lambda: xs, "rosenbrock", LBFGSParams(),
                              "nocedalwright", None, True)


def test_card_path_probes_while_a_profiler_records(stubbed_card):
    """Unprofiled: the default kernel, no record.  Profiled: the probed
    kernel, the host span in the trace, and one summary with the probed
    plan's slots and the span's nanoseconds; reset_counts drops it."""
    xs = torch.zeros(3, 10, dtype=torch.float64)
    _card(xs)
    assert stubbed_card == [None] and native.probe_records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _card(xs)
    assert stubbed_card[1].shape == (3, 6)
    assert native.LAUNCH_SPAN in {e.name for e in prof.events()}
    (rec,) = native.probe_records()
    host_ns = rec.pop("host_ns")
    assert 0 < host_ns < 10**10
    assert rec == dict(batch=3, slots=132 * 12, span_ns=900, busy_ns=2000,
                       total=12000, eval=2400, search=4700, direction=3400)
    assert native.native_lbfgs_batch.launches == 2
    native.reset_counts()
    assert native.probe_records() == []
    assert native.native_lbfgs_batch.launches == 0


def test_probe_buffer_is_reused_while_the_batch_size_holds(stubbed_card):
    xs = torch.zeros(3, 10, dtype=torch.float64)
    with native.probing():
        _card(xs)
        _card(xs.clone())
        _card(torch.zeros(4, 10, dtype=torch.float64))
    assert stubbed_card[0] is stubbed_card[1]
    assert stubbed_card[2].shape == (4, 6)
    assert [r["batch"] for r in native.probe_records()] == [3, 3, 4]

"""The traced window's arithmetic: busy time, idle gaps, kernel totals.

A traced run profiles its measured window with ``torch.profiler`` inside
the harness's own span ``portbench.window``.  Everything here reads the
events of that one trace, so the window and the device's intervals are on
one clock (the profiler's; CUPTI's device timestamps are converted to it).

* ``window_s`` is the span's duration.
* ``busy_s`` is the length of the **union** of the device's kernel, copy
  and memset intervals, over all of its streams, clipped to the span.
  Kernels on different streams overlap (a collective's run on their own
  stream and wait there for their peers), so a sum of kernel times can
  exceed the window; a union cannot.

The functions take plain tuples, so the CPU tests drive them directly.
An event is ``Event(name, kind, device, start_ns, end_ns)`` with ``kind``
one of ``"device"`` (a kernel, copy or memset on ``device``), ``"span"``
(a ``record_function`` span of the harness) or ``"cpu"`` (an operator).
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

WINDOW_SPAN = "portbench.window"
SPAN_PREFIX = "portbench."
# kineto's activity types of work that occupies the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset",
                     "concurrent_kernel")
TOP = 10


class Event(NamedTuple):
    name: str
    kind: str
    device: int
    start_ns: int
    end_ns: int


class BusyCheckError(ValueError):
    """The traced window's busy time is not in (0, window]."""


def clip(intervals: Iterable[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    """The intervals cut to ``[lo, hi]``, empty ones dropped."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of the intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of the intervals inside ``[lo, hi]``."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def idle_gaps(intervals: Iterable[Tuple[int, int]], lo: int,
              hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def union_inside_ns(intervals: Iterable[Tuple[int, int]],
                    inside: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of ``intervals`` within the union of
    ``inside``."""
    ivs = merge(intervals)
    starts = [a for a, _ in ivs]
    total = 0
    for a, b in merge(inside):
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(ivs) and ivs[i][0] < b:
            total += max(0, min(ivs[i][1], b) - max(ivs[i][0], a))
            i += 1
    return total


def check_busy(busy_s: float, window_s: float) -> None:
    """Raise unless ``0 < busy_s <= window_s``, both finite."""
    ok = all(isinstance(v, (int, float)) and math.isfinite(v)
             for v in (busy_s, window_s))
    if not ok or not 0.0 < busy_s <= window_s:
        raise BusyCheckError(f"busy_s {busy_s!r} is not in (0, window_s "
                             f"{window_s!r}]")


def _innermost(spans: Sequence[Event], t: float) -> str:
    """The name of the shortest harness span open at ``t``."""
    best: Optional[Event] = None
    for s in spans:
        if s.start_ns <= t <= s.end_ns and (
                best is None or
                s.end_ns - s.start_ns < best.end_ns - best.start_ns):
            best = s
    return best.name if best is not None else WINDOW_SPAN


def summarize(events: Sequence[Event], device: int) -> Dict:
    """Read one device's share of a trace.

    Returns ``window_s``, ``busy_s`` (the union, clipped), ``by_kernel``
    (name -> [seconds inside the window, launches]), ``aten_ops`` (CPU
    operators named ``aten::`` inside the window), ``kernels`` (the
    device's ``(name, start_ns, end_ns)`` that overlap the window),
    ``spans`` (the harness's spans but the window's, clipped to it),
    ``span_ns`` (the window's ends), and the ``breakdown``
    of the contract: the ten device operations that took
    most time, and the ten longest idle gaps, each named by the innermost
    harness span open at its middle.  Raises :class:`BusyCheckError` if
    the trace has no window span."""
    windows = [e for e in events if e.kind == "span" and
               e.name == WINDOW_SPAN]
    if not windows:
        raise BusyCheckError(f"the trace has no {WINDOW_SPAN!r} span")
    w = max(windows, key=lambda e: e.end_ns - e.start_ns)
    lo, hi = w.start_ns, w.end_ns
    dev = [e for e in events if e.kind == "device" and e.device == device]
    ivs = [(e.start_ns, e.end_ns) for e in dev]
    busy = union_ns(ivs, lo, hi)
    by_kernel: Dict[str, List[float]] = {}
    for e in dev:
        inside = clip([(e.start_ns, e.end_ns)], lo, hi)
        if inside:
            row = by_kernel.setdefault(e.name, [0.0, 0])
            row[0] += (inside[0][1] - inside[0][0]) * 1e-9
            row[1] += 1
    aten = sum(1 for e in events if e.kind == "cpu" and
               e.name.startswith("aten::") and lo <= e.start_ns <= hi)
    spans = [e for e in events if e.kind == "span" and
             e.name.startswith(SPAN_PREFIX) and e is not w]
    gaps = sorted(idle_gaps(ivs, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(
        window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, by_kernel=by_kernel,
        aten_ops=aten,
        kernels=[(e.name, e.start_ns, e.end_ns) for e in dev
                 if e.end_ns > lo and e.start_ns < hi],
        spans=[(e.name, max(e.start_ns, lo), min(e.end_ns, hi))
               for e in spans if e.end_ns > lo and e.start_ns < hi],
        span_ns=(lo, hi),
        breakdown=dict(
            device_ops=[[name, row[0]] for name, row in top],
            idle_gaps=[[_innermost(spans, (a + b) / 2), (b - a) * 1e-9]
                       for a, b in gaps]))


def events_of(prof) -> List[Event]:
    """The profiler's events as :class:`Event` tuples: device work from
    the activity types in :data:`DEVICE_ACTIVITIES`, the harness's CPU
    spans (``portbench.*`` user annotations; their device-side copies are
    left out, they are not work) and the CPU operators."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        # older builds name no activity type; a user annotation is then
        # told by its flag, or by the harness's prefix
        kind = str(e.activity_type()) if hasattr(e, "activity_type") \
            else None
        note = (kind is not None and "annotation" in kind) or (
            hasattr(e, "is_user_annotation") and e.is_user_annotation()) \
            or name.startswith(SPAN_PREFIX)
        if str(e.device_type()).endswith("CUDA"):
            if (kind in DEVICE_ACTIVITIES) if kind is not None else not note:
                out.append(Event(name, "device", int(e.device_index()),
                                 start, end))
        elif note:
            if name.startswith(SPAN_PREFIX):
                out.append(Event(name, "span", -1, start, end))
        elif kind in (None, "cpu_op"):
            out.append(Event(name, "cpu", -1, start, end))
    return out

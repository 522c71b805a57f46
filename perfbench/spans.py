"""Device time and idle time put down to the program's own spans.

The program records host spans at its layer boundaries
(``repro_torch.core.spans``: ``(name, parent, t0_ns, t1_ns)`` on
``time.perf_counter_ns()``, with an anchor pair that places them on Unix
nanoseconds). A ``torch.profiler`` trace with the device activity alone
carries, beside each kernel, copy and fill, the host record of its launch
(``cudaLaunchKernel``, ``cuLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync``) under the same correlation id, on Unix nanoseconds
too, with the call's start and end. So:

* a device event is put down to the innermost span open at its launch;
* an idle gap (no device event running) is put down to the innermost
  span open at the launch of the event that ended it.

:func:`traced` runs a window under such a profile and keeps both kinds of
record; :class:`Attribution` joins them with the spans. The functions after
it read the quantities the per-layer numbers of ``PERF.md`` are made of.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemcpy|cudaMemset|"
                    r"cudaGraphLaunch)")
SYNC_SUFFIX = ".sync"


class Device(NamedTuple):
    name: str
    start_ns: int               # Unix ns
    end_ns: int
    corr: int                   # correlation id of its launch


class Window(NamedTuple):
    devices: List[Device]
    launches: Dict[int, Tuple[int, int]]   # correlation id -> the launch
    #                                        call's (start, end), Unix ns
    t0_ns: int                  # the window on Unix ns
    t1_ns: int


def traced(fn: Callable[[], object], sync: Callable[[], None]
           ) -> Tuple[object, Window]:
    """``fn()`` under ``torch.profiler`` with the device activity alone,
    as ``perfbench/trace.py`` runs it: (its result, the device events and
    their launch records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        out = fn()
        sync()
        t1 = time.time_ns()
    devices, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            devices.append(Device(ev.name(), ev.start_ns(), ev.end_ns(),
                                  ev.correlation_id()))
        elif LAUNCH.match(ev.name()):
            launches[ev.correlation_id()] = (ev.start_ns(), ev.end_ns())
    devices.sort(key=lambda d: d.start_ns)
    return out, Window(devices, launches, t0, t1)


def to_unix(anchor: Tuple[int, int], spans) -> List[Tuple[int, int]]:
    """Each span's ``(t0, t1)`` on Unix ns through the recorder's
    anchor ``(unix_ns, perf_counter_ns)``."""
    off = anchor[0] - anchor[1]
    return [(s.t0_ns + off, s.t1_ns + off) for s in spans]


def owners(spans, times: Sequence[Tuple[int, int]],
           at: Dict[int, int]) -> Dict[int, int]:
    """For each key of ``at`` (a time on the spans' clock), the index of
    the innermost span open at that time, -1 where none is."""
    marks = []
    for i, (t0, t1) in enumerate(times):
        marks.append((t0, 0, i))
        marks.append((t1, 2, i))
    for key, t in at.items():
        marks.append((t, 1, key))
    marks.sort(key=lambda m: (m[0], m[1]))
    out, stack = {}, []
    for _, kind, x in marks:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            if stack and stack[-1] == x:
                stack.pop()
            elif x in stack:
                stack.remove(x)
        else:
            out[x] = stack[-1] if stack else -1
    return out


class Attribution:
    """Device events and idle gaps of a window, each with the span it is
    put down to (-1: launched outside every span; ``None``: no launch
    record)."""

    def __init__(self, anchor, spans, window: Window):
        self.spans = spans
        self.window = window
        own = owners(spans, to_unix(anchor, spans),
                     {c: t0 for c, (t0, _) in window.launches.items()})
        self.owner = [own.get(d.corr) for d in window.devices]
        self._chains: Dict[int, Tuple[str, ...]] = {}

    def chain(self, i: Optional[int]) -> Tuple[str, ...]:
        """The names of span ``i`` and its ancestors, innermost first."""
        if i is None or i < 0:
            return ()
        if i not in self._chains:
            names, j = [], i
            while j >= 0:
                names.append(self.spans[j].name)
                j = self.spans[j].parent
            self._chains[i] = tuple(names)
        return self._chains[i]

    def key(self, o: Optional[int]) -> str:
        """The name an event is put down to: its span's, ``-`` outside
        every span, ``?`` without a launch record."""
        return "?" if o is None else (self.spans[o].name if o >= 0 else "-")

    @property
    def device_s(self) -> float:
        return sum(d.end_ns - d.start_ns for d in self.window.devices) / 1e9

    def attributed_share(self) -> float:
        """Share of the device seconds launched inside some span."""
        total = self.device_s
        got = sum(d.end_ns - d.start_ns for d, o in
                  zip(self.window.devices, self.owner)
                  if o is not None and o >= 0) / 1e9
        return got / total if total else 0.0

    def device_self_s(self) -> Dict[str, float]:
        """Device seconds by the innermost span of each event's launch."""
        out: Dict[str, float] = {}
        for d, o in zip(self.window.devices, self.owner):
            k = self.key(o)
            out[k] = out.get(k, 0.0) + (d.end_ns - d.start_ns) / 1e9
        return out

    def by_span_and_kernel(self) -> Dict[str, float]:
        """Device seconds by ``<innermost span> <kernel's short name>``."""
        from perfbench.trace import short_name
        out: Dict[str, float] = {}
        for d, o in zip(self.window.devices, self.owner):
            k = f"{self.key(o)} {short_name(d.name)}"
            out[k] = out.get(k, 0.0) + (d.end_ns - d.start_ns) / 1e9
        return out

    def device_under_s(self, name: str) -> float:
        """Device seconds of the events launched inside a span ``name``
        (at any depth)."""
        return sum(d.end_ns - d.start_ns for d, o in
                   zip(self.window.devices, self.owner)
                   if name in self.chain(o)) / 1e9

    def idle_s(self) -> Dict[str, float]:
        """Idle seconds of the window (between its start, the device
        events and its end) by the span open at the launch of the event
        that ended each gap; the tail after the last event is ``end``."""
        out: Dict[str, float] = {}
        end = self.window.t0_ns
        for d, o in zip(self.window.devices, self.owner):
            if d.start_ns > end:
                k = self.key(o)
                out[k] = out.get(k, 0.0) + (d.start_ns - end) / 1e9
            end = max(end, d.end_ns)
        if self.window.t1_ns > end:
            out["end"] = out.get("end", 0.0) + (self.window.t1_ns - end) / 1e9
        return out

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_by_span": head(self.device_self_s()),
                "idle_by_span": head(self.idle_s())}


# -- the per-layer numbers ----------------------------------------------------


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _waits(anchor, spans, t0_ns: int, t1_ns: int) -> List[Tuple[int, int]]:
    """The ``*.sync`` spans cut to the window, merged, in order (Unix
    ns)."""
    cut = sorted((max(a, t0_ns), min(b, t1_ns)) for s, (a, b) in
                 zip(spans, to_unix(anchor, spans))
                 if s.name.endswith(SYNC_SUFFIX) and b > t0_ns and a < t1_ns)
    out: List[Tuple[int, int]] = []
    for a, b in cut:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def host_busy_pct(anchor, spans, t0_ns: int, t1_ns: int) -> Optional[float]:
    """100 x the window's host time outside every ``*.sync`` span over
    the window (``t0_ns``, ``t1_ns`` on Unix ns). It counts as busy the
    time spent inside launch calls, a wait for room in a full launch
    queue included: :func:`host_launch_pct` is that part."""
    if not spans or t1_ns <= t0_ns:
        return None
    waits = _waits(anchor, spans, t0_ns, t1_ns)
    return 100.0 * (1.0 - union_ns(waits) / (t1_ns - t0_ns))


def host_launch_pct(anchor, spans, window: Window,
                    over_us: float = 0.0) -> Optional[float]:
    """100 x the window's host time inside launch calls (the records of
    :data:`LAUNCH`) longer than ``over_us``, outside every ``*.sync``
    span, over the window: the part of :func:`host_busy_pct` spent in
    the driver's launch and copy calls (with ``over_us`` 50, about the
    calls that waited for room in the launch queue). Launch calls do not
    overlap one another (one host thread)."""
    t0, t1 = window.t0_ns, window.t1_ns
    if not spans or not window.launches or t1 <= t0:
        return None
    waits = _waits(anchor, spans, t0, t1)
    starts = [a for a, _ in waits]
    total = 0
    for a, b in window.launches.values():
        if b - a <= over_us * 1e3:
            continue
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        total += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(waits) and waits[i][0] < b:
            total -= max(0, min(b, waits[i][1]) - max(a, waits[i][0]))
            i += 1
    return 100.0 * total / (t1 - t0)


def launch_us(window: Window) -> List[float]:
    """The launch calls' host durations (us), in order."""
    return sorted((b - a) / 1e3 for a, b in window.launches.values())


def device_pct(attr: Optional[Attribution], name: str) -> Optional[float]:
    """100 x the device seconds launched under span ``name`` over the
    window's device seconds; ``None`` where no span of that name ran."""
    if attr is None or not attr.device_s or not any(
            s.name == name for s in attr.spans):
        return None
    return 100.0 * attr.device_under_s(name) / attr.device_s


def ms_per_span(spans, name: str) -> Optional[float]:
    """Mean host milliseconds of the spans named ``name``."""
    ts = [s.t1_ns - s.t0_ns for s in spans if s.name == name]
    return sum(ts) / len(ts) / 1e6 if ts else None


def counts(spans) -> Dict[str, int]:
    return dict(Counter(s.name for s in spans))


def self_ns(spans) -> List[int]:
    """Each span's host time less that of its direct children."""
    out = [s.t1_ns - s.t0_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.t1_ns - s.t0_ns
    return out

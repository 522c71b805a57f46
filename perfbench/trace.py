"""The device trace of a window: ``torch.profiler`` with only the device
traced, reduced to a list of device events and read by the per-layer
metrics.

``busy_s`` is the length of the union of the device events' intervals
(kernels, copies and fills on any stream), so overlapping streams count
once. ``idle_gaps`` names each gap between device events by the kernel
the device ran next: the host was preparing that launch.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Sequence, Tuple

Event = Tuple[str, float, float]          # (name, start us, end us)
_COPY = re.compile(r"^(Memcpy|Memset)")


def short_name(name: str) -> str:
    """``void ns::(anonymous namespace)::k<T, 2>(args)`` -> ``k``; a
    library kernel keeps its first 60 characters."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = n.split("<")[0].split("(")[0]
    return n.split("::")[-1][:60] or name[:60]


class Trace:
    def __init__(self, events: Sequence[Event], window_s: float):
        self.events = sorted(events, key=lambda e: e[1])
        self.window_s = window_s

    def _union_us(self, events) -> float:
        total, end = 0.0, None
        for _, s, e in events:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    @property
    def busy_s(self) -> float:
        return self._union_us(self.events) / 1e6

    @property
    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.events if not _COPY.match(n))

    def device_s(self, patterns: Sequence[str]) -> float:
        """Summed time of the kernels whose name matches any pattern."""
        rx = re.compile("|".join(patterns))
        return sum(e - s for n, s, e in self.events if rx.search(n)) / 1e6

    def by_kernel(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.events:
            k = short_name(n)
            out[k] = out.get(k, 0.0) + (e - s) / 1e6
        return out

    def idle_gaps(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        end = None
        for n, s, e in self.events:
            if end is not None and s > end:
                k = "before " + short_name(n)
                out[k] = out.get(k, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        return out

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": head(self.by_kernel()),
                "idle_gaps": head(self.idle_gaps())}


def traced(fn: Callable[[], object], sync: Callable[[], None]
           ) -> Tuple[object, Trace]:
    """``fn()`` under the profiler (device activity only): (its result,
    the trace, whose ``window_s`` is the window's host seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    events: List[Event] = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            events.append((ev.name, float(ev.time_range.start),
                           float(ev.time_range.end)))
    return out, Trace(events, window_s)

"""Host spans at the port's layer boundaries, recorded in memory.

``with span("zo.update"):`` marks a stretch of host time. Off (the
default) a span costs one flag check and returns the shared :data:`NOOP`;
between :func:`enable` and :func:`disable` each span appends one
:class:`Span` row, ``(name, parent, t0_ns, t1_ns)``, its times
from ``time.perf_counter_ns()`` and its parent the index of the span open
around it (-1 at the top). :func:`take` hands the rows over with the
anchor that places them on Unix nanoseconds, the time base of a
``torch.profiler`` trace (its ``trace_start_ns`` plus an event's offset).

A span reads no tensor, records no device event and waits for nothing:
turning the recorder on changes neither the arithmetic nor the host
syncs of what runs inside. Names ending in ``.sync`` mark the places
where the host waits for the device. The module imports only the
standard library, so every layer of the port may import it.

:data:`COUNTS` holds the program's counters of work, host numbers the
program knows without reading the device (``count``, ``count_max``),
kept whether or not the recorder is on and zeroed with the kernels'
launch counts (``kernels.build.reset_launches``). The MoE layer's:
``moe.calls``, ``moe.assignments`` (tokens x k routed), ``moe.rows``
(expert rows computed, E x C), ``moe.max_load`` (the largest expert load
read to the host, by dropless routing) and ``moe.materialized_bytes``
(the experts' perturbed copies).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

_perf_ns = time.perf_counter_ns

COUNTS = {"moe.calls": 0, "moe.assignments": 0, "moe.rows": 0,
          "moe.max_load": 0, "moe.materialized_bytes": 0}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    COUNTS[name] += n


def count_max(name: str, value: int) -> None:
    """Raise counter ``name`` to ``value`` if it is below."""
    COUNTS[name] = max(COUNTS[name], value)


class Span(NamedTuple):
    name: str
    parent: int              # index of the enclosing span, -1 at the top
    t0_ns: int               # time.perf_counter_ns() at entry
    t1_ns: int               # ... at exit


class _Noop:
    """What :func:`span` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_on = False
_rows: List = []             # [name, parent, t0, t1], a tuple closed
_open: List[int] = []        # indices of the spans open, innermost last
_anchor: Tuple[int, int] = (0, 0)


class _Open:
    __slots__ = ("row", "i")

    def __init__(self, name: str):
        self.row = [name, -1, 0, 0]

    def __enter__(self):
        if _open:
            self.row[1] = _open[-1]
        self.i = len(_rows)
        _open.append(self.i)
        _rows.append(self.row)
        self.row[2] = _perf_ns()
        return self

    def __exit__(self, *exc):
        self.row[3] = _perf_ns()
        if _open and _open[-1] == self.i:   # enable() drops open spans
            _open.pop()
            _rows[self.i] = tuple(self.row)  # a closed row leaves the GC
        return False


def span(name: str):
    """A context manager over one stretch of host time (see the module
    docstring)."""
    if not _on:
        return NOOP
    return _Open(name)


def enable() -> None:
    """Start recording (dropping whatever was recorded before) and fix
    the anchor ``(time.time_ns(), time.perf_counter_ns())``."""
    global _on, _anchor
    _rows.clear()
    _open.clear()
    _anchor = (time.time_ns(), _perf_ns())
    _on = True


def disable() -> None:
    """Stop recording; what was recorded waits for :func:`take`."""
    global _on
    _on = False


def take() -> Tuple[Tuple[int, int], List[Span]]:
    """``(anchor, spans)``: the anchor ``(unix_ns, perf_counter_ns)``
    taken together by :func:`enable`, and the spans recorded since, in
    the order they opened (a span still open has ``t1_ns`` 0). Clears
    the record: take it once the spans have closed."""
    out = [Span(*row) for row in _rows]
    _rows.clear()
    return _anchor, out

"""Spans and counters inside murb_tpu_torch: where a step, a health check
or an engine build spends its time.

    from murb_tpu_torch.utils import trace

    with trace.span("adaptive.sort"):
        ...
    with trace.span("build.plan") as sp:
        ...
        sp.set(levels=L)
    trace.count("name")

The tracer is off by default.  Then ``span`` returns one shared null
context (``NULL``): no clock is read and nothing is allocated, so a span
costs the program one module-level check.  ``enable()`` turns it on, for
the process: each span keeps a record in memory,

    {"id", "name", "parent" (the enclosing span's id, or None),
     "start_ns", "end_ns" (``time.perf_counter_ns()``), "attrs"}

and, while a ``torch.profiler`` profile is recording, also opens
``torch.profiler.record_function("murb." + name)``, so that the same span
lies in the device trace on the profiler's clock, around the kernels it
launched.  ``drain()`` hands over the records and counts kept so far and
clears them.  The tracer writes no file of its own: spans reach one
through the profiler's Chrome trace (the CLI's ``--profile``) or through
whoever drains them.  Spans nest by the order they are opened in, so open
them from one thread (the step's).

``profile_rows`` reads the spans back from a finished profile: each
span's calls, host time and the device time of the kernels launched
inside it.
"""
from __future__ import annotations

import bisect
import itertools
import math
import time

import torch

#: the prefix of the spans' ranges in a profiler trace
PREFIX = "murb."

_on = False
_records: list[dict] = []
_counts: dict[str, int] = {}
_open: list[dict] = []
_ids = itertools.count()


class _NullSpan:
    """The span of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _NullSpan()


class _Span:
    """One span of a tracer that is on: its record, and its profiler range
    while a profiler records."""

    __slots__ = ("record", "_range")

    def __init__(self, name: str, attrs: dict):
        self.record = {"id": next(_ids), "name": name, "parent": None,
                       "start_ns": None, "end_ns": None, "attrs": attrs}
        self._range = None

    def __enter__(self):
        rec = self.record
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + rec["name"])
            self._range.__enter__()
        rec["parent"] = _open[-1]["id"] if _open else None
        _records.append(rec)
        _open.append(rec)
        rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.record["end_ns"] = time.perf_counter_ns()
        _open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def set(self, **attrs) -> None:
        """Add attrs to the span's record (also after it has ended)."""
        self.record["attrs"].update(attrs)


def span(name: str, **attrs):
    """A context manager around one stage of the program named ``name``,
    with ``attrs`` in its record; ``NULL`` while the tracer is off."""
    if not _on:
        return NULL
    return _Span(name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` (nothing while the tracer is off)."""
    if _on:
        _counts[name] = _counts.get(name, 0) + k


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; the records kept so far stay until ``drain``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> dict:
    """{"spans": [record, ...] in the order opened, "counts": {name: k}}
    kept since the last drain, which are then cleared.  A span still open
    is in the list with ``end_ns`` None until it ends."""
    global _records, _counts
    out = {"spans": _records, "counts": _counts}
    _records, _counts = [], {}
    return out


def profile_rows(prof) -> list[tuple[str, int, float, float]]:
    """(span name, calls, host ms, device ms) of each span in the finished
    ``torch.profiler`` profile ``prof``, longest host time first.  Host ms
    is the spans' summed duration.  Device ms is the union of the device's
    kernels, copies and memsets whose launch (the runtime call with the
    activity's correlation id) lies inside one of the name's spans, so a
    kernel that ran after its span ended counts, and work on overlapping
    streams counts once; 0 without device activity.  (The profiler's own
    ``key_averages`` leaves out the kernels launched from the library's C
    entries, which no PyTorch operator encloses.)"""
    from torch.autograd import DeviceType

    spans, launches, device = {}, {}, []
    for e in prof.events():
        t = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(PREFIX):
                spans.setdefault(e.name[len(PREFIX):], []).append(
                    (t.start, t.end))
            elif e.name.startswith("cu"):      # cuda* and cu* API calls
                launches.setdefault(e.id, t.start)
        elif not getattr(e, "is_user_annotation", False):
            device.append((e.id, t.start, t.end))
    rows = []
    for name, iv in spans.items():
        iv.sort()
        starts = [s for s, _ in iv]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= iv[i][1]

        busy = sorted((s, e) for cid, s, e in device
                      if cid in launches and launches[cid] <= s
                      and inside(launches[cid]))
        dev_us, end = 0.0, -math.inf
        for s, e in busy:                       # the union's length
            dev_us += max(0.0, e - max(s, end))
            end = max(end, e)
        rows.append((name, len(iv), sum(e - s for s, e in iv) / 1e3,
                     dev_us / 1e3))
    return sorted(rows, key=lambda r: -r[2])

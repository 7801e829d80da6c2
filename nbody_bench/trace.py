"""The device trace of a run's profiled frames, reduced to intervals.

``normalize`` turns a ``torch.profiler`` session into plain lists: the
device's kernels, copies and memsets, the host's operators, and the
benchmark's own spans (``record_function`` ranges named ``nbody_bench.*``),
all in the profiler's microseconds.  ``TraceView`` answers what the metric
readers ask of them.  Busy time is the union of device intervals, never
their sum, so streams that overlap count once.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

#: prefix of the benchmark's own host spans
SPAN = "nbody_bench."


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def normalize(prof, frames: int) -> dict:
    """{"frames", "device": [[name, start, end, kind]], "host": [[name,
    start, end]], "spans": [[name, start, end]]} of a finished profile."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.events():
        name, t = e.name, e.time_range
        if name.startswith(SPAN):
            if e.device_type == DeviceType.CPU:
                spans.append([name[len(SPAN):], t.start, t.end])
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            device.append([name, t.start, t.end, _kind(name)])
        elif e.device_type == DeviceType.CPU:
            host.append([name, t.start, t.end])
    return {"frames": frames, "device": device, "host": host, "spans": spans}


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) pairs covering ``intervals``."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void\s+", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):     # drop the argument list, keep <...>
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


class TraceView:
    """The profiled frames of one run: ``frames`` frames between the first
    frame span's start and the last one's end (``t0``, ``t1``)."""

    def __init__(self, d: dict):
        self.data = d
        self.frames = int(d["frames"])
        frame_spans = [(s, e) for name, s, e in d["spans"] if name == "frame"]
        self.spans = [tuple(x) for x in d["spans"]]
        if frame_spans:
            self.t0 = min(s for s, _ in frame_spans)
            self.t1 = max(e for _, e in frame_spans)
        else:
            self.t0 = min(x[1] for x in d["device"])
            self.t1 = max(x[2] for x in d["device"])
        self.device = [tuple(x) for x in d["device"]
                       if x[2] > self.t0 and x[1] < self.t1]
        self.host = sorted((tuple(x) for x in d["host"]),
                           key=lambda x: x[1])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy(self, kinds=("kernel", "copy", "memset")) -> list:
        """The union of the device intervals of ``kinds``, clipped to the
        window."""
        return union((max(s, self.t0), min(e, self.t1))
                     for _, s, e, k in self.device if k in kinds)

    def busy_us(self, kinds=("kernel", "copy", "memset")) -> float:
        return sum(e - s for s, e in self.busy(kinds))

    def kernel_us(self, pattern: str) -> float:
        """Summed durations of the kernels whose name matches ``pattern``
        (a regular expression searched in the name)."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e, k in self.device
                   if k == "kernel" and rx.search(name))

    def launches(self) -> int:
        return sum(1 for x in self.device if x[3] == "kernel")

    def _innermost(self, items, t: float, starts) -> str | None:
        """The latest-starting item of ``items`` (sorted by start) that
        contains ``t``: with nested ranges, the innermost."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if items[j][2] >= t:
                return items[j][0]
        return None

    def idle_gaps(self) -> list[tuple[str, float]]:
        """(what the host was doing, idle us) of every stretch of the
        window in which the device ran nothing, named by the benchmark span
        and the innermost host operator at its middle."""
        spans = sorted(self.spans, key=lambda x: x[1])
        span_starts = [x[1] for x in spans]
        host_starts = [x[1] for x in self.host]
        gaps, t = [], self.t0
        for s, e in self.busy() + [(self.t1, self.t1)]:
            if s > t:
                mid = 0.5 * (s + t)
                where = self._innermost(spans, mid, span_starts) or "-"
                op = self._innermost(self.host, mid, host_starts) or "-"
                gaps.append((f"{where}: {op}", s - t))
            t = max(t, e)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time and the longest
        idle time by what the host was doing, in seconds a frame."""
        ops, idle = defaultdict(float), defaultdict(float)
        for name, s, e, _ in self.device:
            ops[_short(name)] += e - s
        for name, us in self.idle_gaps():
            idle[name] += us
        per = 1e-6 / max(self.frames, 1)
        rank = lambda d: [[k, v * per] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}

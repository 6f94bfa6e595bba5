"""What the traced run reads from ``torch.profiler``: the device's
operations (kernels, copies, sets) with their times, the host's outermost
operations, and the reduction of them to busy time, idle gaps and the
costliest operations.

Busy time is the union of the kernel intervals, never their sum, so kernels
that overlap on several streams count once. An idle gap is split among the
launching thread's outermost host operations that overlap it (a ``torch``
operator or a CUDA runtime call); the part that no operation covers is host
Python.
"""

from __future__ import annotations

import bisect
import collections
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

__all__ = ["Trace", "read_profile", "union_seconds", "WINDOW_MARK"]

WINDOW_MARK = "benchmark.traced_window"
_COPY = re.compile(r"^(Memcpy|Memset)")
_SYNC = re.compile(r"\bSync")

Interval = Tuple[int, int]


def _short(name: str) -> str:
    """A kernel or operator name without its trailing argument list, cut
    to 120 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:120]


@dataclass
class Trace:
    """Intervals in the profiler's nanoseconds. ``kernels`` / ``copies``:
    (name, start, end) on the card; ``host``: the launching thread's
    outermost operations, in order and disjoint; ``window``: the traced
    window's (start, end)."""

    kernels: List[Tuple[str, int, int]] = field(default_factory=list)
    copies: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    window: Interval = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.kernels],
                             self.window)

    def kernel_seconds(self, pattern: "re.Pattern") -> float:
        """Summed device time of the kernels whose name matches."""
        return sum(e - s for n, s, e in self.kernels
                   if pattern.search(n)) * 1e-9

    def device_ops(self, top: int = 10) -> List[list]:
        """The ``top`` device operations by summed time, kernels and copies,
        named without their argument lists."""
        by = collections.Counter()
        for name, s, e in self.kernels + self.copies:
            by[_short(name)] += (e - s) * 1e-9
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds of the window by what the host was doing: each gap
        split among the host's outermost operations that overlap it, the
        rest of it "host Python"; the ``top`` largest sums."""
        starts = [s for _, s, _ in self.host]
        by = collections.Counter()
        for g0, g1 in _gaps([(s, e) for _, s, e in self.kernels], self.window):
            i = max(bisect.bisect_right(starts, g0) - 1, 0)
            covered = 0
            while i < len(self.host) and self.host[i][1] < g1:
                name, s, e = self.host[i]
                overlap = min(e, g1) - max(s, g0)
                if overlap > 0:
                    by[_short(name)] += overlap * 1e-9
                    covered += overlap
                i += 1
            if g1 - g0 > covered:
                by["host Python"] += (g1 - g0 - covered) * 1e-9
        return [[n, t] for n, t in by.most_common(top)]


def _merged(intervals: List[Interval], window: Interval) -> List[Interval]:
    w0, w1 = window
    out: List[list] = []
    for s, e in sorted(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals: List[Interval], window: Interval) -> float:
    """Seconds of ``window`` covered by at least one interval."""
    return sum(e - s for s, e in _merged(intervals, window)) * 1e-9


def _gaps(intervals: List[Interval], window: Interval) -> List[Interval]:
    out, at = [], window[0]
    for s, e in _merged(intervals, window):
        if s > at:
            out.append((at, s))
        at = e
    if window[1] > at:
        out.append((at, window[1]))
    return out


def read_profile(prof) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` whose
    window was marked with ``record_function(WINDOW_MARK)``. Device events
    are kernels unless named as a copy or set; the mark's own device-side
    copy is dropped."""
    trace = Trace()
    host: Dict[int, list] = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name == WINDOW_MARK or _SYNC.search(name):
                continue
            (trace.copies if _COPY.match(name) else trace.kernels).append(
                (name, s, e))
        elif name == WINDOW_MARK:
            trace.window = (s, e)
        else:
            host[ev.start_thread_id()].append((name, s, e))
    if host:
        tid = max(host, key=lambda t: len(host[t]))
        for name, s, e in sorted(host[tid], key=lambda r: (r[1], -r[2])):
            if not trace.host or s >= trace.host[-1][2]:
                trace.host.append((name, s, e))
    return trace

"""``idle_ms.<stage>``: the traced window's idle time (no kernel on the card:
the window less the union of the kernel intervals, as ``device_idle``)
inside the program's ``stage.<stage>`` spans (``core/pipeline.py:_span``,
the host thread's outermost operations in the trace), in milliseconds a
traced frame. ``idle_ms.between``: the idle time that no ``stage.*`` span
covers. Summed over every stage in the trace and ``between``, it is the
window's idle time."""

import collections

from benchmark.trace import _gaps

PREFIX = "stage."


def idle_ns(trace):
    """(idle nanoseconds of the window by stage and ``between``, the set of
    stages in the trace); both empty without a ``stage.*`` span."""
    spans = [(n[len(PREFIX):], s, e) for n, s, e in trace.host
             if n.startswith(PREFIX)]
    by = collections.Counter()
    if not spans:
        return by, set()
    i = 0
    for g0, g1 in _gaps([(s, e) for _, s, e in trace.kernels], trace.window):
        # gaps and spans are both in order and disjoint
        while i < len(spans) and spans[i][2] <= g0:
            i += 1
        covered, j = 0, i
        while j < len(spans) and spans[j][1] < g1:
            stage, s, e = spans[j]
            overlap = min(e, g1) - max(s, g0)
            if overlap > 0:
                by[stage] += overlap
                covered += overlap
            j += 1
        by["between"] += g1 - g0 - covered
    return by, {stage for stage, _, _ in spans}


def read(ctx, name):
    stage = name.split(".", 1)[1]
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_frames:
        return None
    by, stages = idle_ns(ctx.trace)
    if not stages or (stage != "between" and stage not in stages):
        return None
    return by[stage] * 1e-6 / ctx.traced_frames

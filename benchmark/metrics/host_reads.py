"""``host_reads.<stage>``: device-to-host copies (``Memcpy DtoH`` in the
trace: a flag, a count or a table the host reads back) that start inside the
program's ``stage.<stage>`` spans (``core/pipeline.py:_span``), a traced
frame. Copies, not synchronisations: one wait may cover several copies."""

import bisect

DTOH = "Memcpy DtoH"


def read(ctx, name):
    stage = name.split(".", 1)[1]
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_frames:
        return None
    spans = [(s, e) for n, s, e in ctx.trace.host if n == f"stage.{stage}"]
    if not spans:
        return None
    starts = [s for s, _ in spans]
    reads = 0
    for copy, s, _ in ctx.trace.copies:
        i = bisect.bisect_right(starts, s) - 1
        if copy.startswith(DTOH) and i >= 0 and s < spans[i][1]:
            reads += 1
    return reads / ctx.traced_frames

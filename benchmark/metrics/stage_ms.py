"""``stage_ms.<stage>``: the program's own stage span (``core/pipeline.py``
``timings=``: host clock, the device synchronised on entry and exit) summed
over the traced run's window, in milliseconds a frame of the window."""


def read(ctx, name):
    stage = name.split(".", 1)[1]
    if not ctx.timings or stage not in ctx.timings or not ctx.frames:
        return None
    return 1000.0 * ctx.timings[stage] / ctx.frames

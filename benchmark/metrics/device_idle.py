"""Share of the traced window (the first two calls) in which no kernel runs
on the card: one minus the union of the kernel intervals over the window."""


def read(ctx, name):
    if ctx.trace is None or not ctx.trace.kernels or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)

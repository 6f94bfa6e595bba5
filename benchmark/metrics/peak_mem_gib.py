"""``torch.cuda.max_memory_allocated()`` over the window (reset before it),
in GiB: whether a movie fits decides whether it runs at all, and on which
card."""


def read(ctx, name):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None

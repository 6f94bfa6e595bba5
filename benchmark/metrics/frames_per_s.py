"""Frames of every movie the window ran, over the window's host-clock
seconds (the last movie included): what a user processing movies waits on."""


def read(ctx, name):
    return ctx.frames / ctx.window_s if ctx.frames else None

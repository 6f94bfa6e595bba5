"""Seconds from the start of the process to the end of the warm-up calls:
imports, the card's start, making the movies and weights, building or
loading the kernels, and one call on each movie."""


def read(ctx, name):
    return ctx.setup_s

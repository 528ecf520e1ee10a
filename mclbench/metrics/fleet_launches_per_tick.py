"""Kernel launches a tick: the kernels the device started within the traced
window, over its ticks (a count that repeats exactly)."""


def read(ctx):
    if ctx.trace.window is None:
        return None
    w0, w1 = ctx.trace.window
    n = sum(1 for _, ts, _, _ in ctx.trace.kernels if w0 <= ts <= w1)
    return n / ctx.trace.ticks if n else None

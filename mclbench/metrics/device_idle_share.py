"""The device's idle share of the traced window, in percent: one minus the
union of its busy intervals over the window, both over the same ticks."""


def read(ctx):
    w = ctx.trace.window_us()
    return 100.0 * (1.0 - ctx.trace.busy_us() / w) if w > 0 else None

"""Device time a tick: the union of the device's busy intervals over the
traced window, over its ticks.  It repeats within a fraction of a percent
between runs where the host-paced end-to-end metrics spread by several,
so a change to the device's work shows here first."""


def read(ctx):
    return ctx.trace.busy_us() * 1e-3 / ctx.trace.ticks if ctx.trace.ticks else None

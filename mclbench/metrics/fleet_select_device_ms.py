"""Device milliseconds a tick of the selects that keep gated-out and
unresampled filters (what a fleet that computes every filter pays for
those it keeps): the kernels launched from the program's ``amcl.select``
ranges, nested ranges included, over the traced ticks.  0 where no
filter was kept; nothing where the program marks no ``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    return tr.kernel_us_under("amcl.select") * 1e-3 / tr.ticks

"""Device milliseconds a tick of the resample (kernel B2's take of the
donors, the recovery draw and injection, the KLD count): the kernels
launched from the program's ``amcl.resample`` ranges, nested ranges
included, over the traced ticks.  0 where the update ran without the
stage; nothing where the program marks no ``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    return tr.kernel_us_under("amcl.resample") * 1e-3 / tr.ticks

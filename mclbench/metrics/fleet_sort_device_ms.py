"""Device milliseconds a tick of the theta sort of the slots: the kernels
launched from the program's ``amcl.sort`` ranges, nested ranges included,
over the traced ticks.  0 where the update ran without the stage; nothing
where the program marks no ``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    return tr.kernel_us_under("amcl.sort") * 1e-3 / tr.ticks

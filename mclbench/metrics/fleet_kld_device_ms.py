"""Device milliseconds a tick of the KLD stage (the candidates' spatial
hashes, the count of distinct buckets, the chi-squared target and the
take-while): the kernels launched from the program's ``amcl.kld`` ranges,
nested ranges included, over the traced ticks.  0 where the update ran
without the stage (a fixed count); nothing where the program marks no
``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    return tr.kernel_us_under("amcl.kld") * 1e-3 / tr.ticks

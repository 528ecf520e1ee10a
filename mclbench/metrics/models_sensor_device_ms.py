"""Device time of the sensor model a tick: the kernels launched from the
``models.log_weight`` span, over the traced ticks."""


def read(ctx):
    us = ctx.trace.kernel_us_under("models.log_weight")
    return us * 1e-3 / ctx.trace.ticks if us > 0 and ctx.trace.ticks else None

"""The whole tick's share of the card's float32 peak, in percent: the
operations counted for the tick (the sensor's, by its own module's count,
and ``roofline.UPDATE_OPS_PER_PARTICLE`` for the rest of the update) over
the traced window's seconds a tick times 67 TFLOP/s."""

from mclbench import roofline


def read(ctx):
    w = ctx.trace.window_us()
    if w <= 0 or not ctx.trace.ticks or not ctx.sensor_work:
        return None
    ops = sum(o for o, _ in ctx.sensor_work) / len(ctx.sensor_work) \
        + roofline.UPDATE_OPS_PER_PARTICLE * ctx.particles * ctx.robots
    return 100.0 * ops / (w * 1e-6 / ctx.trace.ticks * roofline.PEAK_F32_PER_S)

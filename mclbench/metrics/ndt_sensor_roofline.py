"""The NDT weights' share of their roofline: the least time their work
needs on the card (``sensors/ndt.py``'s counts at each traced tick's
robots, particles, live measurement cells and stencil probes that find a
map cell) over the device time of the ``models.log_weight`` span, in
percent."""

from mclbench import roofline


def read(ctx):
    if ctx.config.get("sensor") != "ndt":
        return None
    return roofline.sensor_share(ctx)

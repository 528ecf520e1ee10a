"""The likelihood-field weights' share of their roofline: the least time
their work needs on the card (``sensors/likelihood_field.py``'s counts at
each traced tick's robots, particles and unmasked beams) over the device
time of the ``models.log_weight`` span, in percent.  It counts the work,
not a kernel, so a kernel that replaces B4 is measured the same way."""

from mclbench import roofline


def read(ctx):
    if ctx.config.get("sensor") != "likelihood_field":
        return None
    return roofline.sensor_share(ctx)

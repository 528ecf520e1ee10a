"""The card's peaks, from which the rooflines and the step's share of the
peak are read, and the reduction of a traced window's counted work to them.

Peaks: NVIDIA's data sheet for the H100 SXM, at its full power limit of
700 W: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3.
Each sensor model counts its own operations and bytes
(``mclbench/sensors/<sensor>.py``), the least that its work needs, each
input byte read once and each output byte written once, with ``exp`` and
``log`` counted as 10 operations.

Beside them, the rest of the update at 71 operations a particle: the
motion sample (3 scale-adds, two ``cos`` and two ``sin``, 4 for the
translation: 50), the normalization (an ``exp``, a subtraction, a max and
a sum: 13) and the estimate (4 products and 4 sums).
"""

from __future__ import annotations

PEAK_F32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
UPDATE_OPS_PER_PARTICLE = 71


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the two bounds."""
    return max(ops / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S)


def sensor_share(ctx):
    """The sensor's weights' share of their roofline, in percent: the least
    time of the traced ticks' counted work over the device time of the
    kernels launched from the ``models.log_weight`` span; ``None`` where
    the window has none."""
    us = ctx.trace.kernel_us_under("models.log_weight")
    if us <= 0 or not ctx.trace.ticks or not ctx.sensor_work:
        return None
    need = sum(least_seconds(ops, nbytes) for ops, nbytes in ctx.sensor_work)
    return 100.0 * need / (us * 1e-6 * len(ctx.sensor_work) / ctx.trace.ticks)

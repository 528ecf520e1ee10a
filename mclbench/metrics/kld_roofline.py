"""The KLD stage's share of its roofline, in percent: the least time its
work needs on the card over the device time a tick of the kernels
launched from the program's ``amcl.kld`` ranges.  The least work is what
any count must do: read each kept candidate once (x, y, cos and sin in
float32, 16 bytes; the kept candidates of a tick are the fleet's live
particles after it, the program's counter ``kld.live``) and write each
filter's count (4 bytes).  It counts the work, not a kernel, so a kernel
that replaces the stage is measured the same way.  Nothing where the
trace holds no ``kld.live`` value or the stage launched nothing."""

from mclbench import counters, roofline

BYTES_PER_KEPT, BYTES_PER_FILTER = 16, 4


def counts(live: int, robots: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one tick's count: ``live`` candidates
    kept over ``robots`` filters."""
    return 0.0, float(BYTES_PER_KEPT * live + BYTES_PER_FILTER * robots)


def read(ctx):
    tr = ctx.trace
    live = counters.values(tr, "kld.live")
    us = tr.kernel_us_under("amcl.kld")
    if not tr.ticks or not live or us <= 0:
        return None
    need = sum(roofline.least_seconds(*counts(v, ctx.robots)) for v in live) / len(live)
    return 100.0 * need / (us * 1e-6 / tr.ticks)

"""Host time of the fleet update call, from the call to its return and
before the estimate's readback, mean over the traced ticks: the span
``fleet.update``."""


def read(ctx):
    spans = [e - s for name, s, e, _ in ctx.trace.ranges if name == "fleet.update"]
    return sum(spans) / len(spans) * 1e-3 if spans else None

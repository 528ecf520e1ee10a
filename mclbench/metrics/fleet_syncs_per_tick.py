"""Host-device syncs a tick: the program's ``sync.*`` ranges (one around
each call of the update that makes the host wait for the card) in the
traced window, over its ticks.  0 where the update ran with no sync;
nothing where the program marks no ``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    return sum(name.startswith("sync.") for name, *_ in tr.ranges) / tr.ticks

"""Host milliseconds a tick inside the program's ``amcl.recovery`` range:
the recovery draw (the model's ``random_state``, kernel B3's pooled draw)
and its injection, its syncs included, over the traced ticks.  0 where
the update ran and no filter resampled; nothing where the program marks
no ``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    return sum(e - s for name, s, e, _ in tr.ranges if name == "amcl.recovery") \
        * 1e-3 / tr.ticks

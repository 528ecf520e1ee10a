"""Host milliseconds a tick inside the program's ``sync.*`` ranges: the
time the update's host thread spends in calls that wait for the card
(the queue draining), over the traced ticks.  0 where the update ran with
no sync; nothing where the program marks no ``amcl.update``."""


def read(ctx):
    tr = ctx.trace
    if not tr.ticks or not any(name == "amcl.update" for name, *_ in tr.ranges):
        return None
    us = sum(e - s for name, s, e, _ in tr.ranges if name.startswith("sync."))
    return us * 1e-3 / tr.ticks

"""The program's counters in a traced window: ``utils/profiling.py:count``
marks each value as a zero-length host range named
``count.<name>=<value>``, which ``trace.Trace`` loads with the spans."""

from __future__ import annotations


def values(trace, name: str) -> list:
    """The values of the counter ``name`` in the window, in the order of
    their ranges; empty where the program marks none."""
    prefix = f"count.{name}="
    marks = sorted((s, r[len(prefix):]) for r, s, _, _ in trace.ranges if r.startswith(prefix))
    return [int(v) for _, v in marks]

"""The reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: device operations, host ranges (the benchmark's spans), the
launches that tie a kernel to the host range it was launched from, the
union of the device's busy intervals over the traced window, and the
breakdown of the result line.

Spans, all placed by the benchmark's own files: ``tick`` (one tick, from
its input copy to its estimate on the host), inside it ``tick.copy_in``,
``fleet.update`` (the call of the fleet update, to its return) and
``tick.readback``; inside the update the model table's ``models.<name>``.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver", "runtime", "driver"}


def _merge(intervals):
    """Sorted, disjoint unions of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """One traced window, from the events of a Chrome trace (times in µs)."""

    def __init__(self, events: list):
        self.device_ops, self.kernels, self.ranges, self.gpu_ranges = [], [], [], []
        launches = {}
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                op = (ev.get("name", "?"), ts, dur, args.get("correlation"))
                self.device_ops.append(op)
                if cat == "kernel":
                    self.kernels.append(op)
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, ev.get("tid"))
            elif cat == "user_annotation":
                self.ranges.append((ev.get("name", "?"), ts, ts + dur, ev.get("tid")))
            elif cat == "gpu_user_annotation":
                self.gpu_ranges.append((ev.get("name", "?"), ts, ts + dur))
        self.launches = launches
        ticks = [r for r in self.ranges if r[0] == "tick"]
        self.ticks = len(ticks)
        self.window = (min(r[1] for r in ticks), max(r[2] for r in ticks)) if ticks else None

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def busy(self) -> list:
        """The union of the device's operations within the window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        spans = [(max(ts, w0), min(ts + dur, w1)) for _, ts, dur, _ in self.device_ops]
        return _merge([(s, e) for s, e in spans if e > s])

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def window_us(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def _range_at(self, ts: float, tid=None):
        """The innermost host range open at ``ts`` (on thread ``tid``)."""
        best = None
        for name, s, e, t in self.ranges:
            if s <= ts <= e and (tid is None or t == tid):
                if best is None or s >= best[1]:
                    best = (name, s)
        return None if best is None else best[0]

    def kernel_us_under(self, range_name: str) -> float:
        """Device time of the kernels launched from within host ranges of
        ``range_name`` (the launch found by its correlation id); where no
        kernel's launch is in the trace, of the kernels that start within
        the device-side copies of those ranges."""
        spans = [(s, e, t) for name, s, e, t in self.ranges if name == range_name]
        total, matched = 0.0, False
        for _, start, dur, corr in self.kernels:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            matched = True
            ts, tid = launch
            if any(s <= ts <= e and t == tid for s, e, t in spans):
                total += dur
        if matched:
            return total
        gpu = [(s, e) for name, s, e in self.gpu_ranges if name == range_name]
        return sum(dur for _, start, dur, _ in self.kernels
                   if any(s <= start <= e for s, e in gpu))

    def host_ms_by_span(self) -> dict:
        """Mean host milliseconds a tick in each span, by name."""
        out = defaultdict(float)
        for name, s, e, _ in self.ranges:
            out[name] += (e - s) * 1e-3 / max(self.ticks, 1)
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps of the device in the window with the host range open at
        each gap's middle; seconds."""
        by_name = defaultdict(float)
        for name, _, dur, _ in self.device_ops:
            by_name[name[:160]] += dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        if self.window is not None:
            w0, w1 = self.window
            edges = [w0] + [x for s, e in self.busy() for x in (s, e)] + [w1]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps.append((self._range_at((a + b) / 2) or "no span", b - a))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, v * 1e-6] for n, v in ops],
                "idle_gaps": [[n, v * 1e-6] for n, v in gaps[:top]]}

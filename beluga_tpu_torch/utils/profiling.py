"""Timing and profiling (port of ``beluga_tpu/utils/profiling.py``; the
beluga_benchmark analog).

  * :class:`LatencyRecorder`: per-update wall-clock statistics (p50, p90,
    p99), the node log's equivalent;
  * :func:`time_compiled`: steady-state time of a call, on CUDA events on
    the card;
  * :func:`trace`: a ``torch.profiler`` trace written as a Chrome trace;
  * :func:`span`: a named range of the program in such a trace (the
    update's stages and its blocking host-device syncs), free while no
    profiler records;
  * :func:`count`: a host value of the program (a counter) marked in such a
    trace, free while no profiler records;
  * :func:`card_label`: the card's name and power limit, to stand beside a
    number measured on it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class LatencyRecorder:
    samples_s: list = field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.samples_s.append(seconds)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self.samples_s:
            return {"count": 0}
        arr = np.asarray(self.samples_s) * 1e3
        return {
            "count": len(arr),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "p99_ms": float(np.percentile(arr, 99)),
            "max_ms": float(arr.max()),
        }


def time_compiled(fn, *args, iters: int = 20, warmup: int = 3, device=None) -> float:
    """Steady-state seconds a call of ``fn(*args)``, after ``warmup`` calls.

    On a CUDA ``device`` (the default ``"cuda"``) the time is taken by CUDA
    events around ``iters`` calls issued back to back, so it is the
    device's time for the calls (the host's cost included where it is the
    larger); on ``"cpu"`` by the host clock."""
    device = torch.device("cuda" if device is None else device)
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where
    it is available) and write ``log_dir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks the block as the range ``name`` while a
    ``torch.profiler`` profile records: a ``record_function``, on the
    profiler's clock beside the device's kernels and copies, which are tied
    to it by their launches.  Otherwise one shared null context: a flag
    check, with no ``record_function`` built (one costs microseconds even
    with the profiler off).

    Names: ``amcl.<stage>`` for the stages of the filter update,
    ``winlut.<stage>`` for those of the fused windowed model, and
    ``sync.<site>`` around each call in it that makes the host wait for the
    card (a blocking host-to-device copy, a readback, a library call that
    reads back), so that the count of ``sync.*`` ranges is the count of
    syncs; ``sync.winlut_delta`` and ``sync.fused_scalars`` each hold the
    two small copies of one site."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, value) -> None:
    """Mark the host integer ``value`` of the counter ``name`` in a
    ``torch.profiler`` trace, while one records: a zero-length range named
    ``count.<name>=<value>``, beside the spans on the profiler's clock.
    Otherwise nothing, as :func:`span`.  The caller holds ``value`` on the
    host: reading it back from the card is the caller's sync, not this
    function's.  ``count("kld.live", n)``: the live particles of a fleet
    after its update (``mclbench/drivers/kld_fleet.py``)."""
    if torch.autograd.profiler._is_profiler_enabled:
        with torch.profiler.record_function(f"count.{name}={int(value)}"):
            pass


def card_label(device) -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them (a card set below its
    maximum runs slower under load); ``"cpu"`` for a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

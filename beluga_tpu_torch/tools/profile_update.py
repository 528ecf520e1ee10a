"""Where an update's time goes on the card: the port's main-path
workloads under ``torch.profiler``.

    python -m beluga_tpu_torch.tools.profile_update [--scans 20] [--trace-dir DIR]
        [--workloads node,large,fleet,mega,windowed,beam_node,long_range,beam_fleet]

Workloads, the configurations of ``tools/workloads.py`` (which
``chip_smoke.py`` drives too):

* ``node``: ``AmclNode`` at nav2 defaults (2000 particles, KLD down to
  500, multinomial resampling, cluster estimate), one ``handle_scan`` per
  scan;
* ``large``: one 262144-particle filter (systematic resampling, KLD down
  to 65536, plain estimate, pooled recovery) through
  ``filters.amcl.update``;
* ``fleet``: the JAX benchmark's fleet, 64 filters x 4096 particles
  (codebook16, theta-sorted slots, fixed count, multinomial resampling,
  pooled recovery) through ``parallel.fleet.make_fleet_update``;
* ``mega``: the JAX benchmark's headline filter, 2097152 particles through
  the fused windowed kernel B5 (gate-free, systematic and selective
  resampling, a 4096-state recovery pool, the θ sort every 8th update);
* ``windowed``: the coverage-gated windowed filter, 262144 particles, kernel
  B6 with kernel B1 for the exact tail and the fallback;
* ``beam_node``: ``AmclNode`` with the beam model at nav2 defaults (100 m)
  through the sphere trace, kernel B8;
* ``long_range``: the long-range sphere-trace filter, 2048 particles x 60
  beams on the 1024² map at 60 m (kernel B8), forced updates;
* ``beam_fleet``: 64 filters x 4096 particles x 60 beams through the
  windowed range LUT (kernel B7).

After a warm-up each workload runs ``--scans`` scans on the host clock
(wall ms per update, a synchronize after the last), then ``--scans`` more
under the profiler.  For each it prints one JSON line: the wall ms per
update, device-busy ms per update (the sum of the CUDA kernels' and
copies' device times under the profiler), the device's idle share
(1 - busy / wall), kernel launches per update, and the model stages
(wrapped in profiler ranges here, not in the port), a few PyTorch
operators by name (device time and calls per update) and the kernels that
take the most time.  A run without a CUDA device exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from beluga_tpu_torch.tools import workloads

STAGES = ("propagate", "log_weight", "random_state", "hash_state", "estimate", "sort_key",
          "fused_propagate_reweight")
# PyTorch operators whose device time the profile reports by name, to see
# how they scale with the particle count
OPS = ("aten::cummax", "aten::sort", "aten::cumsum", "aten::matmul", "aten::index_select")


def _ranged(models):
    """The model table with each function inside a profiler range."""
    def wrap(name, fn):
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner

    from beluga_tpu_torch.filters.amcl import se2_sort_key

    models = models._replace(sort_key=models.sort_key or se2_sort_key)
    return models._replace(**{s: wrap(s, getattr(models, s)) for s in STAGES
                              if getattr(models, s) is not None})


def _node(scans: int, **overrides):
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode, make_packed_step_se2

    s = workloads.arena_scans(scans)
    node = AmclNode(workloads.node_config(s, **overrides), seed=0)
    node.set_map(make_grid(s.data, workloads.RES))
    node._models = _ranged(node._models)
    node._step = make_packed_step_se2(node.params, node._models, node.device)

    def step(t):
        r = node.handle_scan((s.xs[t], s.ys[t], s.yaws[t]), s.points[t], s.mask[t])
        if not r.valid:
            raise RuntimeError(f"node scan {t} was gated out")

    return step


def _large(scans: int):
    from beluga_tpu_torch.filters.amcl import host_pose, update

    w = workloads.large_filter(scans, torch.device("cuda"))
    models, s = _ranged(w.models), w.scans
    box = {"state": w.state}

    def step(t):
        box["state"], est = update(w.params, models, w.ctx, box["state"],
                                   host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
        est.pose.xy.cpu()  # the one readback per scan, as the node does

    return step


def _fleet(scans: int, make_workload=workloads.fleet):
    from beluga_tpu_torch.parallel.fleet import make_fleet_update

    w = make_workload(scans, torch.device("cuda"))
    batch = w.points.shape[1]
    fleet_update = make_fleet_update(w.params, _ranged(w.models))
    box = {"state": w.state}

    def step(t):
        odoms = workloads.fleet_odometry(w.scans, t, batch)
        box["state"], est = fleet_update(w.ctx, box["state"], odoms, w.points[t], w.mask[t])
        est.pose.xy.cpu()  # the one readback per scan: every filter's pose

    return step


def _forced(make_workload, sort_every: int | None):
    """A single filter stepped with ``force_update`` on every scan and, with
    ``sort_every``, ``sort_now`` on every ``sort_every``-th."""
    from beluga_tpu_torch.filters.amcl import host_pose, update

    def make(scans: int):
        w = make_workload(scans, torch.device("cuda"))
        models, s = _ranged(w.models), w.scans
        box = {"state": w.state}

        def step(t):
            sort_now = None if sort_every is None else t % sort_every == 0
            box["state"], est = update(w.params, models, w.ctx,
                                       box["state"]._replace(force_update=True),
                                       host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t],
                                       w.mask[t], sort_now=sort_now)
            est.pose.xy.cpu()

        return step

    return make


WORKLOADS = {"node": _node, "large": _large, "fleet": _fleet,
             "mega": _forced(workloads.mega, workloads.MEGA_SORT_EVERY),
             "windowed": _forced(workloads.windowed, None),
             "beam_node": lambda scans: _node(scans, laser_model_type="beam",
                                              beam_fast_path="sphere_trace"),
             "long_range": _forced(workloads.long_range, None),
             "beam_fleet": lambda scans: _fleet(scans, workloads.beam_fleet)}


def profile_workload(name: str, make, scans: int, warmup: int, trace_dir: str | None) -> dict:
    step = make(warmup + 2 * scans)
    for t in range(warmup):
        step(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(warmup, warmup + scans):
        step(t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(warmup + scans, warmup + 2 * scans):
            step(t)
        torch.cuda.synchronize()
    if trace_dir:
        prof.export_chrome_trace(f"{trace_dir}/{name}.json")
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:  # kernel names cut to 90 characters, times summed
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    stages: dict[str, list[float]] = {s: [0.0, 0.0] for s in STAGES}
    ops, calls = dict.fromkeys(OPS, 0.0), dict.fromkeys(OPS, 0)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in stages:
            stages[e.name][0] += e.time_range.elapsed_us()
            stages[e.name][1] += e.device_time_total
        parent = e.cpu_parent
        if (e.device_type == DeviceType.CPU and e.name in ops
                and (parent is None or parent.name != e.name)):  # outermost call only
            ops[e.name] += e.device_time_total
            calls[e.name] += 1
    wall_ms = 1e3 * wall / scans
    busy_ms = 1e-3 * busy_us / scans
    return {
        "workload": name,
        "scans": scans,
        "wall_ms_per_update": wall_ms,
        "device_busy_ms_per_update": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms > 0 else math.nan,
        "kernel_launches_per_update": len(kernels) / scans,
        "stages_ms_per_update": {
            k: {"host": 1e-3 * h / scans, "device": 1e-3 * d / scans}
            for k, (h, d) in stages.items()
        },
        "ops_device_ms_per_update": {k: 1e-3 * v / scans for k, v in ops.items()},
        "ops_calls_per_update": {k: v / scans for k, v in calls.items()},
        "top_device_ms_per_update": {k: 1e-3 * v / scans for k, v in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--trace-dir", default=None, help="write Chrome traces here")
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma-separated subset of " + ",".join(WORKLOADS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_update: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    for name in args.workloads.split(","):
        print(json.dumps(profile_workload(name, WORKLOADS[name], args.scans, args.warmup,
                                          args.trace_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

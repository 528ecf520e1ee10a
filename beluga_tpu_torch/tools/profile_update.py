"""Where an update's time goes on the card: the port's two main-path
workloads under ``torch.profiler``.

    python -m beluga_tpu_torch.tools.profile_update [--scans 20] [--trace-dir DIR]

Workloads, both on the synthetic arena of ``io/synthetic.py`` with 60
beams:

* ``node``: ``AmclNode`` at nav2 defaults (2000 particles, KLD down to
  500, multinomial resampling, cluster estimate), one ``handle_scan`` per
  scan;
* ``large``: one 262144-particle filter (systematic resampling, KLD down
  to 65536, plain estimate) through ``filters.amcl.update``.

After a warm-up each workload runs ``--scans`` scans on the host clock
(wall ms per update, a synchronize after the last), then ``--scans`` more
under the profiler.  For each it prints one JSON line: the wall ms per
update, device-busy ms per update (the sum of the CUDA kernels' and
copies' device times under the profiler), the device's idle share
(1 - busy / wall), kernel launches per update, and the model stages
(wrapped in profiler ranges here, not in the port) and the kernels that
take the most time.  A run without a CUDA device exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

GRID, RES, BEAMS = 384, 0.05, 60
STAGES = ("propagate", "log_weight", "random_state", "hash_state", "estimate")


def _ranged(models):
    """The model table with each function inside a profiler range."""
    def wrap(name, fn):
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner

    return models._replace(**{s: wrap(s, getattr(models, s)) for s in STAGES})


def _node(scans: int):
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode, make_packed_step_se2

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    cfg = AmclNodeConfig(set_initial_pose=True, initial_pose_x=float(xs[0]),
                         initial_pose_y=float(ys[0]), initial_pose_yaw=float(yaws[0]),
                         initial_pose_covariance_yaw=0.068)
    node = AmclNode(cfg, seed=0)
    node.set_map(make_grid(data, RES))
    node._models = _ranged(node._models)
    node._step = make_packed_step_se2(node.params, node._models, node.device)

    def step(t):
        r = node.handle_scan((xs[t], ys[t], yaws[t]), pts[t], mask[t])
        if not r.valid:
            raise RuntimeError(f"node scan {t} was gated out")

    return step


def _large(scans: int):
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state, update
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.maps.occupancy import make_grid

    dev = torch.device("cuda")
    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    pts_d, mask_d = torch.as_tensor(pts).to(dev), torch.as_tensor(mask).to(dev)
    models, ctx = make_likelihood_field_filter(make_grid(data, RES))
    models = _ranged(models)
    n = 262144
    params = AmclParams(max_particles=n, min_particles=n // 4, resampling="systematic")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    states = sample_normal_se2(gen, n, host_pose(xs[0], ys[0], yaws[0]),
                               np.diag([0.25, 0.25, 0.068]))
    box = {"state": init_state(gen, states, params)}

    def step(t):
        box["state"], est = update(params, models, ctx, box["state"],
                                   host_pose(xs[t], ys[t], yaws[t]), pts_d[t], mask_d[t])
        est.pose.xy.cpu()  # the one readback per scan, as the node does

    return step


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
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in stages:
            stages[e.name][0] += e.time_range.elapsed_us()
            stages[e.name][1] += e.device_time_total
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
        "top_device_ms_per_update": {k: 1e-3 * v / scans for k, v in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--trace-dir", default=None, help="write Chrome traces here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_update: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    for name, make in (("node", _node), ("large", _large)):
        print(json.dumps(profile_workload(name, make, args.scans, args.warmup, args.trace_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

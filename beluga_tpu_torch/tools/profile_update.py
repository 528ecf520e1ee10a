"""Where an update's time goes on the card: the port's main-path
workloads under ``torch.profiler``.

    python -m beluga_tpu_torch.tools.profile_update [--scans 20] [--trace-dir DIR]
        [--workloads node,node_raw,node_raw_pipelined,large,fleet,mega,windowed,beam_node,
                     beam_node_windowed,beam_node_exact,range_lut,long_range,beam_fleet,
                     prob_node,shared_scan,prob_fleet,windowed_int8,ndt_node,ndt_fleet,
                     ndt3d_node,vdb,omni_node,stationary_node,large_residual,
                     fleet_residual,node_raw_sparse,winlut_fleet]

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
  through the sphere trace, kernel B8; ``beam_node_windowed`` the same node
  through the windowed range LUT (kernel B7 with its window origins);
  ``beam_node_exact`` the same node on its default path, the exact
  Bresenham march (kernel R1's exact beam-weights entry);
* ``node_raw``, ``node_raw_pipelined``: the ``node`` configuration on the
  arena read from PGM and YAML, fed raw 360-beam LDS-01 ranges through
  ``handle_laser_scan``, synchronous and pipelined (each call returns the
  previous scan's estimate; the synchronize after the window's last scan
  waits for the one in flight);
* ``range_lut``: the beam fleet's range-LUT build (128 bins at 4 m on the
  384² arena, R1's ray entry), once per "scan": a map load's set-up work,
  profiled so that R1's designs can be compared at that shape;
* ``long_range``: the long-range sphere-trace filter, 2048 particles x 60
  beams on the 1024² map at 60 m (kernel B8), forced updates;
* ``beam_fleet``: 64 filters x 4096 particles x 60 beams through the
  windowed range LUT (kernel B7);
* ``prob_node``: ``AmclNode`` with nav2's probability model at nav2
  defaults (kernel B1-log);
* ``shared_scan``: one 262144-particle filter through the shared-scan LUT,
  rebuilt by kernel B9 before every forced update (the ``prepare`` stage);
* ``prob_fleet``: the fleet in the probability model's codebook16 mode
  (kernel B4-log);
* ``windowed_int8``: the windowed filter on int8 window tables (kernel
  B6-int8);
* ``ndt_node``: ``NdtAmclNode`` at nav2 defaults on the 2D NDT map, 360-beam
  point clouds (the fused NDT kernel);
* ``ndt_fleet``: the NDT fleet, 64 filters x 4096 particles x 60 points,
  forced updates (the fused NDT kernel);
* ``ndt3d_node``: ``NdtAmclNode3D`` at nav2 defaults on the 3D NDT map,
  3600-point clouds (the fused NDT kernel);
* ``vdb``: BASELINE config #4, 131072 SE3 particles x 80 points, forced
  updates (kernel B11);
* ``omni_node``: the ``node`` with nav2's omni motion model, the circle
  strafed (facing outward); ``stationary_node``: the ``node`` with the
  stationary model at one pose, every update forced by
  ``request_nomotion_update``;
* ``large_residual``, ``fleet_residual``: ``large`` and ``fleet`` with
  residual resampling (two passes of kernel B2 a resample);
* ``node_raw_sparse``: ``node_raw`` with ``max_particles=10000``, so that
  the node's cluster estimate takes its sparse form;
* ``winlut_fleet``: 64 filters x 4096 particles through one shared windowed
  LUT an update (kernel B6's coverage and states entries, kernel B4 on the
  exact tails or the fallback), from a tight cloud.

After a warm-up each workload runs ``--scans`` scans on the host clock
(wall ms per update, a synchronize after the last), then ``--scans`` more
under the profiler.  For each it prints one JSON line: the wall ms per
update, device-busy ms per update (the sum of the CUDA kernels' and
copies' device times under the profiler), the device's idle share
(1 - busy / wall), kernel launches per update, the update's stages (its
own ``amcl.*`` ranges, host and device ms), a few PyTorch
operators by name (device time and calls per update), the kernels that
take the most time, and the port's hand-written kernels by name (device
time and launches per update, and each launch's least and greatest device
time in µs).  The tool runs any checkout's package: put its
root first on ``PYTHONPATH`` (``ab_variants`` does, for a parent tree too).
A run without a CUDA device exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from beluga_tpu_torch.tools import workloads

# the update's own ranges (``filters/amcl.py:step``, ``utils/profiling.py:span``),
# and this tool's ``prepare``; PERF.md §3 names the model-table label each
# replaces, for a parent's profile from a tree older than them
STAGES = ("amcl.update", "amcl.gate", "amcl.propagate", "amcl.propagate_reweight",
          "amcl.reweight", "amcl.normalize", "amcl.resample", "amcl.recovery", "amcl.kld",
          "amcl.sort", "amcl.select", "amcl.estimate", "prepare")
# PyTorch operators whose device time the profile reports by name, to see
# how they scale with the particle count
OPS = ("aten::cummax", "aten::sort", "aten::cumsum", "aten::matmul", "aten::index_select",
       "aten::linalg_inv_ex")
# the port's hand-written kernels (``csrc/*.cu``) by the names of their
# ``__global__`` functions, reported by name with their device time and
# launches per update (B1's and B4's names cover both their entries; the
# labels stay those of earlier trees, so that ``ab_variants`` lines up a
# parent's profile with this one)
HAND_KERNELS = {
    "reweight_kernel": "B1/B1-log fused_reweight",
    "reweight_values3_kernel": "B4/B4-log fused_reweight values3",
    "cdf_partials_kernel": "B2 CDF build", "cdf_scan_kernel": "B2 CDF build",
    "cdf_tile_kernel": "B2 CDF build", "cdf_grid_kernel": "B2 CDF build",
    "resample_take_kernel": "B2 search", "resample_take_tile_kernel": "B2 one-tile take",
    "pool_take_kernel": "B3 pool_take",  # the row entry and the pooled draw
    "fused_step_kernel": "B5 fused_propagate_winlut", "winlut_kernel": "B6/B6-int8 winlut_lookup",
    "winlut_states_kernel": "B6/B6-int8 winlut_lookup",  # the states entry
    "winlut_coverage_kernel": "B6 coverage (the windowed gate)",
    "beam_lut_kernel": "B7 beam_lut_windowed", "window_origins_kernel": "B7 window origins",
    "sphere_trace_kernel": "B8 sphere_trace",
    "scan_lut_kernel": "B9 scan_lut_correlate", "ndt_probe_kernel": "B10 ndt_probe",
    "ndt_weights_kernel": "B10-fused ndt_weights", "codebook_lookup_kernel": "B11 codebook_lookup",
    "standard_kernel": "R1 cast_rays", "supercover_kernel": "R1 cast_rays",
    "cast_rays_kernel": "R1 cast_rays", "beam_exact_kernel": "R1-exact beam_weights",
}
_SYMBOL = re.compile(r"(\w+_kernel)\b")


def _node(scans: int, scans_fn=workloads.arena_scans, forced: bool = False, **overrides):
    """The node on ``scans_fn(scans)``; ``forced`` asks for each update with
    ``request_nomotion_update`` (a robot that does not move)."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode

    s = scans_fn(scans)
    node = AmclNode(workloads.node_config(s, **overrides), seed=0)
    node.set_map(make_grid(s.data, workloads.RES))

    def step(t):
        if forced:
            node.request_nomotion_update()
        r = node.handle_scan((s.xs[t], s.ys[t], s.yaws[t]), s.points[t], s.mask[t])
        if not r.valid:
            raise RuntimeError(f"node scan {t} was gated out")

    return step


def _raw_node(scans: int, pipelined: bool = False, **overrides):
    """The nav2-default node (``overrides`` of its config fields) on the
    arena read from PGM and YAML, fed raw LDS-01 ranges through
    ``handle_laser_scan``."""
    import tempfile

    from beluga_tpu_torch.maps.occupancy import load_pgm_yaml
    from beluga_tpu_torch.node import AmclNode

    raw = workloads.arena_ranges(scans)
    s = raw.scans
    node = AmclNode(workloads.node_config(s, **overrides), seed=0, pipelined=pipelined)
    with tempfile.TemporaryDirectory() as d:
        node.set_map(load_pgm_yaml(workloads.arena_map_yaml(d)))

    def step(t):
        r = node.handle_laser_scan((s.xs[t], s.ys[t], s.yaws[t]), raw.ranges[t], raw.angle_min,
                                   raw.angle_increment, workloads.LDS_MIN, workloads.LDS_MAX)
        if not r.valid and (t > 0 or not pipelined):
            raise RuntimeError(f"node scan {t} was gated out")

    return step


def _range_lut(scans: int):
    """The beam fleet's range-LUT build, once a step."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut

    s = workloads.arena_scans(1)
    grid = make_grid(s.data, workloads.RES)
    cfg = workloads.BEAM_FLEET

    def step(t):
        lut = build_range_lut(grid, cfg["beam_max_range"], cfg["n_bearings"])
        lut.ranges[0, 0, :1].cpu()

    return step


def _large(scans: int, resampling: str = "systematic"):
    from beluga_tpu_torch.filters.amcl import host_pose, update

    w = workloads.large_filter(scans, torch.device("cuda"), resampling=resampling)
    s = w.scans
    box = {"state": w.state}

    def step(t):
        box["state"], est = update(w.params, w.models, w.ctx, box["state"],
                                   host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
        est.pose.xy.cpu()  # the one readback per scan, as the node does

    return step


def _fleet(scans: int, make_workload=workloads.fleet):
    """A fleet through ``parallel.fleet.make_fleet_update``, or through the
    workload's own ``step`` (the winlut fleet's)."""
    from beluga_tpu_torch.parallel.fleet import make_fleet_update

    w = make_workload(scans, torch.device("cuda"))
    batch = w.points.shape[1]
    fleet_update = w.step or make_fleet_update(w.params, w.models)
    box = {"state": w.state}

    def step(t):
        odoms = workloads.fleet_odometry(w.scans, t, batch)
        box["state"], est = fleet_update(w.ctx, box["state"], odoms, w.points[t], w.mask[t])
        est.pose.xy.cpu()  # the one readback per scan: every filter's pose

    return step


def _forced(make_workload, sort_every: int | None):
    """A single filter stepped with ``force_update`` on every scan and, with
    ``sort_every``, ``sort_now`` on every ``sort_every``-th; a shared-scan
    workload's ``prepare`` builds the scan's LUT first."""
    from beluga_tpu_torch.filters.amcl import host_pose, update

    def make(scans: int):
        w = make_workload(scans, torch.device("cuda"))
        s = w.scans
        box = {"state": w.state}

        def step(t):
            sort_now = None if sort_every is None else t % sort_every == 0
            ctx = w.ctx
            if w.prepare is not None:
                with record_function("prepare"):
                    ctx = w.prepare(ctx, w.points[t], w.mask[t])
            box["state"], est = update(w.params, w.models, ctx,
                                       box["state"]._replace(force_update=True),
                                       host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t],
                                       w.mask[t], sort_now=sort_now)
            est.pose.xy.cpu()

        return step

    return make


def _ndt_node(scans: int, dim: int = 2):
    """An NDT node stepped one point cloud per scan (3D: the scan at ten
    heights)."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.ndt_node import NdtAmclNode, NdtAmclNode3D

    s = workloads.ndt_scans(scans)
    if dim == 2:
        node = NdtAmclNode(workloads.node_config(s), seed=0)
        node.set_map(workloads.ndt_map_2d(node.device))
        clouds, masks = s.points, s.mask
        odoms = [(x, y, yaw) for x, y, yaw in zip(s.xs, s.ys, s.yaws)]
    else:
        node = NdtAmclNode3D(AmclNodeConfig(), seed=0)
        node.set_map(workloads.ndt_map_3d(node.device))
        node.set_initial_pose((s.xs[0], s.ys[0], 0.0), (0.0, 0.0, s.yaws[0]),
                              workloads.INITIAL_COV_3D)
        clouds, masks = workloads.ndt_clouds(s)
        odoms = [(x, y, 0.0, 0.0, 0.0, yaw) for x, y, yaw in zip(s.xs, s.ys, s.yaws)]

    def step(t):
        if not node.handle_point_cloud(odoms[t], clouds[t], masks[t]).valid:
            raise RuntimeError(f"NDT node scan {t} was gated out")

    return step


def _ndt_fleet(scans: int):
    """The NDT fleet stepped with ``force_update`` at the truth odometry."""
    import numpy as np

    from beluga_tpu_torch.parallel.fleet import make_fleet_update

    w = workloads.ndt_fleet(scans, torch.device("cuda"))
    batch = w.points.shape[0]
    fleet_update = make_fleet_update(w.params, w.models)
    odoms = workloads.fleet_odometry(w.scans, 0, batch)
    box = {"state": w.state}

    def step(t):
        box["state"], est = fleet_update(
            w.ctx, box["state"]._replace(force_update=np.ones(batch, bool)), odoms, w.points,
            w.mask)
        est.pose.xy.cpu()

    return step


def _vdb(scans: int):
    """The VDB filter stepped with ``force_update`` at the identity odometry."""
    from beluga_tpu_torch.filters.amcl import update
    from beluga_tpu_torch.lie import SE3

    w = workloads.vdb_filter(scans, torch.device("cuda"))
    box = {"state": w.state}

    def step(t):
        box["state"], est = update(w.params, w.models, w.ctx,
                                   box["state"]._replace(force_update=True), SE3.identity(),
                                   w.points, w.mask)
        est.pose.xyz.cpu()

    return step


WORKLOADS = {"node": _node, "large": _large, "fleet": _fleet,
             "mega": _forced(workloads.mega, workloads.MEGA_SORT_EVERY),
             "windowed": _forced(workloads.windowed, None),
             "beam_node": lambda scans: _node(scans, laser_model_type="beam",
                                              beam_fast_path="sphere_trace"),
             "beam_node_windowed": lambda scans: _node(scans, laser_model_type="beam",
                                                       beam_fast_path="windowed"),
             "beam_node_exact": lambda scans: _node(scans, laser_model_type="beam",
                                                    beam_fast_path="exact"),
             "node_raw": _raw_node,
             "node_raw_pipelined": lambda scans: _raw_node(scans, pipelined=True),
             "range_lut": _range_lut,
             "long_range": _forced(workloads.long_range, None),
             "beam_fleet": lambda scans: _fleet(scans, workloads.beam_fleet),
             "prob_node": lambda scans: _node(scans, laser_model_type="likelihood_field_prob"),
             "shared_scan": _forced(workloads.shared_scan, None),
             "prob_fleet": lambda scans: _fleet(
                 scans, lambda n, dev: workloads.fleet(n, dev, prob_model=True)),
             "windowed_int8": _forced(
                 lambda n, dev: workloads.windowed(n, dev, table_dtype="int8"), None),
             "ndt_node": _ndt_node, "ndt_fleet": _ndt_fleet,
             "ndt3d_node": lambda scans: _ndt_node(scans, dim=3), "vdb": _vdb,
             "omni_node": lambda scans: _node(
                 scans, lambda n: workloads.arena_scans(n, yaw_offset=math.pi / 2),
                 robot_model_type="nav2_amcl::OmniMotionModel"),
             "stationary_node": lambda scans: _node(scans, workloads.still_scans, forced=True,
                                                    robot_model_type="stationary"),
             "large_residual": lambda scans: _large(scans, resampling="residual"),
             "fleet_residual": lambda scans: _fleet(
                 scans, lambda n, dev: workloads.fleet(n, dev, resampling="residual")),
             "node_raw_sparse": lambda scans: _raw_node(scans, max_particles=10000),
             "winlut_fleet": lambda scans: _fleet(scans, workloads.winlut_fleet)}


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
    hand: dict[str, list] = {}
    for e in kernels:
        symbol = _SYMBOL.search(e.name)
        label = HAND_KERNELS.get(symbol.group(1)) if symbol else None
        if label:
            us = e.time_range.elapsed_us()
            entry = hand.setdefault(label, [0.0, 0, us, us])
            entry[0] += us
            entry[1] += 1
            entry[2], entry[3] = min(entry[2], us), max(entry[3], us)
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
        "hand_kernels_per_update": {
            k: {"device_ms": 1e-3 * us / scans, "launches": c / scans, "launch_us_min": lo,
                "launch_us_max": hi}
            for k, (us, c, lo, hi) in sorted(hand.items())},
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

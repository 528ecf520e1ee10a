"""Fleet-scale demo on the PyTorch port: many independent AMCL filters as
one batched update.

The port of ``examples/fleet_demo.py``: B filters of N particles stepped
by ``make_fleet_update`` over ``[B, N]`` states, placed by ``shard_fleet``
on a ``("dp", "tp")`` mesh of the ``torch.distributed`` ranks there are
(``dp`` splits the filters; one rank, so a (1, 1) mesh, unless the script
is started by ``torchrun``).  Each filter localizes its own robot: robot
``b`` drives the in-repo arena's circle (``io/synthetic.py``) from its own
phase, with perfect odometry and laser scans ray-cast by
``io/replay.py:ScanSimulator``, and every filter's estimate is held to the
0.9 m / 30° gate at every step.

Run: python examples/torch_fleet_demo.py [B] [N] [--steps S] [--device cpu]
(on the card by default)
"""

from __future__ import annotations

import argparse
import math
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from beluga_tpu_torch import (  # noqa: E402
    SE2,
    AmclParams,
    make_fleet_update,
    make_grid,
    make_likelihood_field_filter,
    replicate,
    resolve_device,
    shard_fleet,
)
from beluga_tpu_torch.filters.amcl import init_fleet_state  # noqa: E402
from beluga_tpu_torch.io import synthetic  # noqa: E402
from beluga_tpu_torch.io.replay import ScanSimulator  # noqa: E402
from beluga_tpu_torch.parallel.multihost import start_process_group  # noqa: E402
from beluga_tpu_torch.utils.profiling import card_label  # noqa: E402

GRID, RES = 384, 0.05  # the arena: 19.2 m square at 5 cm
GATE_POS_M, GATE_YAW_RAD = 0.9, math.radians(30.0)  # tests/test_system.py:44-45
INITIAL_COV = np.diag([0.25, 0.25, 0.068])


def robot_poses(batch: int, steps: int) -> np.ndarray:
    """``f64[steps, batch, 3]`` truth poses: the robots spread around the
    arena's circle (0.22 rad a step, so ~28.6 steps a lap), each driving
    it from its own start."""
    lap = int(2 * np.pi / 0.22)
    xs, ys, yaws = synthetic.circle_trajectory(steps + lap, GRID, RES)
    at = np.arange(steps)[:, None] + (np.arange(batch) * lap // batch)[None, :]
    return np.stack([xs[at], ys[at], yaws[at]], -1)


def pose_tensor(xyt: np.ndarray, device=None) -> SE2:
    """SE2 ``[b]`` from ``f64[b, 3]`` (x, y, yaw), in float32."""
    return SE2.from_xytheta(*(torch.as_tensor(xyt[:, i], dtype=torch.float32)
                              for i in range(3)), device=device)


def fleet(batch: int, num_particles: int, steps: int, device, mesh):
    """Step a fleet of ``batch`` filters for ``steps`` scans; returns this
    rank's errors ``(pos f64[steps, b], yaw f64[steps, b])`` and the wall
    seconds of each step."""
    data = synthetic.tracking_arena(GRID, RES)
    grid = make_grid(data, RES, device=device)
    models, ctx = make_likelihood_field_filter(grid, device=device)
    params = AmclParams(max_particles=num_particles, min_particles=num_particles // 4)
    truth = robot_poses(batch, steps)

    dp = mesh.size(0)
    b = batch // dp
    block = slice(mesh.get_local_rank("dp") * b, (mesh.get_local_rank("dp") + 1) * b)
    sim = ScanSimulator(grid)
    scans = [[sim.scan(truth[t, k]) for k in range(batch)[block]] for t in range(steps)]
    points = torch.stack([torch.stack([p for p, _ in row]) for row in scans])  # [T, b, 60, 2]
    masks = torch.stack([torch.stack([m for _, m in row]) for row in scans])

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_fleet_state(gen, batch, pose_tensor(truth[0], device), INITIAL_COV, params,
                             device=device)
    state = shard_fleet(mesh, state)
    ctx = replicate(mesh, ctx)
    step = make_fleet_update(params, models, mesh)

    e_pos, e_yaw, walls = [], [], []
    for t in range(steps):
        odom = pose_tensor(truth[t, block], "cpu")  # host odometry, as a robot sends it
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, est = step(ctx, state, odom, points[t], masks[t])
        pose = est.pose.as_xytheta().cpu().numpy().astype(np.float64)  # the one readback
        walls.append(time.perf_counter() - t0)
        d = pose - truth[t, block]
        e_pos.append(np.hypot(d[:, 0], d[:, 1]))
        e_yaw.append(np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))))
    return np.stack(e_pos), np.stack(e_yaw), walls


def main(batch: int = 32, num_particles: int = 1024, steps: int = 10, device=None) -> dict:
    """Run the fleet demo and return rank 0's summary; raises when a filter
    leaves the gate."""
    dev = resolve_device(device)
    own_group = not dist.is_initialized()
    if own_group:
        store = tempfile.TemporaryDirectory()
        if "WORLD_SIZE" in os.environ:  # started by torchrun
            rank, world, init = (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                                 "env://")
        else:
            rank, world, init = 0, 1, f"file://{store.name}/store"
        dev = start_process_group(dev.type, rank, world, init)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        if batch % world:
            raise ValueError(f"{batch} filters do not split over {world} ranks")
        mesh = init_device_mesh(dev.type, (world, 1), mesh_dim_names=("dp", "tp"))
        rank = dist.get_rank()
        e_pos, e_yaw, walls = fleet(batch, num_particles, steps, dev, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()
            store.cleanup()
    steady = walls[1:] if len(walls) > 1 else walls
    mean_s = sum(steady) / len(steady)
    out = dict(filters=batch, particles=num_particles, steps=steps, ranks=world,
               ms_per_step=1e3 * mean_s, filters_per_s=batch / mean_s,
               worst_pos_m=float(e_pos.max()), worst_yaw_deg=math.degrees(float(e_yaw.max())))
    if rank == 0:
        print(f"fleet: {batch} filters x {num_particles} particles on {world} rank(s), "
              f"{card_label(dev)}")
        for t in range(steps):
            print(f"step {t}: {1e3 * walls[t]:7.2f} ms  worst filter {e_pos[t].max():.3f} m / "
                  f"{math.degrees(e_yaw[t].max()):.1f} deg")
        print(f"{out['filters_per_s']:.1f} filters/s ({out['ms_per_step']:.2f} ms a step "
              f"after the first), worst error {out['worst_pos_m']:.3f} m / "
              f"{out['worst_yaw_deg']:.1f} deg against the gate of 0.9 m / 30 deg")
    bad = (e_pos >= GATE_POS_M) | (e_yaw >= GATE_YAW_RAD)
    if bad.any():
        t, k = np.argwhere(bad)[0]
        raise RuntimeError(f"filter {k} left the gate at step {t}: {e_pos[t, k]:.3f} m / "
                           f"{math.degrees(e_yaw[t, k]):.1f} deg")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("batch", nargs="?", type=int, default=32)
    parser.add_argument("particles", nargs="?", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.batch, args.particles, args.steps, args.device)

"""Mega-filter demo on the PyTorch port: one AMCL filter with millions of
particles.

The port of ``examples/mega_demo.py``: a single filter tracking through
the fused windowed scan-LUT update (``make_windowed_scan_filter(fused=True)``,
kernel B5) with θ-sorted slots, selective resampling (the reference's
ESS < N/2 option), a bounded recovery pool and a statically scheduled
slot sort (the sort on the first of every 4 updates).  The map is the
in-repo arena (``io/synthetic.py``); the robot wanders it along
``io/replay.py:drive_trajectory`` and its scans are ray-cast by
``ScanSimulator`` (kernel R1 on the card).  Every update is forced; each
estimate is held to the 0.9 m / 30° gate.

Run: python examples/torch_mega_demo.py [N] [STEPS] [--device cpu]
(on the card by default: 2^21 particles and 96 steps; on the CPU 2^14 and 16)
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from beluga_tpu_torch import (  # noqa: E402
    SE2,
    AmclParams,
    init_state,
    make_grid,
    resolve_device,
    update,
)
from beluga_tpu_torch.core.particles import tree_sort_by  # noqa: E402
from beluga_tpu_torch.core.random import sample_normal_se2  # noqa: E402
from beluga_tpu_torch.filters.builders import make_windowed_scan_filter  # noqa: E402
from beluga_tpu_torch.io import synthetic  # noqa: E402
from beluga_tpu_torch.io.replay import ScanSimulator, ScanSpec, drive_trajectory  # noqa: E402
from beluga_tpu_torch.utils.profiling import card_label  # noqa: E402

GRID, RES = 384, 0.05  # the arena: 19.2 m square at 5 cm
START_XY = (GRID * RES / 2 + 1.2, GRID * RES / 2)  # a free point on the arena's circle
GATE_POS_M, GATE_YAW_RAD = 0.9, math.radians(30.0)  # tests/test_system.py:44-45
SUB = 4  # the static sort schedule: the θ sort on update 0 of every SUB


def main(n: int | None = None, steps: int | None = None, device=None) -> dict:
    """Run the mega demo and return its summary; raises when an estimate
    leaves the gate."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n = n or (1 << 21 if on_card else 1 << 14)
    steps = steps or (96 if on_card else 16)
    steps -= steps % SUB

    grid = make_grid(synthetic.tracking_arena(GRID, RES), RES, device=dev)
    traj = drive_trajectory(grid, start_xy=START_XY, num_steps=steps, seed=5)
    sim = ScanSimulator(grid, ScanSpec(num_beams=60, max_beams=60))
    noise = torch.Generator(device=dev)
    noise.manual_seed(3)
    scans = [sim.scan(pose, generator=noise, noise_sigma=0.01) for pose in traj]

    # the JAX benchmark's flagship geometry (bench.py:289-299): the fused
    # kernel, a (32, 128) window at dth = 2π/64, k_bins = tblk = 20 (the θ
    # slab spans the whole LUT), 4096-particle tiles
    models, ctx = make_windowed_scan_filter(
        grid, k_bins=20, win=(32, 128), dth=2.0 * np.pi / 64.0, max_point_radius=3.6,
        tile=4096 if on_card else 512, tblk=20, recovery_candidates=256,
        coverage_threshold=0.0, exact_tail_frac=0.0, fused=True, device=dev)
    params = AmclParams(max_particles=n, min_particles=n, sorted_slots=True,
                        resampling="systematic", recovery_pool=min(4096, n // 4),
                        selective_resampling=True, update_min_d=0.01, update_min_a=0.01)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    start = SE2.from_xytheta(*(float(v) for v in traj[0]), device="cpu")
    states = sample_normal_se2(gen, n, start, np.diag([0.06, 0.06, 0.02]))
    state = init_state(gen, tree_sort_by(states.theta, states), params, device=dev)

    est_xyt, walls = [], []
    for t, (x, y, yaw) in enumerate(traj):
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        odom = SE2.from_xytheta(float(x), float(y), float(yaw), device="cpu")
        state, est = update(params, models, ctx, state._replace(force_update=True), odom,
                            *scans[t], sort_now=t % SUB == 0)
        est_xyt.append(est.pose.as_xytheta().cpu().numpy().astype(np.float64))
        walls.append(time.perf_counter() - t0)
    est_xyt = np.stack(est_xyt)
    err = np.hypot(est_xyt[:, 0] - traj[:, 0], est_xyt[:, 1] - traj[:, 1])
    d_yaw = est_xyt[:, 2] - traj[:, 2]
    yaw_err = np.abs(np.arctan2(np.sin(d_yaw), np.cos(d_yaw)))

    # the first group of SUB updates builds the kernels and warms the caches
    timed = walls[SUB:] if steps > SUB else walls
    dt = sum(timed) / len(timed)
    out = dict(particles=n, steps=steps, ms_per_step=1e3 * dt, particle_updates_per_s=n / dt,
               err_mean_m=float(err.mean()), err_max_m=float(err.max()),
               yaw_err_max_deg=math.degrees(float(yaw_err.max())), device=card_label(dev))
    print(f"{n} particles x {steps} steps on {out['device']}: {out['ms_per_step']:.2f} ms/step "
          f"({out['particle_updates_per_s']:.3e} particle-updates/s over the last "
          f"{len(timed)}), tracking err mean {out['err_mean_m']:.3f} m / max "
          f"{out['err_max_m']:.3f} m, yaw max {out['yaw_err_max_deg']:.1f} deg")
    bad = (err >= GATE_POS_M) | (yaw_err >= GATE_YAW_RAD)
    if bad.any():
        t = int(np.argmax(bad))
        raise RuntimeError(f"step {t} left the gate: {err[t]:.3f} m / "
                           f"{math.degrees(yaw_err[t]):.1f} deg")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n", nargs="?", type=int, default=None, help="particles")
    parser.add_argument("steps", nargs="?", type=int, default=None)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args()
    main(args.n, args.steps, args.device)

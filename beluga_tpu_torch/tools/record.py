"""Synthetic sensor-stream recorder (port of ``beluga_tpu/tools/record.py``).

The reference ships the ``perfect_odometry`` rosbag only as metadata; this
tool makes an equivalent stream: a collision-free trajectory through a map
(``io/replay.py:drive_trajectory``), LDS-01 scans ray-cast by kernel R1 on
the card (``io/replay.py:ScanSimulator``) with numpy range noise from
``--seed``, and perfect odometry, in the ``.npz`` format that
``tools/localize.py`` reads.

    python -m beluga_tpu_torch.tools.record --map map.yaml --output stream.npz \\
        --steps 200 --start -1.7 0.5 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def record(map_yaml, output_npz, steps=200, start=(-1.7, 0.5), seed=3, num_beams=360,
           max_range=3.5, noise_sigma=0.01, device=None):
    """Record ``steps`` scans to ``output_npz``; returns ``(trajectory f64[T,
    3], scans f32[T, num_beams])``.  ``device`` defaults to ``"cuda"``."""
    from beluga_tpu_torch.io.replay import ScanSimulator, ScanSpec, drive_trajectory
    from beluga_tpu_torch.maps.occupancy import load_pgm_yaml

    grid = load_pgm_yaml(map_yaml, device=device)
    traj = drive_trajectory(grid, start_xy=tuple(start), num_steps=steps, seed=seed)
    sim = ScanSimulator(grid, ScanSpec(num_beams=num_beams, max_range=max_range,
                                       max_beams=num_beams))
    rng = np.random.default_rng(seed)
    scans = np.full((steps, num_beams), np.nan, np.float32)
    for t, pose in enumerate(traj):
        dist, hit = sim.cast(pose)
        d = dist.cpu().numpy() + rng.normal(0, noise_sigma, num_beams)
        h = hit.cpu().numpy()
        scans[t, h] = d[h]

    np.savez_compressed(
        output_npz,
        odom=traj,  # perfect odometry: odom == ground truth
        ground_truth=traj,
        scans=scans,
        angle_min=-np.pi,
        angle_increment=2 * np.pi / num_beams,
        range_min=0.12,
        range_max=max_range,
    )
    return traj, scans


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--map", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--start", type=float, nargs=2, default=(-1.7, 0.5))
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises without one; cpu runs the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)
    traj, _ = record(args.map, args.output, args.steps, args.start, args.seed,
                     device=args.device)
    print(f"recorded {len(traj)} scans to {args.output}")


if __name__ == "__main__":
    main()

"""Offline localization (port of ``beluga_tpu/tools/localize.py``; the
executable node's bag replay without middleware).

Replays a recorded sensor stream through the port's ``AmclNode`` and
writes the estimated trajectory and its accuracy.  The input is an
``.npz`` stream or a rosbag2 ``.db3`` with LaserScan or PointCloud2
traffic (``io/rosbag.py``).

Stream format (.npz):
  odom:            f64[T, 3]  (x, y, yaw) base pose in the odom frame per scan
  scans:           f32[T, B]  ranges (NaN or inf: invalid)
  angle_min:       f64 scalar
  angle_increment: f64 scalar
  range_min/range_max: f64 scalars (optional)
  ground_truth:    f64[T, 3]  optional, enables the APE report

Two modes give the same updates: host-driven (``handle_laser_scan`` or
``handle_point_cloud`` a scan) and ``--scan-driven`` (every scan prepared
first, then ``io/replay.py:replay_on_device``: the updates queued with no
readback until the end).

    python -m beluga_tpu_torch.tools.localize --map map.yaml --input stream.npz \\
        [--params amcl.yaml] [--output trajectory.npz] [--scan-driven] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _read_stream(path: str):
    """(stream, clouds or None) from an .npz stream or a .db3 bag."""
    if not str(path).endswith((".db3", ".sqlite3")):
        return np.load(path), None
    # a rosbag2 bag: LaserScan traffic, or PointCloud2 through the node's
    # point-cloud input (amcl_node.cpp:236-239)
    from beluga_tpu_torch.io.rosbag import (
        _CLOUD_TYPES,
        _SCAN_TYPES,
        read_bag_cloud_stream,
        read_bag_stream,
        read_bag_topics,
    )

    types = {t for _, t, _ in read_bag_topics(path).values()}
    if types & set(_SCAN_TYPES):
        return read_bag_stream(path), None
    if types & set(_CLOUD_TYPES):
        data = read_bag_cloud_stream(path)
        return data, np.asarray(data["clouds"], np.float32)
    raise ValueError("bag has neither LaserScan nor PointCloud2 traffic")


def run(map_yaml, input_npz, output_npz=None, params_yaml=None, initial_pose=None,
        scan_driven=False, device=None):
    """Localize along a recorded stream; returns the summary dict (updates,
    scans, latency and, with ground truth, ``ape``) and writes
    ``estimates``, ``estimate_indices`` and ``summary`` to ``output_npz``.
    ``device`` defaults to ``"cuda"``."""
    from beluga_tpu_torch.io.config import AmclNodeConfig, load_config
    from beluga_tpu_torch.maps.occupancy import load_pgm_yaml
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.utils.metrics import ape
    from beluga_tpu_torch.utils.profiling import LatencyRecorder

    cfg = load_config(params_yaml) if params_yaml else AmclNodeConfig()
    data, clouds = _read_stream(input_npz)
    odom = np.asarray(data["odom"], np.float64)
    if clouds is None:
        scans = np.asarray(data["scans"], np.float32)
        angle_min = float(data["angle_min"])
        angle_inc = float(data["angle_increment"])
        range_min = float(data["range_min"]) if "range_min" in data else cfg.laser_min_range
        range_max = (float(data["range_max"]) if "range_max" in data
                     else min(cfg.laser_max_range, 1e9))

    node = AmclNode(cfg, device=device)
    node.set_map(load_pgm_yaml(map_yaml, device=node.device))
    if initial_pose is not None:
        node.set_initial_pose(*initial_pose)
    elif cfg.set_initial_pose:
        pass  # set_map already applied the configured pose
    elif "ground_truth" in data:
        node.set_initial_pose(*data["ground_truth"][0])
    else:
        node.global_localization()

    if scan_driven:
        import torch

        from beluga_tpu_torch.io.replay import replay_on_device

        t_prep = time.perf_counter()
        mb = cfg.max_beams
        pts_all = np.zeros((len(odom), mb, 2), np.float32)
        mask_all = np.zeros((len(odom), mb), bool)
        for t in range(len(odom)):
            if clouds is not None:
                pts_all[t], mask_all[t] = node.prepare_point_cloud(clouds[t])
            else:
                pts_all[t], mask_all[t] = node.prepare_scan(scans[t], angle_min, angle_inc,
                                                            range_min, range_max)
        prep_s = time.perf_counter() - t_prep
        t0 = time.perf_counter()
        _, ests = replay_on_device(node.params, node._models, node._ctx, node._state,
                                   odom.astype(np.float32), pts_all, mask_all)
        z = ests.pose.rot.z
        xyt = torch.cat([ests.pose.xy, torch.atan2(z[:, 1], z[:, 0])[:, None]], -1)
        xyt = xyt.cpu().numpy()  # the one readback
        wall = time.perf_counter() - t0
        est_idx = np.nonzero(ests.valid)[0].astype(np.int64)
        est = xyt[est_idx].astype(np.float64)
        summary = {
            "updates": int(len(est)), "scans": int(len(odom)),
            "latency": {"mode": "scan_driven", "device_wall_s": wall,
                        "per_scan_ms": wall / max(len(odom), 1) * 1e3, "host_prep_s": prep_s},
        }
    else:
        recorder = LatencyRecorder()
        est, est_idx = [], []
        for t in range(len(odom)):
            with recorder.measure():
                if clouds is not None:
                    res = node.handle_point_cloud(odom[t], clouds[t])
                else:
                    res = node.handle_laser_scan(odom[t], scans[t], angle_min, angle_inc,
                                                 range_min, range_max)
            if res.valid:
                est.append(res.pose)
                est_idx.append(t)
        est = np.asarray(est).reshape(-1, 3)
        est_idx = np.asarray(est_idx, np.int64)
        summary = {"updates": int(len(est)), "scans": int(len(odom)),
                   "latency": recorder.summary()}
    if "ground_truth" in data and len(est):
        gt = np.asarray(data["ground_truth"], np.float64)[est_idx]
        summary["ape"] = ape(est, gt)

    if output_npz:
        np.savez_compressed(output_npz, estimates=est, estimate_indices=est_idx,
                            summary=json.dumps(summary))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--map", required=True, help="map YAML (PGM + metadata)")
    p.add_argument("--input", required=True, help="sensor stream .npz or rosbag2 .db3")
    p.add_argument("--params", default=None, help="nav2-style parameter YAML")
    p.add_argument("--output", default=None, help="trajectory output .npz")
    p.add_argument("--initial-pose", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "YAW"))
    p.add_argument("--scan-driven", action="store_true",
                   help="prepare every scan first, then queue the updates with no "
                        "readback until the end")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, which raises without one; cpu runs the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)
    summary = run(args.map, args.input, args.output, args.params, args.initial_pose,
                  scan_driven=args.scan_driven, device=args.device)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()

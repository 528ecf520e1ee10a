"""The port's replay tools (``beluga_tpu_torch/io/replay.py``,
``tools/record.py``, ``tools/localize.py``, ``utils/checkpoint.py``,
``utils/profiling.py``) on the CPU, against the JAX package's where one
exists.

Tolerances:
  * ``drive_trajectory`` is numpy on both sides: exact.
  * ``ScanSimulator`` casts with R1's plain version against the JAX
    ``cast_rays``: the tolerance ``tests/test_torch_raycast.py`` states
    for R1 (hit flags equal but where XLA's CPU backend contracts the far
    cell's product into an FMA, on a ray whose far point lies within an
    ulp of a cell edge; distances within two ulp), here for the frame the
    simulator composes (``origin⁻¹ · pose``, one heading a beam), which
    XLA may contract too; a differing flag off a far-cell edge is named.
  * ``record``'s stream: its trajectory exact, its scans at that
    tolerance (the noise is numpy's on both sides).
  * ``replay_on_device`` against the node's per-scan loop, and a filter
    restored from a checkpoint against one never saved: bit-equal.
  * ``localize.run`` host-driven and scan-driven: the same updates, and
    APE rmse ≤ 0.9 m (the system gate, test_system.cpp:133).

Maps: the synthetic arena written as PGM and YAML to ``tmp_path``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from beluga_tpu.io.replay import ScanSimulator as JScanSimulator
from beluga_tpu.io.replay import ScanSpec as JScanSpec
from beluga_tpu.io.replay import drive_trajectory as j_drive_trajectory
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import load_pgm_yaml as j_load_pgm_yaml
from beluga_tpu.tools.record import record as j_record
from beluga_tpu_torch.filters.amcl import update
from beluga_tpu_torch.io import rosbag, synthetic
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.io.replay import (
    ScanSimulator,
    ScanSpec,
    drive_trajectory,
    replay,
    replay_on_device,
)
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import load_pgm_yaml
from beluga_tpu_torch.node import AmclNode
from beluga_tpu_torch.tools import localize
from beluga_tpu_torch.tools.record import record
from beluga_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(1)

GRID, RES = 256, 0.05
CENTER = GRID * RES / 2
START = (CENTER + 1.2, CENTER)


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    """The arena's map YAML, written once for the module."""
    d = tmp_path_factory.mktemp("arena")
    return synthetic.write_map_yaml(d, synthetic.tracking_arena(GRID, RES, seed=1), RES)


def far_edge(src, d, max_range, res):
    """Rays whose far point lies within a few float32 ulp of a cell edge."""
    far = src + np.float32(max_range) * d
    cells = far / np.float32(res)
    return np.abs(cells - np.round(cells)).max(-1) <= 4 * np.spacing(np.abs(cells)).max(-1)


def assert_ranges_close(got, want, rays, what):
    """R1's tolerance against the JAX cast: NaN (no return) at the same
    beams but on far-edge rays, finite ranges within two ulp where they
    agree on a return."""
    hit, j_hit = np.isfinite(got), np.isfinite(want)
    src, dirs, max_range, res = rays
    flips = np.nonzero(hit != j_hit)[0]
    assert far_edge(src, dirs, max_range, res)[flips].all(), f"{what}: hit flags differ at {flips}"
    same = hit & j_hit
    np.testing.assert_array_max_ulp(got[same], want[same], maxulp=2)
    assert same.sum() > 0.2 * len(got)


def frame(grid, pose, n):
    """The rays the simulator casts, for naming the far-edge ones."""
    local = grid.origin.inverse() @ SE2.from_xytheta(*pose)
    ang = local.theta.numpy() + np.linspace(-np.pi, np.pi, n, endpoint=False).astype(np.float32)
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return np.broadcast_to(local.xy.numpy(), dirs.shape), dirs


def test_drive_trajectory_is_the_reference(arena):
    grid, j_grid = load_pgm_yaml(arena, device="cpu"), j_load_pgm_yaml(arena)
    for seed, steps in ((0, 80), (5, 40)):
        np.testing.assert_array_equal(drive_trajectory(grid, START, steps, seed=seed),
                                      j_drive_trajectory(j_grid, START, steps, seed=seed))
    with pytest.raises(ValueError, match="free space"):
        drive_trajectory(grid, (0.01, 0.01), 3)


def test_scan_simulator_against_the_reference(arena):
    """Ranges, and the decimated scan with the reference's own noise
    passed in as draws."""
    grid, j_grid = load_pgm_yaml(arena, device="cpu"), j_load_pgm_yaml(arena)
    spec = ScanSpec(num_beams=360)
    sim, j_sim = ScanSimulator(grid, spec), JScanSimulator(j_grid, JScanSpec(num_beams=360))
    traj = drive_trajectory(grid, START, 12, seed=2)
    key = jax.random.PRNGKey(0)
    for t, pose in enumerate(traj[::3]):
        rays = (*frame(grid, pose, 360), spec.max_range, grid.resolution)
        j_pose = JSE2.from_xytheta(*(float(v) for v in pose))
        assert_ranges_close(sim.ranges(pose), np.asarray(j_sim.ranges(j_pose)), rays, f"{t}")
        key, k = jax.random.split(key)
        draws = np.asarray(jax.random.normal(k, (360,), jax.numpy.float32))
        pts, mask = sim.scan(SE2.from_xytheta(*pose), draws=draws, noise_sigma=0.01)
        j_pts, j_mask = (np.asarray(a) for a in j_sim.scan(j_pose, k, 0.01))
        agree = (mask.numpy() == j_mask)
        assert agree.mean() >= 0.95 and pts.shape == (60, 2)
        both = agree & j_mask
        np.testing.assert_allclose(pts.numpy()[both], j_pts[both], rtol=1e-6, atol=1e-6)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    np.testing.assert_array_equal(sim.ranges(traj[0], g1, 0.01), sim.ranges(traj[0], g2, 0.01))
    assert not np.array_equal(sim.ranges(traj[0], g1, 0.01), sim.ranges(traj[0]))


def test_record_against_the_reference(arena, tmp_path):
    traj, scans = record(arena, tmp_path / "s.npz", steps=12, start=START, seed=4, device="cpu")
    j_traj, j_scans = j_record(arena, tmp_path / "j.npz", steps=12, start=START, seed=4)
    np.testing.assert_array_equal(traj, j_traj)
    grid = load_pgm_yaml(arena, device="cpu")
    for t in range(len(traj)):
        rays = (*frame(grid, traj[t], 360), 3.5, grid.resolution)
        # the noise moves a range by ~0.01: compare where both returned
        assert_ranges_close(scans[t], j_scans[t], rays, f"scan {t}")
    saved, j_saved = np.load(tmp_path / "s.npz"), np.load(tmp_path / "j.npz")
    assert sorted(saved) == sorted(j_saved)
    for key in ("odom", "ground_truth", "angle_min", "angle_increment", "range_min",
                "range_max"):
        np.testing.assert_array_equal(saved[key], j_saved[key])


def recorded_node(arena, tmp_path, steps=24):
    record(arena, tmp_path / "s.npz", steps=steps, start=START, seed=4, device="cpu")
    data = np.load(tmp_path / "s.npz")
    cfg = AmclNodeConfig(max_particles=400, min_particles=100, update_min_d=0.1,
                         update_min_a=0.1)  # some scans gated out
    return data, cfg


def node_on(arena, cfg, data):
    node = AmclNode(cfg, seed=2, device="cpu")
    node.set_map(load_pgm_yaml(arena, device="cpu"))
    node.set_initial_pose(*data["ground_truth"][0])
    return node


def test_replay_on_device_is_the_per_scan_loop(arena, tmp_path):
    data, cfg = recorded_node(arena, tmp_path)
    args = (float(data["angle_min"]), float(data["angle_increment"]),
            float(data["range_min"]), float(data["range_max"]))
    host = node_on(arena, cfg, data)
    results = [host.handle_laser_scan(o, s, *args) for o, s in zip(data["odom"], data["scans"])]
    dev = node_on(arena, cfg, data)
    prepared = [dev.prepare_scan(s, *args) for s in data["scans"]]
    state, ests = replay_on_device(dev.params, dev._models, dev._ctx, dev._state,
                                   data["odom"].astype(np.float32),
                                   np.stack([p for p, _ in prepared]),
                                   np.stack([m for _, m in prepared]))
    np.testing.assert_array_equal(ests.valid, [r.valid for r in results])
    assert 5 < ests.valid.sum() < len(results)
    z = ests.pose.rot.z
    yaw = torch.atan2(z[:, 1], z[:, 0])
    xyt = torch.cat([ests.pose.xy, yaw[:, None]], -1).numpy().astype(np.float64)
    for t, r in enumerate(results):
        if r.valid:
            np.testing.assert_array_equal(xyt[t], r.pose)
            np.testing.assert_array_equal(ests.covariance[t].numpy().astype(np.float64),
                                          r.covariance)
    assert torch.equal(state.particles.log_weight, host._state.particles.log_weight)


def test_checkpoint_round_trip_continues_bit_for_bit(arena, tmp_path):
    """A node's state saved after k scans, restored into a fresh node's:
    the generator's state included, the next scans are bit-equal."""
    data, cfg = recorded_node(arena, tmp_path, steps=16)
    args = (float(data["angle_min"]), float(data["angle_increment"]), 0.12, 3.5)
    a = node_on(arena, cfg, data)
    for t in range(8):
        a.handle_laser_scan(data["odom"][t], data["scans"][t], *args)
    checkpoint.save_state(tmp_path / "ckpt.npz", a._state)
    b = node_on(arena, cfg, data)
    template = b._state
    b._state = checkpoint.load_state(tmp_path / "ckpt.npz", template)
    assert b._state.generator is not template.generator
    for t in range(8, 16):
        ra = a.handle_laser_scan(data["odom"][t], data["scans"][t], *args)
        rb = b.handle_laser_scan(data["odom"][t], data["scans"][t], *args)
        assert ra.valid == rb.valid
        if ra.valid:
            np.testing.assert_array_equal(ra.pose, rb.pose)
    assert torch.equal(a._state.particles.state.xy, b._state.particles.state.xy)
    assert a._state.generator.get_state().equal(b._state.generator.get_state())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(tmp_path / "ckpt.npz", (template, template))


def test_localize_host_and_scan_driven_agree(arena, tmp_path):
    """``localize.run`` on the .npz stream and on .db3 bags of the same
    stream with LaserScan and with PointCloud2 traffic: each mode gives
    the same updates and passes the APE gate."""
    traj, scans = record(arena, tmp_path / "s.npz", steps=30, start=START, seed=6,
                         device="cpu")
    rosbag.write_scan_bag(tmp_path / "scan.db3", traj, scans, -np.pi, 2 * np.pi / 360, 0.12,
                          3.5)
    angles = np.linspace(-np.pi, np.pi, 360, endpoint=False)
    clouds = [np.stack([r * np.cos(angles), r * np.sin(angles), np.full(360, 0.15)], -1)
              for r in scans]
    rosbag.write_cloud_bag(tmp_path / "cloud.db3", traj, clouds)
    params = tmp_path / "p.yaml"
    params.write_text("max_particles: 512\nmin_particles: 128\n"
                      "update_min_d: 0.05\nupdate_min_a: 0.05\n")
    for name in ("s.npz", "scan.db3", "cloud.db3"):
        out = {}
        for driven in (False, True):
            path = tmp_path / f"{name}.{driven}.npz"
            summary = localize.run(arena, tmp_path / name, path, params, device="cpu",
                                   scan_driven=driven)
            assert summary["ape"]["rmse"] <= 0.9, (name, driven, summary)
            assert summary["updates"] >= 8
            out[driven] = np.load(path)
            assert json.loads(str(out[driven]["summary"]))["updates"] == summary["updates"]
        assert summary["latency"]["mode"] == "scan_driven"
        np.testing.assert_array_equal(out[True]["estimate_indices"], out[False]["estimate_indices"])
        np.testing.assert_array_equal(out[True]["estimates"], out[False]["estimates"])


def test_replay_and_profiling_helpers(arena):
    """``replay`` with a generator of its own over a short trajectory, and
    the latency recorder and timer on the CPU."""
    grid = load_pgm_yaml(arena, device="cpu")
    sim = ScanSimulator(grid)
    traj = drive_trajectory(grid, START, 6, seed=1)
    node = AmclNode(AmclNodeConfig(max_particles=200, min_particles=50), seed=0, device="cpu")
    node.set_map(grid)
    node.set_initial_pose(*traj[0])

    def step(state, pose, pts, mask):
        return update(node.params, node._models, node._ctx, state, pose, pts, mask)

    _, results = replay(step, node._state, traj, sim)
    assert len(results) == 6 and results[0][1].valid
    rec = profiling.LatencyRecorder()
    for _ in range(3):
        with rec.measure():
            pass
    assert rec.summary()["count"] == 3 and profiling.LatencyRecorder().summary() == {"count": 0}
    assert profiling.time_compiled(lambda: None, iters=2, warmup=1, device="cpu") >= 0.0

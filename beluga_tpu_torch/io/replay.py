"""Sensor-stream replay and simulation (port of ``beluga_tpu/io/replay.py``).

The reference's system tests replay a recorded rosbag through the filter
and gate each update's pose error (test_system.cpp:119-272).  Its bag
payload is not shipped, so this module makes the stream:

  * :class:`ScanSimulator`: laser scans ray-cast against an occupancy grid
    by kernel R1's ray entry (``ops/raycast.py:cast_rays``) on the card,
    with the geometry of the turtlebot3 LDS-01 of the ``perfect_odometry``
    bag (360 beams over 2π, 3.5 m);
  * :func:`drive_trajectory`: a collision-checked wander through the map's
    free space with perfect odometry, in numpy;
  * :func:`replay`: a filter update a scan, the estimates collected;
  * :func:`replay_on_device`: a whole recorded stream with no readback
    until its end.

The per-update gates of 0.9 m and 30° (test_system.cpp:133-134) are
asserted by the callers.  Noise comes from a ``torch.Generator`` the
caller gives, or from draws the caller passes; never from a global one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from beluga_tpu_torch.filters.amcl import Estimate, update
from beluga_tpu_torch.io.native import take_evenly_indices
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.ops.raycast import cast_rays


@dataclasses.dataclass(frozen=True)
class ScanSpec:
    """Laser geometry; the defaults are the turtlebot3 LDS-01 of the
    perfect_odometry bag (360 beams, 0.12-3.5 m)."""

    num_beams: int = 360
    min_range: float = 0.12
    max_range: float = 3.5
    max_beams: int = 60  # decimation, beluga_ros::LaserScan max_beams


class ScanSimulator:
    """Ray-cast scans (kernel R1's ray entry on the card) and the
    take-evenly beam decimation.  Poses are world-frame ``SE2`` (0-d, on
    any device) or ``(x, y, yaw)``."""

    def __init__(self, grid: OccupancyGrid, spec: ScanSpec = ScanSpec()):
        self.grid = grid
        self.spec = spec
        self._angles = torch.as_tensor(
            np.linspace(-np.pi, np.pi, spec.num_beams, endpoint=False), dtype=torch.float32,
            device=grid.device)

    def cast(self, pose) -> tuple[torch.Tensor, torch.Tensor]:
        """``(distance f32[num_beams], hit bool[num_beams])`` on the grid's
        device: one call of R1's ray entry, the source broadcast to every
        beam."""
        if not isinstance(pose, SE2):
            pose = SE2.from_xytheta(*(float(v) for v in pose))
        local = self.grid.origin.inverse() @ pose.to(self.grid.device)
        n = self.spec.num_beams
        src = local.xy.expand(n, 2)
        world_angles = local.theta + self._angles
        dirs = torch.stack([torch.cos(world_angles), torch.sin(world_angles)], -1)
        return cast_rays(self.grid, src, dirs, self.spec.max_range)

    def _noisy(self, pose, generator, noise_sigma, draws) -> tuple[np.ndarray, np.ndarray]:
        dist, hit = self.cast(pose)
        if draws is not None:
            draws = torch.as_tensor(np.array(draws, np.float32), device=dist.device)
            dist = dist + draws * noise_sigma
        elif noise_sigma > 0.0 and generator is not None:
            dist = dist + torch.randn(dist.shape, generator=generator, dtype=torch.float32,
                                      device=dist.device) * noise_sigma
        return dist.cpu().numpy(), hit.cpu().numpy()

    def ranges(self, pose, generator: torch.Generator | None = None, noise_sigma: float = 0.0,
               draws=None) -> np.ndarray:
        """Raw undecimated ranges with NaN for beams with no return: the
        ``sensor_msgs/LaserScan.ranges`` wire format, for recording bags.
        Noise is ``noise_sigma`` times standard normals, drawn from
        ``generator`` (on the grid's device) or given as ``draws``
        ``f32[num_beams]``; none without either."""
        dist, hit = self._noisy(pose, generator, noise_sigma, draws)
        return np.where(hit, dist, np.nan).astype(np.float32)

    def scan(self, pose, generator: torch.Generator | None = None, noise_sigma: float = 0.0,
             draws=None) -> tuple[torch.Tensor, torch.Tensor]:
        """One scan from a world-frame pose, decimated: ``(points
        f32[max_beams, 2], mask bool[max_beams])`` in the base frame, on
        the grid's device (what beluga_ros::Amcl::update consumes after the
        sensor transform, beluga_ros/src/amcl.cpp:54-63).  Noise as in
        :meth:`ranges`."""
        dist, hit = self._noisy(pose, generator, noise_sigma, draws)
        valid = hit & (dist >= self.spec.min_range) & (dist <= self.spec.max_range)
        # take_evenly decimation to max_beams (views/take_evenly.hpp, applied
        # by the LaserScan adapter before range filtering)
        idx = take_evenly_indices(self.spec.num_beams, self.spec.max_beams)
        angles = self._angles.cpu().numpy()[idx]
        r = dist[idx]
        m = valid[idx]
        pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32)
        pts[~m] = 0.0
        dev = self.grid.device
        return torch.as_tensor(pts).to(dev), torch.as_tensor(m).to(dev)


def drive_trajectory(grid: OccupancyGrid, start_xy: tuple[float, float], num_steps: int,
                     step_length: float = 0.06, robot_radius: float = 0.15,
                     seed: int = 0) -> np.ndarray:
    """A smooth collision-free trajectory through free space: keep the
    heading, steer away when the lookahead footprint would leave free
    space.  Returns ``f64[num_steps, 3]`` (x, y, yaw) ground-truth poses in
    the world frame."""
    rng = np.random.default_rng(seed)
    data = grid.data.cpu().numpy()
    res = grid.resolution
    ox, oy, origin_th = grid.origin_xytheta
    origin_xy = np.array([ox, oy])
    c, s = np.cos(origin_th), np.sin(origin_th)
    rot_inv = np.array([[c, s], [-s, c]])

    def is_free(p_world):
        local = rot_inv @ (np.asarray(p_world) - origin_xy)
        for dx in (-robot_radius, 0.0, robot_radius):  # a small footprint
            for dy in (-robot_radius, 0.0, robot_radius):
                ci = np.floor((local + [dx, dy]) / res).astype(int)
                if not (0 <= ci[0] < data.shape[1] and 0 <= ci[1] < data.shape[0]):
                    return False
                if data[ci[1], ci[0]] != 0:
                    return False
        return True

    pose = np.array([start_xy[0], start_xy[1], 0.0])
    if not is_free(pose[:2]):
        raise ValueError(f"start pose {tuple(start_xy)} is not in free space")
    out = np.zeros((num_steps, 3))
    for i in range(num_steps):
        # steer: straight, else rotate until the lookahead is free
        for attempt in range(36):
            delta = 0.0 if attempt == 0 else rng.uniform(-np.pi / 4, np.pi / 4) * (
                1 + attempt / 6)
            yaw = pose[2] + delta
            lookahead = pose[:2] + 4 * step_length * np.array([np.cos(yaw), np.sin(yaw)])
            if is_free(lookahead):
                break
        pose[2] = yaw + rng.normal(0.0, 0.02)
        pose[:2] += step_length * np.array([np.cos(pose[2]), np.sin(pose[2])])
        out[i] = pose
    return out


def replay_on_device(params, models, ctx, state, odoms_xyt, points, masks):
    """Replay a whole recorded stream with no readback until its end (the
    port of the reference's one ``lax.scan`` program).

    Every scan is staged on the device first; then ``filters.amcl.update``
    is queued T times, each update's odometry built on the host from its
    float32 row by ``SE2.from_xytheta``, as the node's packed step builds it
    (so both feed the update the same bits), and the estimates are stacked
    on the device.  Nothing waits for the
    card here: the caller reads the stacked estimates once.

    Args:
      odoms_xyt: ``f32[T, 3]`` odometry (x, y, yaw) per scan, on the host.
      points: ``f32[T, B, 2]`` scan points in the base frame.
      masks: ``bool[T, B]`` valid-beam masks.
    Returns:
      ``(final_state, estimates)``: an :class:`Estimate` whose pose and
      covariance are stacked to ``[T, ...]`` on the device and whose
      ``valid`` is a numpy ``bool[T]`` (the updates that passed the motion
      gate, a host decision).
    """
    dev = state.particles.log_weight.device
    odoms = torch.as_tensor(np.asarray(odoms_xyt, np.float32))
    points = torch.as_tensor(np.asarray(points, np.float32)).to(dev, non_blocking=True)
    masks = torch.as_tensor(np.asarray(masks, bool)).to(dev, non_blocking=True)
    poses, covs, valid = [], [], []
    for t in range(odoms.shape[0]):
        state, est = update(params, models, ctx, state, SE2.from_xytheta(odoms[t]), points[t],
                            masks[t])
        poses.append(est.pose)
        covs.append(est.covariance)
        valid.append(est.valid)
    pose = SE2(torch.stack([p.xy for p in poses]), SO2(torch.stack([p.rot.z for p in poses])))
    return state, Estimate(pose, torch.stack(covs), np.asarray(valid, bool))


def replay(update_fn: Callable, state, trajectory: np.ndarray, simulator: ScanSimulator,
           noise_sigma: float = 0.01, seed: int = 1):
    """Replay a trajectory through a filter with perfect odometry (the
    control equals the ground-truth pose, as in the perfect_odometry bag).

    ``update_fn(state, odom_pose, points, mask) -> (state, Estimate)``; the
    scans' noise comes from a ``torch.Generator`` seeded with ``seed`` on
    the grid's device.  Returns the final state and the list of
    ``((x, y, yaw), Estimate)``."""
    generator = torch.Generator(device=simulator.grid.device)
    generator.manual_seed(seed)
    results = []
    for x, y, yaw in trajectory:
        pose = SE2.from_xytheta(float(x), float(y), float(yaw))
        pts, mask = simulator.scan(pose, generator, noise_sigma)
        state, est = update_fn(state, pose, pts, mask)
        results.append(((x, y, yaw), est))
    return state, results

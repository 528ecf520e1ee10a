"""Stream-driven 2D localization node (port of ``beluga_tpu/node.py``,
the beluga_amcl ``AmclNode`` equivalent).

The same behaviour as a plain object driven by explicit calls:

  * ``set_map`` — (re)build the sensor model, keeping the last estimate
    across map swaps (amcl_node.cpp:435-497)
  * ``set_initial_pose`` — Gaussian (re)initialization (amcl_node.cpp:682-706)
  * ``global_localization`` — uniform over free space (amcl_node.cpp:662-667)
  * ``request_nomotion_update`` — force an update (amcl_node.cpp:669-680)
  * ``handle_scan`` — one filter update from (odom pose, scan points),
    returning the estimate and the map→odom correction (amcl_node.cpp:581-647)
  * ``handle_laser_scan`` / ``handle_point_cloud`` — the same from a raw
    ``sensor_msgs/LaserScan`` or ``PointCloud2`` (the adapters of
    beluga_ros/laser_scan.hpp and beluga_ros/src/amcl.cpp:54-80), through
    ``prepare_scan`` / ``prepare_point_cloud``
  * ``pipelined=True`` and ``flush`` — each scan returns the previous
    scan's estimate, so the host's next scan overlaps the card's update.

The node runs on the card unless it is given ``device="cpu"``.  Each scan
costs one host-to-device copy of the packed input and one device-to-host
copy of the packed estimate (:class:`ScanStaging`, pinned buffers and an
event on the card); nothing else is read back.  All three laser models of
nav2 are ported: the likelihood field, its probability model
(``laser_model_type="likelihood_field_prob"``, kernel B1-log) and the beam
model (``"beam"``, each of its four ``beam_fast_path`` modes).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.core.random import sample_normal_se2, sample_uniform_free_cells
from beluga_tpu_torch.filters import amcl as amcl_filter
from beluga_tpu_torch.filters.builders import make_beam_filter, make_likelihood_field_filter
from beluga_tpu_torch.io import native
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lifecycle import BaseLifecycleNode
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OccupancyGrid

# -- packed per-scan IO (SE2 nodes) -------------------------------------------
# The input is one f32 vector [odom x, y, yaw | points flat | mask]; the
# estimate comes back as one f32[13].
EST2_POSE = slice(0, 3)  # x, y, yaw
EST2_COV = slice(3, 12)  # 3x3 row-major
EST2_VALID = 12
EST2_LEN = 13


def pack_scan_input(odom_pose_xytheta, points, point_mask=None) -> np.ndarray:
    """Host-side build of the packed step input.  Raises unless ``points``
    is ``[P, 2]`` and the mask has P entries; either mismatch would
    otherwise re-partition the vector into wrong points and mask."""
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points must be shaped [P, 2], got {list(pts.shape)}")
    mask = (
        np.ones(pts.shape[0], np.float32)
        if point_mask is None
        else np.asarray(point_mask, np.float32)
    )
    if mask.shape != (pts.shape[0],):
        raise ValueError(
            f"point_mask shape {list(mask.shape)} != point count {pts.shape[0]}"
        )
    return np.concatenate(
        [np.asarray(odom_pose_xytheta, np.float32).reshape(3), pts.ravel(), mask]
    )


def make_packed_step_se2(params, models, device):
    """The packed-IO update for SE2 nodes: ``step(ctx, state, packed) ->
    (state, f32[13] estimate on the device)``.  ``packed`` is a numpy
    vector or a host tensor (the node's staging buffer, pinned on the
    card); the points and mask go to the device in one non-blocking copy,
    the odometry stays on the host."""
    device = torch.device(device)

    def packed_step(ctx, state, packed):
        host = packed if isinstance(packed, torch.Tensor) else torch.from_numpy(packed)
        beams = (host.shape[0] - 3) // 3
        odom = SE2.from_xytheta(host[0:3])
        scan = host[3:].to(device, non_blocking=True, copy=True)
        pts = scan[: 2 * beams].reshape(beams, 2)
        mask = scan[2 * beams :] > 0.5
        state, est = amcl_filter.update(params, models, ctx, state, odom, pts, mask)
        z = est.pose.rot.z
        out = torch.cat([
            est.pose.xy,
            torch.atan2(z[1], z[0])[None],
            est.covariance.reshape(-1),
            torch.full((1,), float(est.valid), dtype=torch.float32, device=z.device),
        ])
        return state, out

    return packed_step


class ScanStaging:
    """The node's per-scan host buffers: two for the packed input and two
    for the packed estimate, used in turn (scan t takes slot t mod 2).

    On the card the buffers are pinned: the input goes to the device by a
    non-blocking copy, the estimate comes back by a non-blocking copy into
    its output buffer, and an event is recorded after it.  Reading an
    estimate (:meth:`harvest`) waits on that scan's event only, never on
    the stream or the device.  On the CPU there is no pinning and no event;
    the logic is the same.

    Invariant that makes the reuse safe: slot t mod 2 is written again at
    scan t + 2, and by then scan t's event has been waited on (at scan t in
    the synchronous mode, at scan t + 1 in the pipelined one), so both of
    scan t's copies are done.  :meth:`stage` checks it and raises rather
    than overwrite a buffer whose copies may still be in flight.
    """

    def __init__(self, length: int, device: torch.device):
        self.pin = device.type == "cuda"
        self.resize(length)
        self.outputs = [torch.empty(EST2_LEN, dtype=torch.float32, pin_memory=self.pin)
                        for _ in range(2)]
        self.events = [torch.cuda.Event() if self.pin else None for _ in range(2)]
        self.in_flight = [False, False]  # recorded and not yet waited on
        self.count = 0

    @property
    def length(self) -> int:
        return self.inputs[0].shape[0]

    def resize(self, length: int) -> None:
        """New input buffers for a new beam capacity.  The old ones may
        still feed an in-flight copy; PyTorch's pinned allocator keeps such
        a block until the copy is done."""
        self.inputs = [torch.empty(length, dtype=torch.float32, pin_memory=self.pin)
                       for _ in range(2)]

    def stage(self, packed: np.ndarray) -> tuple[int, torch.Tensor]:
        """Write scan ``count``'s packed input into its slot; returns the
        slot and the host buffer for the packed step."""
        slot = self.count % 2
        if self.in_flight[slot]:
            raise RuntimeError(
                f"staging slot {slot} reused before scan {self.count - 2}'s event was waited on")
        self.inputs[slot].numpy()[:] = packed
        return slot, self.inputs[slot]

    def finish(self, slot: int, est: torch.Tensor) -> None:
        """Queue the estimate's copy into the slot's output buffer and
        record the slot's event after it."""
        self.outputs[slot].copy_(est, non_blocking=True)
        if self.events[slot] is not None:
            self.events[slot].record()
        self.in_flight[slot] = True
        self.count += 1

    def harvest(self, slot: int) -> np.ndarray:
        """The slot's estimate, after waiting on its event."""
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        self.in_flight[slot] = False
        return self.outputs[slot].numpy().copy()


@dataclasses.dataclass
class ScanResult:
    valid: bool
    pose: np.ndarray | None  # (x, y, yaw) map-frame estimate
    covariance: np.ndarray | None  # 3x3
    map_to_odom: np.ndarray | None  # (x, y, yaw) correction transform
    latency_s: float


class AmclNode(BaseLifecycleNode):
    """2D AMCL node over occupancy-grid maps (managed lifecycle)."""

    def __init__(self, config: AmclNodeConfig | None = None, seed: int = 0,
                 device=None, verbose: bool = False, autostart: bool = True,
                 pipelined: bool = False):
        """``device`` defaults to ``"cuda"`` and raises when CUDA is absent.

        ``pipelined=True`` defers each estimate's readback by one scan:
        ``handle_scan`` queues scan t's update and returns scan t-1's
        estimate, which the card computed while the host prepared scan t.
        The first call returns an invalid result, each result carries its
        own scan's odometry for the map→odom correction, and :meth:`flush`
        returns the last scan's.  The reference node publishes
        synchronously (amcl_node.cpp:581-647), the default here too."""
        self.config = config or AmclNodeConfig()
        self.device = resolve_device(device)
        self.verbose = verbose
        self.pipelined = pipelined
        self._seed = seed
        self.latest_viz: tuple[np.ndarray, np.ndarray] | None = None
        self.dropped_scans = 0
        self.last_known_estimate: tuple[np.ndarray, np.ndarray] | None = None
        self._reset_runtime()
        super().__init__(autostart=autostart)

    def _reset_runtime(self) -> None:
        self.params = self.config.amcl_params()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._seed)
        self._models = None
        self._ctx = None
        self._state = None
        self._grid: OccupancyGrid | None = None
        self._step = None
        self._first_map_set = False
        self._staging: ScanStaging | None = None
        self._pending = None  # (staging slot, odom (x, y, yaw)) of the scan in flight

    # -- lifecycle hooks (ros2_common.hpp do_* virtuals) --------------------

    def do_configure(self) -> None:
        self.params = self.config.amcl_params()

    def do_cleanup(self) -> None:
        # drop the filter and map but keep last_known_estimate: a later
        # configure + map re-initializes from it
        self._reset_runtime()

    def do_shutdown(self) -> None:
        self._reset_runtime()
        self.last_known_estimate = None

    def do_periodic_timer_callback(self) -> None:
        if self._state is not None:
            self.latest_viz = self.particle_cloud()

    # -- map handling (amcl_node.cpp:435-497) -------------------------------

    def set_map(self, grid: OccupancyGrid) -> None:
        if self._first_map_set and self.config.first_map_only:
            return
        cfg = self.config
        # the cluster estimate for every sensor model, as the reference node
        # (beluga_ros/amcl.hpp estimate())
        if cfg.laser_model_type == "beam":
            self._models, self._ctx = make_beam_filter(
                grid,
                cfg.beam_params(),
                motion_params=cfg.motion_params(),
                use_range_lut={"lut": True, "windowed": "windowed"}.get(cfg.beam_fast_path, False),
                use_sphere_trace=cfg.beam_fast_path == "sphere_trace",
                use_cluster_estimate=True,
                device=self.device,
            )
        else:
            self._models, self._ctx = make_likelihood_field_filter(
                grid,
                cfg.likelihood_field_params(),
                motion_params=cfg.motion_params(),
                prob_model=cfg.laser_model_type == "likelihood_field_prob",
                use_cluster_estimate=True,
                device=self.device,
            )
        self._grid = self._ctx["grid"]
        self._first_map_set = True
        if self._step is None:
            self._step = make_packed_step_se2(self.params, self._models, self.device)

        # a retained estimate takes precedence over the configured initial
        # pose unless always_reset_initial_pose (test_amcl_node.cpp:387-485)
        if cfg.set_initial_pose and cfg.always_reset_initial_pose:
            self.set_initial_pose(cfg.initial_pose_x, cfg.initial_pose_y,
                                  cfg.initial_pose_yaw, cfg.initial_pose_covariance())
        elif self.last_known_estimate is not None:
            pose, cov = self.last_known_estimate
            self.set_initial_pose(pose[0], pose[1], pose[2], cov)
        elif cfg.set_initial_pose and self._state is None:
            self.set_initial_pose(cfg.initial_pose_x, cfg.initial_pose_y,
                                  cfg.initial_pose_yaw, cfg.initial_pose_covariance())
        elif self._state is None:
            self.global_localization()

    # -- initialization (amcl_node.cpp:662-706) -----------------------------

    def set_initial_pose(self, x, y, yaw, covariance=None) -> None:
        if covariance is None:
            covariance = self.config.initial_pose_covariance()
        states = sample_normal_se2(
            self._generator, self.params.max_particles,
            amcl_filter.host_pose(x, y, yaw), covariance,
        )
        self._replace_particles(states)

    def global_localization(self) -> None:
        """Reinitialize uniformly over the map's free space."""
        if self._grid is None:
            raise RuntimeError("set_map first")
        states = sample_uniform_free_cells(
            self._generator, self.params.max_particles, self._grid.free_xy,
            self._grid.num_free,
        )
        self._replace_particles(states)

    def _replace_particles(self, states) -> None:
        if self._state is None:
            self._state = amcl_filter.init_state(
                self._generator, states, self.params, self.device
            )
        else:
            self._state = amcl_filter.reinit_particles(self._state, states)

    def request_nomotion_update(self) -> None:
        """Force the next update even without motion (amcl_node.cpp:669-680)."""
        if self._state is not None:
            self._state = self._state._replace(force_update=True)

    # -- scan handling (amcl_node.cpp:581-647) ------------------------------

    def handle_scan(self, odom_pose_xytheta, points, point_mask=None) -> ScanResult:
        """Process one scan.

        Args:
          odom_pose_xytheta: base pose in the odom frame, (x, y, yaw).
          points: ``f32[B, 2]`` scan points in the base frame.
          point_mask: ``bool[B]`` valid-beam mask (default all valid).

        In the pipelined mode the result is the previous scan's (invalid on
        the first call).
        """
        if not self.is_active:
            # scans are only subscribed while ACTIVE in the reference
            self.dropped_scans += 1
            return ScanResult(False, None, None, None, 0.0)
        if self._state is None:
            raise RuntimeError("node not initialized (set_map first)")
        t0 = time.perf_counter()
        packed = pack_scan_input(odom_pose_xytheta, points, point_mask)
        if self._staging is None:
            self._staging = ScanStaging(packed.shape[0], self.device)
        elif self._staging.length != packed.shape[0]:
            self._staging.resize(packed.shape[0])  # a new beam capacity
        slot, host = self._staging.stage(packed)
        self._state, est = self._step(self._ctx, self._state, host)
        self._staging.finish(slot, est)
        if self.pipelined:
            # queue this scan, return the previous one's estimate
            prev, self._pending = self._pending, (slot, odom_pose_xytheta)
            if prev is None:
                return ScanResult(False, None, None, None, time.perf_counter() - t0)
            prev_slot, prev_odom = prev
            return self._finalize(self._staging.harvest(prev_slot), prev_odom, t0, packed)
        return self._finalize(self._staging.harvest(slot), odom_pose_xytheta, t0, packed)

    def flush(self) -> ScanResult | None:
        """The estimate of the scan still in flight (pipelined mode), or
        None when there is none."""
        if self._pending is None:
            return None
        t0 = time.perf_counter()
        (slot, odom), self._pending = self._pending, None
        return self._finalize(self._staging.harvest(slot), odom, t0, None)

    def _finalize(self, est_vec, odom_pose_xytheta, t0, packed) -> ScanResult:
        latency = time.perf_counter() - t0
        if not est_vec[EST2_VALID] > 0.5:
            return ScanResult(False, None, None, None, latency)
        pose = np.asarray(est_vec[EST2_POSE], np.float64)
        cov = np.asarray(est_vec[EST2_COV], np.float64).reshape(3, 3)
        self.last_known_estimate = (pose, cov)
        if self.verbose and packed is not None:
            n = int(self._state.particles.active)
            b = int(packed[3 + 2 * ((packed.shape[0] - 3) // 3):].sum())
            print(f"[amcl] {n} particles {b} points - {latency*1e3:.3f}ms")

        # map->odom correction: T_map_odom = T_map_base * T_odom_base^-1
        # (amcl_node.cpp:624-636)
        c, s = np.cos(pose[2]), np.sin(pose[2])
        oc, os_ = np.cos(odom_pose_xytheta[2]), np.sin(odom_pose_xytheta[2])
        inv_t = -np.array([[oc, os_], [-os_, oc]]) @ np.asarray(odom_pose_xytheta[:2])
        inv_yaw = -odom_pose_xytheta[2]
        mx = pose[0] + (c * inv_t[0] - s * inv_t[1])
        my = pose[1] + (s * inv_t[0] + c * inv_t[1])
        myaw = np.arctan2(np.sin(pose[2] + inv_yaw), np.cos(pose[2] + inv_yaw))
        return ScanResult(True, pose, cov, np.array([mx, my, myaw]), latency)

    # -- raw sensor input (beluga_ros adapters, amcl_node.cpp:236-239, 537-551)

    def handle_laser_scan(self, odom_pose_xytheta, ranges, angle_min: float,
                          angle_increment: float, range_min: float | None = None,
                          range_max: float | None = None,
                          sensor_pose=(0.0, 0.0, 0.0)) -> ScanResult:
        """Process a raw laser scan (the ``sensor_msgs/LaserScan`` path):
        :meth:`prepare_scan`, then :meth:`handle_scan`."""
        pts, mask = self.prepare_scan(ranges, angle_min, angle_increment, range_min,
                                      range_max, sensor_pose)
        return self.handle_scan(odom_pose_xytheta, pts, mask)

    def handle_point_cloud(self, odom_pose_xytheta, points_xyz, sensor_pose=(0.0, 0.0, 0.0),
                           max_beams: int | None = None) -> ScanResult:
        """Process a 3D point cloud through the 2D filter (the reference
        node's ``sensor_msgs/PointCloud2`` alternative to laser scans,
        amcl_node.cpp:236-239, flattened to base-frame (x, y) pairs as
        beluga_ros/src/amcl.cpp:64-80 does): :meth:`prepare_point_cloud`,
        then :meth:`handle_scan`.  ``points_xyz`` is ``[P, 3]`` (or
        ``[P, 2]``) in the sensor frame, e.g. from
        ``io.native.decode_pointcloud2_cdr``.

        Capacity: non-finite points are masked and the cloud is decimated
        evenly to ``config.max_beams`` slots, so a cloud wider than that
        loses points against the reference adapters, which feed every point
        to the sensor model.  ``max_beams`` overrides the capacity for the
        call (e.g. the bag's widest cloud, which
        ``io.rosbag.read_bag_cloud_stream`` reports); a new capacity
        re-sizes the node's staging buffers.
        """
        pts, mask = self.prepare_point_cloud(points_xyz, sensor_pose, max_beams=max_beams)
        return self.handle_scan(odom_pose_xytheta, pts, mask)

    def prepare_point_cloud(self, points_xyz, sensor_pose=(0.0, 0.0, 0.0),
                            max_beams: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """The point-cloud adapter's work alone: the planar projection,
        the sensor-frame transform, the finiteness mask and the even
        decimation, padded to the beam capacity."""
        cap = self.config.max_beams if max_beams is None else int(max_beams)
        p = np.asarray(points_xyz, np.float32)
        ok = np.isfinite(p[:, :2]).all(axis=-1)
        sx, sy, syaw = (float(v) for v in sensor_pose)
        c, s = np.cos(syaw), np.sin(syaw)
        with np.errstate(invalid="ignore"):  # inf * 0 in masked points
            bx = c * p[:, 0] - s * p[:, 1] + sx
            by = s * p[:, 0] + c * p[:, 1] + sy
        full = np.where(ok[:, None], np.stack([bx, by], -1), 0.0).astype(np.float32)
        idx = native.take_evenly_indices(len(p), cap)
        pts = np.zeros((cap, 2), np.float32)
        mask = np.zeros(cap, bool)
        pts[: len(idx)] = full[idx]
        mask[: len(idx)] = ok[idx]
        return pts, mask

    def prepare_scan(self, ranges, angle_min: float, angle_increment: float,
                     range_min: float | None = None, range_max: float | None = None,
                     sensor_pose=(0.0, 0.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
        """The laser-scan adapter's work alone: polar to cartesian, the
        sensor-frame transform, range filtering and the even decimation to
        ``max_beams`` (beluga_ros/laser_scan.hpp, amcl_node.cpp:537-551),
        padded to the beam capacity.  Shared by :meth:`handle_laser_scan`
        and the scan-driven replay (``tools/localize.py``)."""
        cfg = self.config
        range_min = cfg.laser_min_range if range_min is None else range_min
        range_max = min(cfg.laser_max_range, 1e9) if range_max is None else range_max
        ranges = np.asarray(ranges, np.float32)
        pts_full, mask_full = native.scan_to_points(ranges, angle_min, angle_increment,
                                                    range_min, range_max, sensor_pose)
        idx = native.take_evenly_indices(len(ranges), cfg.max_beams)
        # pad a scan with fewer beams than max_beams: the capacity stays
        pts = np.zeros((cfg.max_beams, 2), np.float32)
        mask = np.zeros(cfg.max_beams, bool)
        pts[: len(idx)] = pts_full[idx]
        mask[: len(idx)] = mask_full[idx]
        return pts, mask

    # -- introspection (particle_cloud publishers analog) -------------------

    def particle_cloud(self) -> tuple[np.ndarray, np.ndarray]:
        """(poses [n, 3], weights [n]) of the alive particles."""
        if self._state is None:
            raise RuntimeError("node not initialized (set_map first)")
        p = self._state.particles
        n = int(p.active)
        xyt = torch.cat([p.state.xy, p.state.theta[:, None]], dim=-1)
        return xyt.cpu().numpy()[:n], p.weight.cpu().numpy()[:n]

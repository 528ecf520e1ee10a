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

The node runs on the card unless it is given ``device="cpu"``.  Each scan
costs one host-to-device copy of the points and one device-to-host copy
of the packed estimate; nothing else is read back.  All three laser models
of nav2 are ported: the likelihood field, its probability model
(``laser_model_type="likelihood_field_prob"``, kernel B1-log) and the beam
model (``"beam"``, each of its four ``beam_fast_path`` modes); the raw
laser-scan and point-cloud adapters and the pipelined mode wait for a later
slice (ROADMAP A13).
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
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lifecycle import BaseLifecycleNode
from beluga_tpu_torch.lie import SE2, SO2
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
    (state, f32[13] estimate on the device)``."""
    device = torch.device(device)

    def packed_step(ctx, state, packed: np.ndarray):
        beams = (packed.shape[0] - 3) // 3
        host = torch.from_numpy(packed)
        yaw = host[2]
        odom = SE2(host[0:2], SO2(torch.stack([torch.cos(yaw), torch.sin(yaw)])))
        scan = host[3:].to(device, non_blocking=True)
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
                 device=None, verbose: bool = False, autostart: bool = True):
        """``device`` defaults to ``"cuda"`` and raises when CUDA is absent."""
        self.config = config or AmclNodeConfig()
        self.device = resolve_device(device)
        self.verbose = verbose
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
        """
        if not self.is_active:
            # scans are only subscribed while ACTIVE in the reference
            self.dropped_scans += 1
            return ScanResult(False, None, None, None, 0.0)
        if self._state is None:
            raise RuntimeError("node not initialized (set_map first)")
        t0 = time.perf_counter()
        packed = pack_scan_input(odom_pose_xytheta, points, point_mask)
        self._state, est = self._step(self._ctx, self._state, packed)
        est = est.cpu().numpy()  # the one readback per scan
        return self._finalize(est, odom_pose_xytheta, t0, packed)

    def _finalize(self, est_vec, odom_pose_xytheta, t0, packed) -> ScanResult:
        latency = time.perf_counter() - t0
        if not est_vec[EST2_VALID] > 0.5:
            return ScanResult(False, None, None, None, latency)
        pose = np.asarray(est_vec[EST2_POSE], np.float64)
        cov = np.asarray(est_vec[EST2_COV], np.float64).reshape(3, 3)
        self.last_known_estimate = (pose, cov)
        if self.verbose:
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

    # -- introspection (particle_cloud publishers analog) -------------------

    def particle_cloud(self) -> tuple[np.ndarray, np.ndarray]:
        """(poses [n, 3], weights [n]) of the alive particles."""
        if self._state is None:
            raise RuntimeError("node not initialized (set_map first)")
        p = self._state.particles
        n = int(p.active)
        xyt = torch.cat([p.state.xy, p.state.theta[:, None]], dim=-1)
        return xyt.cpu().numpy()[:n], p.weight.cpu().numpy()[:n]

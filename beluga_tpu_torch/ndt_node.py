"""Stream-driven NDT AMCL nodes (port of ``beluga_tpu/ndt_node.py``; the
``NdtAmclNode`` and ``NdtAmclNode3D`` equivalents).

Middleware-free counterparts of beluga_amcl/src/ndt_amcl_node.cpp and
ndt_amcl_node_3d.cpp: HDF5 map loading, pose initialization, one update
per 2D or 3D point cloud, and the estimate kept across cleanup and a new
map.  The core update with the plain estimate and the estimate-based
Gaussian recovery, as the reference NDT nodes.

The nodes run on the card unless they are given ``device="cpu"``.  Each
cloud costs one host-to-device copy of the points and one device-to-host
copy of the packed estimate.  Where the reference packs points without
checking their shape, the 2D node raises unless they are ``[P, 2]``
(through ``node.py:pack_scan_input``) and the 3D node unless they are
``[P, 3]``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.core.random import sample_normal_se2, sample_normal_se3
from beluga_tpu_torch.filters import amcl as amcl_filter
from beluga_tpu_torch.filters.ndt_builders import (
    DEFAULT_NDT_PARAMS,
    make_ndt_filter_2d,
    make_ndt_filter_3d,
)
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE3, SO3
from beluga_tpu_torch.lifecycle import BaseLifecycleNode
from beluga_tpu_torch.maps.ndt import NdtMap, load_ndt_hdf5
from beluga_tpu_torch.models.sensor.ndt import NdtModelParams
from beluga_tpu_torch.node import (
    EST2_COV,
    EST2_POSE,
    EST2_VALID,
    ScanResult,
    make_packed_step_se2,
    pack_scan_input,
)

# SE3 packed estimate: x, y, z, roll, pitch, yaw | 6x6 row-major | valid
EST3_POSE = slice(0, 6)
EST3_COV = slice(6, 42)
EST3_VALID = 42
EST3_LEN = 43
# the reference 3D node's default initial covariance (ndt_node.py:198-201)
INITIAL_COV_3D = np.diag([0.25, 0.25, 0.25, 0.0685, 0.0685, 0.0685]).astype(np.float32)


def pack_cloud_input(odom_pose, points, point_mask=None) -> np.ndarray:
    """Host-side build of the 3D packed input ``[x, y, z, roll, pitch, yaw |
    points flat | mask]``.  Raises unless ``points`` is ``[P, 3]`` and the
    mask has P entries."""
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be shaped [P, 3], got {list(pts.shape)}")
    mask = (np.ones(pts.shape[0], np.float32) if point_mask is None
            else np.asarray(point_mask, np.float32))
    if mask.shape != (pts.shape[0],):
        raise ValueError(f"point_mask shape {list(mask.shape)} != point count {pts.shape[0]}")
    return np.concatenate([np.asarray(odom_pose, np.float32).reshape(6), pts.ravel(), mask])


def make_packed_step_se3(params, models, device):
    """The packed-IO update of the 3D node: ``step(ctx, state, packed) ->
    (state, f32[43] estimate on the device)``; the odometry stays on the
    host."""
    device = torch.device(device)

    def packed_step(ctx, state, packed: np.ndarray):
        n = (packed.shape[0] - 6) // 4
        host = torch.from_numpy(packed)
        odom = SE3(host[0:3], SO3.from_rpy(host[3], host[4], host[5]))
        cloud = host[6:].to(device, non_blocking=True)
        pts = cloud[: 3 * n].reshape(n, 3)
        mask = cloud[3 * n:] > 0.5
        state, est = amcl_filter.update(params, models, ctx, state, odom, pts, mask)
        roll, pitch, yaw = est.pose.rot.rpy()
        out = torch.cat([
            est.pose.xyz, torch.stack([roll, pitch, yaw]), est.covariance.reshape(-1),
            torch.full((1,), float(est.valid), dtype=torch.float32, device=est.pose.xyz.device),
        ])
        return state, out

    return packed_step


class NdtAmclNode(BaseLifecycleNode):
    """2D NDT AMCL over SE2 states; measurements are 2D point clouds
    (managed lifecycle, lifecycle.py)."""

    dim = 2

    def __init__(self, config: AmclNodeConfig | None = None,
                 ndt_params: NdtModelParams = DEFAULT_NDT_PARAMS, seed: int = 0,
                 device=None, autostart: bool = True):
        """``device`` defaults to ``"cuda"`` and raises when CUDA is absent."""
        self.config = config or AmclNodeConfig()
        self.ndt_params = ndt_params
        self.device = resolve_device(device)
        self._seed = seed
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
        self._step = None

    def do_configure(self) -> None:
        self.params = self.config.amcl_params()

    def do_cleanup(self) -> None:
        # keep last_known_estimate across cleanup -> configure -> a new map
        self._reset_runtime()

    def do_shutdown(self) -> None:
        self._reset_runtime()
        self.last_known_estimate = None

    def set_map_path(self, hdf5_path: str) -> None:
        self.set_map(load_ndt_hdf5(hdf5_path, self.device))

    def set_map(self, ndt_map: NdtMap) -> None:
        if ndt_map.dim != self.dim:
            raise ValueError(f"expected a {self.dim}D NDT map, got {ndt_map.dim}D")
        self._models, self._ctx = self._build(ndt_map.to(self.device))
        self._step = self._make_packed_step()
        if self._state is None:
            if self.last_known_estimate is not None:
                self._initialize_from_estimate(*self.last_known_estimate)
            else:
                self.set_initial_pose()

    def _build(self, ndt_map: NdtMap):
        return make_ndt_filter_2d(ndt_map, self.ndt_params, self.config.motion_params())

    def _make_packed_step(self):
        return make_packed_step_se2(self.params, self._models, self.device)

    # -- initialization ------------------------------------------------------

    def set_initial_pose(self, x=None, y=None, yaw=None, covariance=None) -> None:
        cfg = self.config
        x = cfg.initial_pose_x if x is None else x
        y = cfg.initial_pose_y if y is None else y
        yaw = cfg.initial_pose_yaw if yaw is None else yaw
        if covariance is None:
            covariance = cfg.initial_pose_covariance()
        states = sample_normal_se2(self._generator, self.params.max_particles,
                                   amcl_filter.host_pose(x, y, yaw), covariance)
        self._replace(states, None)

    def _replace(self, states, odom_identity) -> None:
        if self._state is None:
            self._state = amcl_filter.init_state(self._generator, states, self.params,
                                                 self.device, odom_identity=odom_identity)
        else:
            self._state = amcl_filter.reinit_particles(self._state, states)

    def _initialize_from_estimate(self, pose, covariance) -> None:
        # the retained estimate vector: (x, y, yaw) here, the 6-vector in 3D
        self.set_initial_pose(pose[0], pose[1], pose[2], covariance)

    def request_nomotion_update(self) -> None:
        if self._state is not None:
            self._state = self._state._replace(force_update=True)

    # -- updates -------------------------------------------------------------

    def _pack(self, odom_pose, points, point_mask) -> np.ndarray:
        return pack_scan_input(odom_pose, points, point_mask)

    def _unpack(self, est: np.ndarray):
        if not est[EST2_VALID] > 0.5:
            return None
        return (np.asarray(est[EST2_POSE], np.float64),
                np.asarray(est[EST2_COV], np.float64).reshape(3, 3))

    def handle_point_cloud(self, odom_pose, points, point_mask=None) -> ScanResult:
        """One update from the odometry pose ((x, y, yaw); (x, y, z, roll,
        pitch, yaw) in 3D) and a point cloud ``[P, 2]`` (``[P, 3]`` in 3D)
        in the base frame.  Clouds that arrive while the node is not active
        are dropped, as the reference subscribes only while ACTIVE."""
        if not self.is_active:
            return ScanResult(False, None, None, None, 0.0)
        if self._state is None:
            raise RuntimeError("node not initialized (set_map first)")
        t0 = time.perf_counter()
        packed = self._pack(odom_pose, points, point_mask)
        self._state, est = self._step(self._ctx, self._state, packed)
        out = self._unpack(est.cpu().numpy())  # the one readback per cloud
        latency = time.perf_counter() - t0
        if out is None:
            return ScanResult(False, None, None, None, latency)
        self.last_known_estimate = out
        return ScanResult(True, out[0], out[1], None, latency)


class NdtAmclNode3D(NdtAmclNode):
    """3D NDT AMCL over SE3 states (ndt_amcl_node_3d.cpp equivalent)."""

    dim = 3

    def _build(self, ndt_map: NdtMap):
        return make_ndt_filter_3d(ndt_map, self.ndt_params, self.config.motion_params())

    def _make_packed_step(self):
        return make_packed_step_se3(self.params, self._models, self.device)

    def set_initial_pose(self, xyz=(0.0, 0.0, 0.0), rpy=(0.0, 0.0, 0.0),
                         covariance=None) -> None:
        cov = INITIAL_COV_3D if covariance is None else covariance
        mean = SE3.from_xyzrpy(xyz, rpy, device="cpu")
        states = sample_normal_se3(self._generator, self.params.max_particles, mean, cov)
        self._replace(states, SE3.identity())

    def _initialize_from_estimate(self, pose, covariance) -> None:
        # the retained 3D estimate vector is (x, y, z, roll, pitch, yaw)
        self.set_initial_pose(pose[:3], pose[3:6], covariance)

    def _pack(self, odom_pose, points, point_mask) -> np.ndarray:
        return pack_cloud_input(odom_pose, points, point_mask)

    def _unpack(self, est: np.ndarray):
        if not est[EST3_VALID] > 0.5:
            return None
        return (np.asarray(est[EST3_POSE], np.float64),
                np.asarray(est[EST3_COV], np.float64).reshape(6, 6))

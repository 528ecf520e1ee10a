"""nav2/beluga-parity node configuration (port of
``beluga_tpu/io/config.py``).

The parameter names, defaults and ranges are nav2_amcl's
(ros2_common.cpp:36-374, amcl_node.cpp:88-204); invalid values are rejected
when set.  YAML profiles use the ``<node>: ros__parameters:`` layout, and
``yaml`` is imported only when one is loaded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from beluga_tpu_torch.filters.amcl import AmclParams
from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
from beluga_tpu_torch.models.motion.omnidirectional import OmnidirectionalDriveParams
from beluga_tpu_torch.models.sensor.beam import BeamModelParams
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams

MOTION_MODELS = {
    # names accepted by get_motion_model (amcl_node.cpp:350-372)
    "nav2_amcl::DifferentialMotionModel": "differential_drive",
    "differential_drive": "differential_drive",
    "nav2_amcl::OmniMotionModel": "omnidirectional_drive",
    "omnidirectional_drive": "omnidirectional_drive",
    "stationary": "stationary",
}

SENSOR_MODELS = ("likelihood_field", "likelihood_field_prob", "beam")


@dataclasses.dataclass
class AmclNodeConfig:
    """All nav2-parity parameters with the reference's defaults and ranges."""

    # -- filter (ros2_common.cpp) -------------------------------------------
    min_particles: int = 500
    max_particles: int = 2000
    pf_err: float = 0.05  # kld_epsilon
    pf_z: float = 3.0  # kld_z
    recovery_alpha_slow: float = 0.001
    recovery_alpha_fast: float = 0.1
    resample_interval: int = 1
    selective_resampling: bool = False
    update_min_a: float = 0.2
    update_min_d: float = 0.25
    spatial_resolution_x: float = 0.5
    spatial_resolution_y: float = 0.5
    spatial_resolution_theta: float = 10.0 * math.pi / 180.0
    execution_policy: str = "seq"  # accepted for parity

    # -- motion model --------------------------------------------------------
    robot_model_type: str = "nav2_amcl::DifferentialMotionModel"
    alpha1: float = 0.1
    alpha2: float = 0.05
    alpha3: float = 0.1
    alpha4: float = 0.05
    alpha5: float = 0.1

    # -- sensor model (amcl_node.cpp:88-204) --------------------------------
    laser_model_type: str = "likelihood_field"
    laser_likelihood_max_dist: float = 2.0
    laser_max_range: float = 100.0
    laser_min_range: float = 0.0
    max_beams: int = 60
    z_hit: float = 0.5
    z_rand: float = 0.5
    z_short: float = 0.05
    z_max: float = 0.05
    sigma_hit: float = 0.2
    lambda_short: float = 0.1
    model_unknown_space: bool = False
    only_obstacle_boundaries: bool = False
    beam_fast_path: str = "exact"  # beam-model option of the JAX package

    # -- initial pose --------------------------------------------------------
    set_initial_pose: bool = False
    always_reset_initial_pose: bool = False
    first_map_only: bool = False
    initial_pose_x: float = 0.0
    initial_pose_y: float = 0.0
    initial_pose_yaw: float = 0.0
    initial_pose_covariance_x: float = 0.25
    initial_pose_covariance_y: float = 0.25
    initial_pose_covariance_yaw: float = 0.0685
    initial_pose_covariance_xy: float = 0.0
    initial_pose_covariance_xyaw: float = 0.0
    initial_pose_covariance_yyaw: float = 0.0

    # -- frames / topics (kept for interface parity; no ROS runtime) --------
    global_frame_id: str = "map"
    odom_frame_id: str = "odom"
    base_frame_id: str = "base_footprint"
    map_topic: str = "map"
    scan_topic: str = "scan"
    initial_pose_topic: str = "initialpose"
    transform_tolerance: float = 1.0
    tf_broadcast: bool = True

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Range checks mirroring the reference's parameter descriptors."""
        for p in ("max_particles", "pf_z", "resample_interval",
                  "spatial_resolution_x", "spatial_resolution_y",
                  "spatial_resolution_theta", "laser_likelihood_max_dist",
                  "laser_max_range", "max_beams", "sigma_hit", "transform_tolerance"):
            if getattr(self, p) <= 0:
                raise ValueError(f"{p} must be > 0")
        for p in ("min_particles", "pf_err", "recovery_alpha_slow",
                  "recovery_alpha_fast", "update_min_a", "update_min_d",
                  "alpha1", "alpha2", "alpha3", "alpha4", "alpha5",
                  "z_hit", "z_rand", "z_short", "z_max", "lambda_short",
                  "laser_min_range"):
            if getattr(self, p) < 0:
                raise ValueError(f"{p} must be >= 0")
        if self.min_particles > self.max_particles:
            raise ValueError("min_particles must be <= max_particles")
        if self.robot_model_type not in MOTION_MODELS:
            raise ValueError(f"invalid robot_model_type {self.robot_model_type!r}")
        if self.laser_model_type not in SENSOR_MODELS:
            raise ValueError(f"invalid laser_model_type {self.laser_model_type!r}")
        if self.beam_fast_path not in ("exact", "lut", "windowed", "sphere_trace"):
            raise ValueError(f"invalid beam_fast_path {self.beam_fast_path!r}")
        if self.execution_policy not in ("seq", "par"):
            raise ValueError(f"invalid execution_policy {self.execution_policy!r}")

    # -- conversions ---------------------------------------------------------

    def amcl_params(self) -> AmclParams:
        return AmclParams(
            update_min_d=self.update_min_d,
            update_min_a=self.update_min_a,
            resample_interval=self.resample_interval,
            selective_resampling=self.selective_resampling,
            min_particles=self.min_particles,
            max_particles=self.max_particles,
            alpha_slow=self.recovery_alpha_slow,
            alpha_fast=self.recovery_alpha_fast,
            kld_epsilon=self.pf_err,
            kld_z=self.pf_z,
            spatial_resolution_x=self.spatial_resolution_x,
            spatial_resolution_y=self.spatial_resolution_y,
            spatial_resolution_theta=self.spatial_resolution_theta,
        )

    def motion_params(self):
        """The motion model of ``robot_model_type`` (config.py:164-181):
        ``DifferentialDriveParams`` (alpha1-alpha4),
        ``OmnidirectionalDriveParams`` (alpha1-alpha5) or ``"stationary"``."""
        kind = MOTION_MODELS[self.robot_model_type]
        if kind == "differential_drive":
            return DifferentialDriveParams(
                rotation_noise_from_rotation=self.alpha1,
                rotation_noise_from_translation=self.alpha2,
                translation_noise_from_translation=self.alpha3,
                translation_noise_from_rotation=self.alpha4,
            )
        if kind == "omnidirectional_drive":
            return OmnidirectionalDriveParams(
                rotation_noise_from_rotation=self.alpha1,
                rotation_noise_from_translation=self.alpha2,
                translation_noise_from_translation=self.alpha3,
                translation_noise_from_rotation=self.alpha4,
                strafe_noise_from_translation=self.alpha5,
            )
        return "stationary"

    def likelihood_field_params(self) -> LikelihoodFieldParams:
        return LikelihoodFieldParams(
            max_obstacle_distance=self.laser_likelihood_max_dist,
            max_laser_distance=self.laser_max_range,
            z_hit=self.z_hit,
            z_random=self.z_rand,
            sigma_hit=self.sigma_hit,
            model_unknown_space=self.model_unknown_space,
            only_obstacle_boundaries=self.only_obstacle_boundaries,
        )

    def beam_params(self) -> BeamModelParams:
        return BeamModelParams(
            z_hit=self.z_hit,
            z_short=self.z_short,
            z_max=self.z_max,
            z_rand=self.z_rand,
            sigma_hit=self.sigma_hit,
            lambda_short=self.lambda_short,
            beam_max_range=self.laser_max_range,
        )

    def initial_pose_covariance(self) -> np.ndarray:
        c = np.zeros((3, 3), np.float64)
        c[0, 0] = self.initial_pose_covariance_x
        c[1, 1] = self.initial_pose_covariance_y
        c[2, 2] = self.initial_pose_covariance_yaw
        c[0, 1] = c[1, 0] = self.initial_pose_covariance_xy
        c[0, 2] = c[2, 0] = self.initial_pose_covariance_xyaw
        c[1, 2] = c[2, 1] = self.initial_pose_covariance_yyaw
        return c


_FIELD_NAMES = {f.name for f in dataclasses.fields(AmclNodeConfig)}


def _flatten_params(d: dict, prefix: str = "") -> dict:
    out: dict[str, Any] = {}
    for k, v in d.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, prefix=f"{name}_"))
        else:
            out[name.replace(".", "_")] = v
    return out


def load_config(yaml_path: str, node_name: str = "amcl") -> AmclNodeConfig:
    """Load a ROS 2 style YAML profile (``<node>: ros__parameters:``)."""
    import yaml

    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    params = raw.get(node_name, raw).get("ros__parameters", raw.get(node_name, raw))
    known = {k: v for k, v in _flatten_params(params).items() if k in _FIELD_NAMES}
    return AmclNodeConfig(**known)

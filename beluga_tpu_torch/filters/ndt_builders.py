"""NDT AMCL filters, 2D and 3D (port of
``beluga_tpu/filters/ndt_builders.py``; the NdtAmclNode and
NdtAmclNode3D wiring).

The core update (filters/amcl.py) with:

* the NDT sensor model over a sparse voxel map (models/sensor/ndt.py),
  whose stencil probe runs kernel B10 on the card for maps of more than
  256 rows;
* recovery states drawn from a Gaussian about the current estimate, with
  covariance ``cov + 1e-6·I``, as the reference NDT nodes do
  (ndt_amcl_node.cpp:248-254); a fleet draws each filter's about its own
  estimate;
* the plain (not clustered) estimate of ``beluga::Amcl``
  (amcl_core.hpp:200).

The 3D filter runs SE3 particles with the flattened-3D diff-drive, the SE3
spatial hash and estimate, and the SE3 on-motion gate.
"""

from __future__ import annotations

import torch

from beluga_tpu_torch.algorithms.estimation import estimate_se2_log, estimate_se3
from beluga_tpu_torch.core.random import normal_se2_from_draws, normal_se3_from_draws
from beluga_tpu_torch.filters.amcl import (
    AmclModels,
    AmclParams,
    default_estimate,
    default_hash_state,
    se3_motion_delta,
)
from beluga_tpu_torch.maps.ndt import NdtMap
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_propagate,
    diff_drive_propagate_3d,
)
from beluga_tpu_torch.models.sensor.ndt import (
    NdtModelParams,
    fit_measurement_cells,
    ndt_weights_2d,
    ndt_weights_3d,
)
from beluga_tpu_torch.ops.spatial_hash import spatial_hash_se3

Tensor = torch.Tensor

# the reference builders' default sensor parameters
DEFAULT_NDT_PARAMS = NdtModelParams(minimum_likelihood=1e-6)


def _eye(d: int, device) -> Tensor:
    return torch.eye(d, dtype=torch.float32, device=device)


def recovery_se2_from_draws(z: Tensor, particles):
    """Recovery states about each filter's estimate, a Gaussian of
    covariance ``cov + 1e-6·I`` (ndt_amcl_node.cpp:248-254,
    ndt_builders.py:65-68), from the standard normals ``z`` f32[..., n, 3]."""
    mean, cov = estimate_se2_log(particles.state, particles.log_weight, particles.active)
    return normal_se2_from_draws(z, mean, cov + 1e-6 * _eye(3, cov.device))


def recovery_se3_from_draws(z: Tensor, particles):
    """The SE3 recovery (ndt_builders.py:98-100) from the normals ``z``
    f32[..., n, 6]: ``cov + 1e-6·I`` about each filter's estimate."""
    mean, cov = estimate_se3(particles.state, particles.weight, particles.mask)
    return normal_se3_from_draws(z, mean, cov + 1e-6 * _eye(6, cov.device))


def se3_recovery(generator, n, particles):
    """``n`` SE3 recovery states per filter, the normals drawn from
    ``generator``."""
    lead = particles.active.shape
    z = torch.randn((*lead, n, 6), generator=generator, dtype=torch.float32,
                    device=particles.active.device)
    return recovery_se3_from_draws(z, particles)


def make_ndt_filter_2d(ndt_map: NdtMap, ndt_params: NdtModelParams = DEFAULT_NDT_PARAMS,
                       motion_params: DifferentialDriveParams = DifferentialDriveParams()):
    """2D NDT AMCL: SE2 states, a 2D point cloud a measurement, clustered
    into Gaussians on the device each update (ndt_sensor_model.hpp:218-224).
    Returns ``(models, ctx)``; the filter runs on the map's device."""

    def log_weight(ctx, states, points, point_mask):
        m: NdtMap = ctx["ndt_map"]
        means, covs, cmask = fit_measurement_cells(points, point_mask, m.resolution)
        return torch.log(ndt_weights_2d(ndt_params, m, states, means, covs, cmask))

    def random_state(ctx, generator, n, particles):
        lead = particles.active.shape
        z = torch.randn((*lead, n, 3), generator=generator, dtype=torch.float32,
                        device=particles.active.device)
        return recovery_se2_from_draws(z, particles)

    def propagate(ctx, z, states, pose, prev):
        return diff_drive_propagate(motion_params, z, states, pose, prev)

    models = AmclModels(propagate=propagate, log_weight=log_weight, random_state=random_state,
                        hash_state=default_hash_state, estimate=default_estimate)
    return models, {"ndt_map": ndt_map}


def se3_hash_state(params: AmclParams, states) -> Tensor:
    """KLD buckets of SE3 states on (x, y, z, roll, pitch, yaw), at the
    filter's x resolution and its theta resolution."""
    return spatial_hash_se3(states.xyz, states.rot.rpy(), params.spatial_resolution_x,
                            params.spatial_resolution_theta)


def se3_estimate(params: AmclParams, particles):
    del params
    return estimate_se3(particles.state, particles.weight, particles.mask)


def make_ndt_filter_3d(ndt_map: NdtMap, ndt_params: NdtModelParams = DEFAULT_NDT_PARAMS,
                       motion_params: DifferentialDriveParams = DifferentialDriveParams()):
    """3D NDT AMCL: SE3 states, a 3D point cloud a measurement
    (ndt_amcl_node_3d.cpp:398-420).  Returns ``(models, ctx)``; initialize
    its state with ``odom_identity=SE3.identity()``."""

    def log_weight(ctx, states, points, point_mask):
        m: NdtMap = ctx["ndt_map"]
        means, covs, cmask = fit_measurement_cells(points, point_mask, m.resolution)
        return torch.log(ndt_weights_3d(ndt_params, m, states, means, covs, cmask))

    def random_state(ctx, generator, n, particles):
        return se3_recovery(generator, n, particles)

    def propagate(ctx, z, states, pose, prev):
        return diff_drive_propagate_3d(motion_params, z, states, pose, prev)

    models = AmclModels(propagate=propagate, log_weight=log_weight, random_state=random_state,
                        hash_state=se3_hash_state, estimate=se3_estimate,
                        motion_delta=se3_motion_delta)
    return models, {"ndt_map": ndt_map}

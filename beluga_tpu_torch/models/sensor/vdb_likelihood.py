"""3D likelihood-field sensor model over a dense distance voxel grid
(port of ``beluga_tpu/models/sensor/vdb_likelihood.py``; the beluga_vdb
extension, vdb_likelihood_field_model.hpp:48-174).

Per measurement point: transform it into the world by the particle's pose,
read the distance-to-nearest-obstacle volume at the nearest voxel centre
(``background`` outside; through kernel B11 with a code table), and sum
``1 + Σ amplitude·exp(-d²/2σ²) + offset``.  SE2 states enter through the
planar embedding (the reference's ``To3d``), SE3 states as they are.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from beluga_tpu_torch.lie import SE2, SO3, to_3d
from beluga_tpu_torch.maps.voxel import DistanceGrid3

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class VdbLikelihoodFieldParams:
    """(vdb_likelihood_field_model.hpp:48-66)."""

    max_obstacle_distance: float = 100.0
    max_laser_distance: float = 2.0
    z_hit: float = 0.5
    z_random: float = 0.5
    sigma_hit: float = 0.2


def vdb_likelihood_weights(params: VdbLikelihoodFieldParams, grid: DistanceGrid3, states,
                           points: Tensor, point_mask: Tensor, codes_book=None) -> Tensor:
    """Per-particle weights ``1 + Σ_points (amp·exp(-d²/2σ²) + offset)``
    (vdb_likelihood_field_model.hpp:135-152), ``f32[..., N]`` for states
    ``[..., N]`` and ``points`` ``f32[..., P, 3]`` in the base frame (the
    reference applies the sensor origin first, hpp:136-141).  The
    constants round as the reference's float32 arithmetic does, and the
    division by ``2σ²`` is by a tensor."""
    f32 = np.float32
    amplitude = float(f32(params.z_hit) / (f32(params.sigma_hit)
                                           * np.sqrt(f32(2.0 * math.pi))))
    offset = params.z_random / params.max_laser_distance
    two_sq = torch.full((), 2.0 * params.sigma_hit * params.sigma_hit, dtype=torch.float32,
                        device=points.device)

    pose = to_3d(states) if isinstance(states, SE2) else states  # SE3 [..., N]
    rot = SO3(pose.rot.q[..., :, None, :])  # broadcast over the point axis
    pts_world = rot.act(points[..., None, :, :]) + pose.xyz[..., :, None, :]  # [..., N, P, 3]
    dist = grid.distance_at(pts_world, codes_book=codes_book)
    pz = amplitude * torch.exp(-torch.square(dist) / two_sq) + offset
    return 1.0 + torch.sum(torch.where(point_mask[..., None, :], pz, 0.0), dim=-1)


def vdb_likelihood_log_weights(params, grid, states, points, point_mask,
                               codes_book=None) -> Tensor:
    return torch.log(vdb_likelihood_weights(params, grid, states, points, point_mask,
                                            codes_book=codes_book))

"""Likelihood-field range-finder model (port of the AMCL-parity part of
``beluga_tpu/models/sensor/likelihood_field.py``).

* Field precompute (likelihood_field_model_base.hpp:130-185): exact EDT,
  optional unknown-space overlay, per-cell ``amplitude * exp(-d²/2σ²) +
  offset``.
* Weight (likelihood_field_model.hpp:68-91): per beam endpoint, transform
  into the field frame, read the nearest cell (``unknown_prob`` outside the
  map) and return ``1 + Σ pz³``.  The pz³ sum and the 1.0 seed are nav2
  parity quirks.  The port reads the field through its code table only
  (kernel B1); the float-table lookup modes, the probability model and the
  lowrank mode wait for ROADMAP item A11.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.ops.distance_transform import squared_distance_transform

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LikelihoodFieldParams:
    """nav2-parity parameters (likelihood_field_model_base.hpp:42-64)."""

    max_obstacle_distance: float = 100.0
    max_laser_distance: float = 2.0
    z_hit: float = 0.5
    z_random: float = 0.5
    sigma_hit: float = 0.2
    model_unknown_space: bool = False
    only_obstacle_boundaries: bool = False


@dataclasses.dataclass(frozen=True)
class LikelihoodField:
    """Precomputed likelihood field (the reference's ``ValueGrid2<float>``).

    ``resolution`` and ``unknown_prob`` are float32 values held as Python
    floats: the host knows them, and a kernel takes them as arguments."""

    values: Tensor  # f32[H, W]
    resolution: float
    world_to_field: SE2
    unknown_prob: float


def make_likelihood_field(params: LikelihoodFieldParams, grid: OccupancyGrid) -> LikelihoodField:
    """Port of likelihood_field_model_base.hpp:130-185 with the exact EDT.

    Every constant is rounded to float32 where the reference rounds it, so
    the field matches the reference up to the last-ulp differences of
    ``exp`` between libraries."""
    dev = grid.device
    f32 = torch.float32

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    two_squared_sigma = 2.0 * params.sigma_hit * params.sigma_hit
    amplitude = params.z_hit / (c(params.sigma_hit) * torch.sqrt(c(2.0 * math.pi)))
    offset = params.z_random / params.max_laser_distance

    obstacle = (
        grid.obstacle_edge_mask() if params.only_obstacle_boundaries else grid.obstacle_mask
    )
    d2 = squared_distance_transform(obstacle, grid.resolution, params.max_obstacle_distance)

    if params.model_unknown_space:
        # unknown cells read exactly 1/max_laser_distance
        # (likelihood_field_model_base.hpp:160-179)
        inverse_max_distance = 1.0 / params.max_laser_distance
        squared_background_distance = -c(two_squared_sigma) * torch.log(
            c(inverse_max_distance - offset) / amplitude
        )
        if params.only_obstacle_boundaries:
            effective_unknown = grid.unknown_mask | (
                grid.obstacle_mask & ~grid.obstacle_edge_mask()
            )
        else:
            effective_unknown = grid.unknown_mask
        bg = torch.minimum(
            torch.square(c(params.max_obstacle_distance)), squared_background_distance
        )
        d2 = torch.where(effective_unknown, bg, d2)

    values = amplitude * torch.exp(-d2 / c(two_squared_sigma)) + c(offset)
    return LikelihoodField(
        values=values,
        resolution=grid.resolution,
        world_to_field=grid.origin.inverse(),
        unknown_prob=float(torch.tensor(1.0 / params.max_laser_distance, dtype=f32)),
    )


def likelihood_field_weights_codebook(
    field: LikelihoodField,
    codes_book: tuple[Tensor, Tensor],
    states: SE2,
    points: Tensor,
    beam_mask: Tensor,
) -> Tensor:
    """AMCL-parity weights through the code table
    (likelihood_field.py:192-237): kernel B1 (ops/cuda_reweight.py) on a
    CUDA tensor, its plain version on a CPU tensor."""
    from beluga_tpu_torch.ops.cuda_reweight import fused_reweight

    codes, book = codes_book
    tf = field.world_to_field @ states
    return fused_reweight(
        codes, book, tf.x.contiguous(), tf.y.contiguous(),
        tf.rot.cos.contiguous(), tf.rot.sin.contiguous(),
        points, beam_mask, field.resolution, field.unknown_prob,
    )

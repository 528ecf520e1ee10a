"""Beam range-finder sensor model, Thrun table 6.2 (port of
``beluga_tpu/models/sensor/beam.py``; beam_model.hpp:76-161).

The four-component mixture (erf-normalized Gaussian hit, truncated
exponential short, max return, uniform random) is evaluated for every
(particle, beam) against the expected range from a ray cast of the
particle's pose through the occupancy grid: the exact Bresenham march, in
one launch of kernel R1's exact entry (``ops/raycast.py:exact_beam_weights``)
or, opt-in, the sphere trace over the distance table (kernel B8).  The ``Σ
pz³`` accumulation (seed 0) is the reference's nav2/AMCL parity quirk
(beam_model.hpp:104-148).

Every function takes leading filter axes: ``states`` ``[..., N]``,
``points`` ``f32[..., nb, 2]`` and ``beam_mask`` ``bool[..., nb]``.
"""

from __future__ import annotations

import dataclasses

import torch

from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.ops.cuda_beam import STEPS, mixture, sphere_trace_beam_weights
from beluga_tpu_torch.ops.raycast import exact_beam_weights, ranges_and_bearings

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamModelParams:
    """nav2-parity parameters (beam_model.hpp:43-58)."""

    z_hit: float = 0.5
    z_short: float = 0.5
    z_max: float = 0.05
    z_rand: float = 0.05
    sigma_hit: float = 0.2
    lambda_short: float = 0.1
    beam_max_range: float = 60.0


def exact_mixture(params: BeamModelParams):
    """The mixture scalars of the exact model, whose scalar products are
    Python products (beam.py:86, :94)."""
    return mixture(params.z_hit, params.z_short, params.z_max, params.z_rand, params.sigma_hit,
                   params.lambda_short, params.beam_max_range, host_products=True)


def beam_weights(params: BeamModelParams, grid: OccupancyGrid, states: SE2, points: Tensor,
                 beam_mask: Tensor, variant: str = "standard") -> Tensor:
    """AMCL-parity weights ``Σ_beams pz³`` per particle, ``f32[..., N]``.

    ``points`` are 2D hits in the base frame; ``variant`` selects the
    Bresenham variant of the ray march (``"standard"`` or
    ``"supercover"``)."""
    return exact_beam_weights(grid, states, points, beam_mask, exact_mixture(params),
                              params.beam_max_range, variant)


def beam_log_weights(params, grid, states, points, beam_mask, variant="standard") -> Tensor:
    """Log of :func:`beam_weights`, clamped away from zero, in the same launch."""
    return exact_beam_weights(grid, states, points, beam_mask, exact_mixture(params),
                              params.beam_max_range, variant, log_space=True)


def beam_sphere_trace_log_weights(params: BeamModelParams, dist_cells: Tensor,
                                  grid: OccupancyGrid, states: SE2, points: Tensor,
                                  beam_mask: Tensor, march_steps: int | None = None) -> Tensor:
    """Approximate beam log-weights through kernel B8: expected ranges from
    the sphere trace over ``dist_cells`` (``ops.cuda_beam.
    make_distance_cells``) instead of the Bresenham march, range error ~1
    cell.  ``march_steps`` bounds the trace (``None``: the reference's
    default of 20); a beam that exhausts it scores the max range."""
    z, bearing = ranges_and_bearings(points)
    local = grid.origin.inverse() @ states
    pv = (params.beam_max_range, params.z_hit, params.z_short, params.z_max, params.z_rand,
          params.sigma_hit, params.lambda_short)
    w = sphere_trace_beam_weights(
        dist_cells, *(v.contiguous() for v in (local.x, local.y, local.rot.cos, local.rot.sin)),
        bearing.contiguous(), z.contiguous(), beam_mask.contiguous(), grid.resolution, pv,
        march_steps=STEPS if march_steps is None else march_steps)
    return torch.log(torch.clamp_min(w, 1e-30))

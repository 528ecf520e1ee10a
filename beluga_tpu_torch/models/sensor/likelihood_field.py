"""Likelihood-field range-finder models (port of
``beluga_tpu/models/sensor/likelihood_field.py``).

* Field precompute (likelihood_field_model_base.hpp:130-185): exact EDT,
  optional unknown-space overlay, per-cell ``amplitude * exp(-d²/2σ²) +
  offset``.
* ``LikelihoodFieldModel`` weight (likelihood_field_model.hpp:68-91): per
  beam endpoint, transform into the field frame, read the nearest cell
  (``unknown_prob`` outside the map) and return ``1 + Σ pz³``.  The pz³ sum
  and the 1.0 seed are nav2 parity quirks.  The port reads the field
  through its code table (kernel B1), in codebook16 mode through the bf16
  pz³ table (kernel B4), as the float table itself (``gather``/``onehot``,
  plain torch) or through its SVD factors (``lowrank``, plain torch).
* ``LikelihoodFieldProbModel`` (likelihood_field_prob_model.hpp:68-90):
  the same field, the proper probability ``exp(Σ log pz)``, returned in log
  space; through the code table it is kernel B1-log, through a
  ``bf16(log pz)`` table kernel B4-log.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beluga_tpu_torch.lie import SE2, SO2
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


def _field_lookup(field: LikelihoodField, states: SE2, points: Tensor, beam_mask: Tensor,
                  lookup_mode: str = "auto") -> tuple[Tensor, Tensor]:
    """Per-(particle, beam) field values ``f32[..., N, nb]`` and the beam
    mask ``[..., 1, nb]`` (likelihood_field.py:115-141): endpoints into the
    field frame, the nearest cell, ``unknown_prob`` off the map."""
    from beluga_tpu_torch.ops.gather2d import table_lookup

    inside, row, col = _map_cells(field, states, points)
    vals = table_lookup(field.values, row, col, mode=lookup_mode)
    return torch.where(inside, vals, field.unknown_prob), beam_mask[..., None, :]


def _map_cells(field: LikelihoodField, states: SE2, points: Tensor):
    """``(inside, row, col)`` of every (particle, beam) endpoint, in the
    reference's operation order (kernel B1's cells)."""
    from beluga_tpu_torch.ops.cuda_reweight import map_cells

    tf = field.world_to_field @ states
    return map_cells(field.values.shape, tf.x, tf.y, tf.rot.cos, tf.rot.sin, points,
                     field.resolution)


def likelihood_field_weights(field: LikelihoodField, states: SE2, points: Tensor,
                             beam_mask: Tensor, lookup_mode: str = "auto") -> Tensor:
    """AMCL-parity weights ``1 + Σ pz³`` from the float table
    (likelihood_field.py:144-154), plain torch in every lookup mode."""
    pz, m = _field_lookup(field, states, points, beam_mask, lookup_mode)
    return 1.0 + torch.sum(torch.where(m, pz * pz * pz, 0.0), dim=-1)


def likelihood_field_weights_lowrank(field: LikelihoodField, factors: tuple[Tensor, Tensor],
                                     states: SE2, points: Tensor, beam_mask: Tensor) -> Tensor:
    """Approximate weights ``1 + Σ pz³`` from the SVD factors ``(U·s, V)``
    of :func:`ops.gather2d.factorize_table` (likelihood_field.py:157-189);
    a read below 0 from the truncation is clamped to 0."""
    from beluga_tpu_torch.ops.gather2d import lowrank_lookup

    inside, row, col = _map_cells(field, states, points)
    pz = torch.where(inside, lowrank_lookup(*factors, row, col), field.unknown_prob)
    pz = torch.clamp_min(pz, 0.0)
    return 1.0 + torch.sum(torch.where(beam_mask[..., None, :], pz * pz * pz, 0.0), dim=-1)


def likelihood_field_prob_weights(field: LikelihoodField, states: SE2, points: Tensor,
                                  beam_mask: Tensor,
                                  codes_book: tuple[Tensor, Tensor] | None = None,
                                  values3: Tensor | None = None) -> Tensor:
    """The probability model's log-weights ``Σ log pz``, ``f32[..., N]``
    (likelihood_field.py:240-264, likelihood_field_prob_model.hpp:68-90):
    with ``codes_book`` kernel B1-log, or B4-log with ``values3`` (a table
    of :func:`ops.cuda_reweight.build_values3` with ``log_space=True``),
    their plain versions on a CPU tensor; without it the float table."""
    if codes_book is not None:
        return _reweight(field, codes_book, states, points, beam_mask, values3, log_space=True)
    pz, m = _field_lookup(field, states, points, beam_mask)
    return torch.sum(torch.where(m, torch.log(pz), 0.0), dim=-1)


def likelihood_field_weights_codebook(
    field: LikelihoodField,
    codes_book: tuple[Tensor, Tensor],
    states: SE2,
    points: Tensor,
    beam_mask: Tensor,
    values3: Tensor | None = None,
) -> Tensor:
    """AMCL-parity weights through the code table
    (likelihood_field.py:192-237): kernel B1 (ops/cuda_reweight.py) on a
    CUDA tensor, its plain version on a CPU tensor; with ``values3`` (the
    codebook16 table of ``build_values3``) kernel B4 instead, within 5e-3
    of B1.  States ``[..., N]`` take points ``[..., nb, 2]`` and masks
    ``[..., nb]`` with the same filter axes."""
    return _reweight(field, codes_book, states, points, beam_mask, values3)


def _reweight(field: LikelihoodField, codes_book: tuple[Tensor, Tensor], states: SE2,
              points: Tensor, beam_mask: Tensor, values3: Tensor | None,
              log_space: bool = False) -> Tensor:
    """Kernel B1 or B4 through its states entry: the field-frame transform
    is composed in the kernel, so no PyTorch operation runs before it."""
    from beluga_tpu_torch.ops.cuda_reweight import fused_reweight_states

    codes, book = codes_book
    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))
    return fused_reweight_states(codes, book, field.world_to_field, states, points, beam_mask,
                                 field.resolution, field.unknown_prob, values3=values3,
                                 log_space=log_space)

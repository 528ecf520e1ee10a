"""Constructors wiring models into the AMCL filter (port of the
likelihood-field part of ``beluga_tpu/filters/builders.py``).

Returns the :class:`AmclModels` table and the ``ctx`` dict that
``filters.amcl.update`` consumes.  The port has one lookup path, the code
table of kernel B1, which is what the JAX package selects on an
accelerator (``lookup_mode="codebook"``); the other modes wait for later
slices and raise.
"""

from __future__ import annotations

from typing import Any

import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.algorithms.cluster import cluster_based_estimate
from beluga_tpu_torch.core.random import sample_uniform_free_cells
from beluga_tpu_torch.filters.amcl import AmclModels, default_estimate, default_hash_state
from beluga_tpu_torch.maps.codebook import likelihood_field_codebook
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_propagate,
)
from beluga_tpu_torch.models.sensor.likelihood_field import (
    LikelihoodFieldParams,
    likelihood_field_weights_codebook,
    make_likelihood_field,
)
from beluga_tpu_torch.ops.gather2d import build_device_codebook, encode_table

_LATER_MODES = {
    "gather": "A11", "onehot": "A11", "lowrank": "A11", "codebook16": "A8 (kernel B4)",
}


def make_motion_fn(motion_params):
    """The propagate function of a motion-params dataclass."""
    if isinstance(motion_params, DifferentialDriveParams):
        def propagate(ctx, z, states, pose, prev):
            del ctx
            return diff_drive_propagate(motion_params, z, states, pose, prev)

        return propagate
    raise NotImplementedError(
        f"motion model {motion_params!r} is not ported (ROADMAP A12)"
    )


def make_grid_random_state_fn(recovery_candidates: int = 0):
    """Recovery generator: uniform over the free cells of ``ctx['grid']``
    (beluga_ros/amcl.hpp map_distribution_).  The pooled generator
    (``recovery_candidates > 0``, kernel B3) waits for ROADMAP A8."""
    if recovery_candidates:
        raise NotImplementedError(
            "the pooled recovery generator (kernel B3) is not ported (ROADMAP A8)"
        )

    def random_state(ctx, generator, n, particles=None):
        del particles
        grid: OccupancyGrid = ctx["grid"]
        return sample_uniform_free_cells(generator, n, grid.free_xy, grid.num_free)

    return random_state


def make_likelihood_field_filter(
    grid: OccupancyGrid,
    lf_params: LikelihoodFieldParams = LikelihoodFieldParams(),
    motion_params: Any = DifferentialDriveParams(),
    prob_model: bool = False,
    use_cluster_estimate: bool = False,
    lookup_mode: str = "auto",
    recovery_candidates: int = 0,
    device=None,
):
    """Likelihood-field AMCL: ``(models, ctx)`` with ``ctx = {'grid',
    'field', 'field_codes'}`` on ``device`` (default ``"cuda"``).

    ``lookup_mode``: ``"auto"`` or ``"codebook"``, the 8-bit code table
    read by kernel B1 (exact for production fields)."""
    if lookup_mode in _LATER_MODES:
        raise NotImplementedError(
            f"lookup_mode {lookup_mode!r} is not ported (ROADMAP {_LATER_MODES[lookup_mode]})"
        )
    if lookup_mode not in ("auto", "codebook"):
        raise ValueError(f"unknown lookup_mode {lookup_mode!r}")
    if prob_model:
        raise NotImplementedError("the likelihood-field prob model is not ported (ROADMAP A11)")

    def log_weight(ctx, states, points, beam_mask):
        lik = likelihood_field_weights_codebook(
            ctx["field"], ctx["field_codes"], states, points, beam_mask
        )
        return torch.log(lik)

    if use_cluster_estimate:
        def estimate(params, particles):
            del params
            return cluster_based_estimate(particles.state, particles.weight, particles.mask)
    else:
        estimate = default_estimate

    models = AmclModels(
        propagate=make_motion_fn(motion_params),
        log_weight=log_weight,
        random_state=make_grid_random_state_fn(recovery_candidates),
        hash_state=default_hash_state,
        estimate=estimate,
    )
    return models, update_map_ctx({}, grid.to(resolve_device(device)), lf_params)


def make_field_codes(field, lf_params: LikelihoodFieldParams, grid: OccupancyGrid):
    """``(codes uint8[H, W], codebook f32[256])``: the table's distinct
    values when there are at most 256, else the analytic host proposal
    (maps/codebook.py)."""
    fallback = torch.as_tensor(likelihood_field_codebook(lf_params, grid.resolution))
    book = build_device_codebook(field.values, fallback)
    return encode_table(field.values, book), book


def update_map_ctx(ctx: dict, grid: OccupancyGrid, lf_params: LikelihoodFieldParams) -> dict:
    """Hot-swap the map (amcl_node.cpp:469-471): rebuild the field and its
    code table on the grid's device, keep everything else."""
    field = make_likelihood_field(lf_params, grid)
    return {**ctx, "grid": grid, "field": field,
            "field_codes": make_field_codes(field, lf_params, grid)}

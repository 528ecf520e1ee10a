"""nav2's likelihood-field model in the port's ``codebook16`` form (kernel
B4): how the port's filter is built, and what its weights cost.

The configuration states nav2's parameters, and they map onto the port's
``LikelihoodFieldParams`` as nav2's own node maps them: the field's
obstacle distance is capped at ``laser_likelihood_max_dist``, and
``z_rand`` is spread over ``laser_max_range``.

Counts: 11 float32 operations per (particle, unmasked beam) (8 for the
endpoint transform, 2 divisions, 1 for the sum; the cube is read from the
table) and 8 a particle to compose its pose with the field's; bytes: the
bf16 table (2 a cell), 16 a particle in (x, y, cos, sin) and 4 out, 9 a
beam a filter (a point and its mask) and 16 for the field's transform.
"""

from __future__ import annotations

import numpy as np

OPS_PER_BEAM, OPS_PER_PARTICLE = 11, 8


def params(config: dict):
    """The port's ``LikelihoodFieldParams`` of nav2's parameters."""
    from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams

    lf = config["likelihood_field"]
    return LikelihoodFieldParams(
        max_obstacle_distance=lf["laser_likelihood_max_dist"],
        max_laser_distance=lf["laser_max_range"], z_hit=lf["z_hit"], z_random=lf["z_rand"],
        sigma_hit=lf["sigma_hit"])


def build(config: dict, data: np.ndarray, motion, device):
    import beluga_tpu_torch as bt

    grid = bt.make_grid(data, config["map"]["resolution"], device=device)
    return bt.make_likelihood_field_filter(
        grid, params(config), motion, lookup_mode=config["likelihood_field"]["lookup_mode"],
        recovery_candidates=config["recovery_candidates"], device=device)


def counts(particles: int, robots: int, unmasked_beams: int, beams: int,
           table_cells: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one tick's weights: ``unmasked_beams``
    summed over the robots."""
    total = particles * robots
    ops = OPS_PER_BEAM * particles * unmasked_beams + OPS_PER_PARTICLE * total
    nbytes = 2 * table_cells + 16 * total + 4 * total + 9 * beams * robots + 16
    return float(ops), float(nbytes)


def work(config: dict, data: np.ndarray, points, mask, poses, particles: int):
    unmasked = mask.sum(-1).cpu().numpy()
    beams, cells = int(mask.shape[-1]), int(data.size)

    def of(idx: np.ndarray) -> tuple[float, float]:
        return counts(particles, len(idx), int(unmasked[idx].sum()), beams, cells)

    return of

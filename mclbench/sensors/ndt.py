"""beluga's 2D NDT sensor model through the port's fused NDT kernel: how
the port's filter is built (the map fitted from the occupancy grid as
``tools/make_ndt_map.py`` fits it), and what its weights cost.

Counts: 40 operations per (particle, live measurement cell) (the world
Gaussian, ``R m + t`` and ``R Σ Rᵀ``), 7 per stencil probe (9 a cell) and
38 per probe that finds a map cell (the 2x2 inverse, the quadratic form and
the ``exp``); bytes: 28 a particle (its rotation, translation and weight),
25 a measurement slot a filter (mean, covariance, mask) and 28 a map row
(its key, mean and covariance).  The probes that find a map cell are
counted for each scan at its robot's pose, about which the particles lie
within centimetres of the 0.4 m cells.
"""

from __future__ import annotations

import numpy as np
import torch

CELL_OPS, PROBE_OPS, HIT_OPS, STENCIL = 40, 7, 38, 9
MIN_POINTS = 5  # points a measurement cell needs (to_cells)


def build(config: dict, data: np.ndarray, motion, device):
    import beluga_tpu_torch as bt
    from beluga_tpu_torch.models.sensor.ndt import NdtModelParams
    from beluga_tpu_torch.tools.make_ndt_map import fit_ndt_cells, grid_to_points

    nd = config["ndt"]
    cells = fit_ndt_cells(grid_to_points(data, config["map"]["resolution"]), nd["cell_size"],
                          nd["map_min_points"], nd["map_min_variance"])
    ndt_map = bt.make_ndt_map(*cells, nd["cell_size"], device)
    params = NdtModelParams(minimum_likelihood=nd["minimum_likelihood"], d1=nd["d1"],
                            d2=nd["d2"])
    return bt.make_ndt_filter_2d(ndt_map, params, motion)


def counts(particles: int, robots: int, live_cells: int, hit_probes: int, slots: int,
           map_rows: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one tick's weights: ``live_cells`` and
    ``hit_probes`` (stencil probes that find a map cell, a particle)
    summed over the robots."""
    ops = particles * (CELL_OPS * live_cells + PROBE_OPS * STENCIL * live_cells
                       + HIT_OPS * hit_probes)
    nbytes = 28 * particles * robots + 25 * slots * robots + 28 * map_rows
    return float(ops), float(nbytes)


def live_cells(points: torch.Tensor, mask: torch.Tensor, size: float) -> torch.Tensor:
    """``int64[K]``: each scan's measurement cells of at least 5 points
    (cells by truncation of ``p / size`` in float32)."""
    k = points.shape[0]
    cell = torch.trunc(points / torch.full((), size, dtype=torch.float32,
                                           device=points.device)).long()
    key = (torch.arange(k, device=points.device)[:, None] << 40) \
        | ((cell[..., 0] + (1 << 19)) << 20) | (cell[..., 1] + (1 << 19))
    key = key[mask]
    uniq, n = torch.unique(key, return_counts=True)
    return torch.bincount(uniq[n >= MIN_POINTS] >> 40, minlength=k)


def work(config: dict, data: np.ndarray, points, mask, poses, particles: int):
    from mclbench.reference.ndt_fleet import Sensor

    ref = Sensor(data, config, "cpu")
    hits = ref.probe_hits(points.cpu(), mask.cpu(), poses)
    live = live_cells(points.cpu(), mask.cpu(), config["ndt"]["cell_size"]).numpy()
    slots, rows = int(mask.shape[-1]), len(ref.means)

    def of(idx: np.ndarray) -> tuple[float, float]:
        return counts(particles, len(idx), int(live[idx].sum()), int(hits[idx].sum()), slots,
                      rows)

    return of

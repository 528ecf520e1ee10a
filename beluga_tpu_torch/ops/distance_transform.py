"""Exact separable squared EDT (port of
``beluga_tpu/ops/distance_transform.py``).

Phase 1 takes the vertical cell distance to the nearest obstacle in each
column with two directional cummax scans; phase 2 is the row min-plus
``D²[y, x] = min_x' (g[y, x']² + (x - x')²)``.  All intermediate values are
small integers in float32, so the result is exact and matches the
reference bit for bit.  Runs once per map load.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# rows per min-plus block: bounds the [rows, W, W] intermediate to ~150 MB
# at W = 384
_ROWS = 256


def squared_distance_transform(
    obstacle_mask: Tensor, resolution: float, max_distance: float
) -> Tensor:
    """Squared distance (meters²) from every cell to the nearest obstacle,
    clamped to ``max_distance**2`` (distance_map.hpp:66)."""
    obs = obstacle_mask
    h, w = obs.shape
    dev = obs.device
    f32 = torch.float32
    big = float(h + w + 1)

    rows = torch.arange(h, dtype=f32, device=dev)[:, None]
    neg_big = torch.full((), -big, dtype=f32, device=dev)
    last_above = torch.cummax(torch.where(obs, rows, neg_big), dim=0).values
    first_below = -torch.flip(
        torch.cummax(torch.flip(torch.where(obs, -rows, neg_big), [0]), dim=0).values,
        [0],
    )
    g = torch.minimum(rows - last_above, first_below - rows)

    res = torch.tensor(resolution, dtype=f32, device=dev)
    max_d2_cells = torch.square(torch.tensor(max_distance, dtype=f32, device=dev) / res)
    g2 = torch.minimum(torch.square(g), max_d2_cells)

    cols = torch.arange(w, dtype=f32, device=dev)
    parabola = torch.square(cols[:, None] - cols[None, :])  # [W(x), W(x')]
    d2_cells = torch.cat([
        torch.amin(g2[r : r + _ROWS, None, :] + parabola[None], dim=-1)
        for r in range(0, h, _ROWS)
    ])
    d2_cells = torch.minimum(d2_cells, max_d2_cells)
    return d2_cells * torch.square(res)

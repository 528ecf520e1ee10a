"""The world every cell shares: the arena, the lattice of poses on its
circle, and the scans cast from them.

The arena is a copy of the port's synthetic tracking arena (a free disk of
radius 2.6 m inside a walled 19.2 m square at 5 cm, clutter outside it, an
irregular ring of obstacles at ~3.2 m and three pillars that break its
symmetry).  It takes no seed of the run: every run sees the same map, one
environment cloned for every robot, as GPU robot simulators clone theirs.

Robots drive the arena's 1.2 m circle, tangent heading.  Their poses sit on
a lattice of ``K`` points around it, so that every scan a run can need is
cast once, at set-up: the caster is a DDA march in float64 (a copy of the
port's ``simulate_scans``), run in torch on the card in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

OCCUPIED = 100


def tracking_arena(grid_size: int, res: float, seed: int = 0) -> np.ndarray:
    """``int8[grid_size, grid_size]`` occupancy (ROS trinary: 0 free, 100
    occupied), row 0 the bottom; ``seed`` is the arena's own, not the run's."""
    rng = np.random.default_rng(seed)
    center = grid_size * res / 2
    data = np.zeros((grid_size, grid_size), np.int8)
    data[0, :] = data[-1, :] = OCCUPIED
    data[:, 0] = data[:, -1] = OCCUPIED
    rr, cc = np.mgrid[0:grid_size, 0:grid_size]
    dist2 = ((rr + 0.5) * res - center) ** 2 + ((cc + 0.5) * res - center) ** 2
    for _ in range(24):  # clutter outside the arena
        r, c = rng.integers(10, grid_size - 20, 2)
        data[r : r + 8, c : c + 8] = OCCUPIED
    for k in range(14):  # irregular obstacle ring at ~3.2 m
        a = 2 * np.pi * k / 14 + rng.uniform(-0.15, 0.15)
        rad = 3.2 + rng.uniform(-0.35, 0.35)
        cx = int((center + rad * np.cos(a)) / res)
        cy = int((center + rad * np.sin(a)) / res)
        s = int(rng.integers(2, 7))
        data[max(cy - s, 0) : cy + s, max(cx - s, 0) : cx + s] = OCCUPIED
    data[(dist2 < 2.6**2) & (rr > 0) & (rr < grid_size - 1)
         & (cc > 0) & (cc < grid_size - 1)] = 0  # free arena disk
    for px, py, s in ((0.45, 0.1, 4), (-0.55, 0.4, 2), (0.1, -0.6, 3)):  # pillars
        cx = int((center + px) / res)
        cy = int((center + py) / res)
        data[cy - s : cy + s, cx - s : cx + s] = OCCUPIED
    return data


def lattice_poses(k: int, grid_size: int, res: float, radius: float) -> np.ndarray:
    """``f64[k, 3]`` (x, y, yaw): ``k`` points evenly around the circle of
    ``radius`` about the arena's centre, heading along the tangent."""
    center = grid_size * res / 2
    a = 2.0 * math.pi * np.arange(k) / k
    return np.stack([center + radius * np.cos(a), center + radius * np.sin(a), a + math.pi / 2],
                    -1)


def cast_scans(data: np.ndarray, res: float, poses: np.ndarray, beams: int, max_range: float,
               device, chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """DDA-marched scans from every pose (``f64[k, 3]``) against ``data``:
    points ``f32[k, beams, 2]`` in the base frame (0 where a beam hits
    nothing within ``max_range``) and the hit mask ``bool[k, beams]``, on
    ``device``.  Beams span [-π, π) from the heading; the march steps half
    a cell."""
    h, w = data.shape
    occ = torch.as_tensor(data == OCCUPIED, device=device)
    angles = torch.linspace(-math.pi, math.pi, beams + 1, dtype=torch.float64,
                            device=device)[:-1]
    march = torch.arange(1, int(max_range / (res * 0.5)) + 1, dtype=torch.float64,
                         device=device) * (res * 0.5)
    p = torch.as_tensor(poses, dtype=torch.float64, device=device)
    pts, masks = [], []
    for s in range(0, len(p), chunk):
        x, y, yaw = (p[s : s + chunk, i, None, None] for i in range(3))
        dirs = yaw + angles[:, None]
        px = x + march * torch.cos(dirs)
        py = y + march * torch.sin(dirs)
        ci = torch.floor(px / res).long()
        ri = torch.floor(py / res).long()
        valid = (ci >= 0) & (ci < w) & (ri >= 0) & (ri < h)
        hit_cell = valid & occ[ri.clamp(0, h - 1), ci.clamp(0, w - 1)]
        first = torch.argmax(hit_cell.to(torch.uint8), dim=-1)
        hit = torch.gather(hit_cell, -1, first[..., None])[..., 0]
        d = torch.where(hit, march[first], 0.0)
        pts.append(torch.stack([d * torch.cos(angles), d * torch.sin(angles)], -1).float())
        masks.append(hit)
    return torch.cat(pts), torch.cat(masks)

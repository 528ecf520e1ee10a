"""Synthetic tracking workloads in numpy: the arena, the circular
trajectory and the DDA scan simulator of the JAX package's ``bench.py``
(``build``), and the long-range world and arc of
``tests/test_system_long_range.py:27-37, 62-69``, so that the port's tests
and ``chip_smoke.py`` need neither ``bench.py`` nor JAX; and a writer of
such data as a map_server map (PGM and YAML), for the replay tools.

The arena is a free disk of radius 2.6 m inside a walled square with
random clutter outside, an irregular ring of obstacles at ~3.2 m and three
interior pillars that break its rotational symmetry.  The robot drives a
circle of radius 1.2 m at 0.26 m / 0.22 rad per step, which passes the
nav2 on-motion gate on every update.
"""

from __future__ import annotations

import numpy as np

OCCUPIED_VALUE = 100


def tracking_arena(grid_size: int = 384, res: float = 0.05, seed: int = 0) -> np.ndarray:
    """``int8[grid_size, grid_size]`` occupancy data (ROS trinary)."""
    rng = np.random.default_rng(seed)
    center = grid_size * res / 2
    data = np.zeros((grid_size, grid_size), np.int8)
    data[0, :] = data[-1, :] = OCCUPIED_VALUE
    data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    rr, cc = np.mgrid[0:grid_size, 0:grid_size]
    dist2 = ((rr + 0.5) * res - center) ** 2 + ((cc + 0.5) * res - center) ** 2
    for _ in range(24):  # clutter outside the arena
        r, c = rng.integers(10, grid_size - 20, 2)
        data[r : r + 8, c : c + 8] = OCCUPIED_VALUE
    for k in range(14):  # irregular obstacle ring at ~3.2 m
        a = 2 * np.pi * k / 14 + rng.uniform(-0.15, 0.15)
        rad = 3.2 + rng.uniform(-0.35, 0.35)
        cx = int((center + rad * np.cos(a)) / res)
        cy = int((center + rad * np.sin(a)) / res)
        s = int(rng.integers(2, 7))
        data[max(cy - s, 0) : cy + s, max(cx - s, 0) : cx + s] = OCCUPIED_VALUE
    data[(dist2 < 2.6**2) & (rr > 0) & (rr < grid_size - 1)
         & (cc > 0) & (cc < grid_size - 1)] = 0  # free arena disk
    for px, py, s in ((0.45, 0.1, 4), (-0.55, 0.4, 2), (0.1, -0.6, 3)):  # pillars
        cx = int((center + px) / res)
        cy = int((center + py) / res)
        data[cy - s : cy + s, cx - s : cx + s] = OCCUPIED_VALUE
    return data


def circle_trajectory(steps: int, grid_size: int = 384, res: float = 0.05):
    """Ground-truth poses ``(x, y, yaw)`` as three float64 arrays: a circle of
    radius 1.2 m about the arena centre, tangent heading, 0.22 rad a step."""
    center = grid_size * res / 2
    ts = np.arange(steps) * 0.22
    return center + 1.2 * np.cos(ts), center + 1.2 * np.sin(ts), ts + np.pi / 2


def long_range_world(cells: int = 1024, seed: int = 3) -> np.ndarray:
    """``int8[cells, cells]``: a walled square with 36 random blocks of 4-30
    cells, sparse enough that most beams fly tens of meters at 0.1 m
    (tests/test_system_long_range.py:27-37)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((cells, cells), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    for _ in range(36):
        r, c = rng.integers(40, cells - 60, 2)
        h, w = rng.integers(4, 30, 2)
        data[r : r + h, c : c + w] = OCCUPIED_VALUE
    return data


def arc_trajectory(steps: int, cells: int = 1024, res: float = 0.1):
    """Ground-truth poses of the long-range test's arc, continued: a circle
    of radius 6 m about a point 12 m left of the map's centre, 0.12 rad
    (~0.7 m) a step, tangent heading (tests/test_system_long_range.py:
    62-69)."""
    center = cells * res / 2
    ts = np.arange(steps) * 0.12
    return center - 12.0 + 6.0 * np.cos(ts), center + 6.0 * np.sin(ts), ts + np.pi / 2


def simulate_scans(data: np.ndarray, res: float, xs, ys, yaws, num_beams: int,
                   max_range: float = 3.5):
    """DDA-marched scans against ``data`` from each pose: points
    ``f32[T, B, 2]`` in the base frame (0 where the beam found nothing) and
    the hit mask ``bool[T, B]``."""
    h, w = data.shape
    angles = np.linspace(-np.pi, np.pi, num_beams, endpoint=False)
    march = np.arange(1, int(max_range / (res * 0.5)) + 1) * (res * 0.5)
    pts_all, mask_all = [], []
    for x, y, yaw in zip(xs, ys, yaws):
        dirs = yaw + angles
        px = x + march[None, :] * np.cos(dirs)[:, None]
        py = y + march[None, :] * np.sin(dirs)[:, None]
        ci = np.floor(px / res).astype(int)
        ri = np.floor(py / res).astype(int)
        valid = (ci >= 0) & (ci < w) & (ri >= 0) & (ri < h)
        occ = np.zeros_like(valid)
        occ[valid] = data[ri[valid], ci[valid]] == OCCUPIED_VALUE
        first = np.argmax(occ, axis=1)
        hit = occ[np.arange(num_beams), first]
        d = np.where(hit, march[first], np.nan)
        pts = np.stack([d * np.cos(angles), d * np.sin(angles)], -1)
        pts_all.append(np.nan_to_num(pts).astype(np.float32))
        mask_all.append(hit)
    return np.stack(pts_all), np.stack(mask_all)


def write_map_yaml(directory, data: np.ndarray, res: float, name: str = "arena") -> str:
    """Write occupancy ``data`` (ROS trinary, row 0 the bottom) as a
    map_server map, ``name.pgm`` and ``name.yaml`` in ``directory`` with the
    origin at (0, 0, 0); returns the YAML's path.  Free cells are written
    254, occupied 0 and unknown 205, which map_server's thresholds (0.65,
    0.196) read back as the same values."""
    import os

    pix = np.full(data.shape, 205, np.uint8)
    pix[data == 0] = 254
    pix[data == OCCUPIED_VALUE] = 0
    pix = np.flipud(pix)  # PGM row 0 is the top
    h, w = data.shape
    with open(os.path.join(directory, f"{name}.pgm"), "wb") as f:
        f.write(f"P5\n# {name}\n{w} {h}\n255\n".encode() + pix.tobytes())
    path = os.path.join(directory, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(f"image: {name}.pgm\nresolution: {res}\norigin: [0.0, 0.0, 0.0]\n"
                "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return path

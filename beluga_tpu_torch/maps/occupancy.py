"""Dense 2D occupancy grid (port of ``beluga_tpu/maps/occupancy.py``).

Cell conventions are the reference's: ``cell_near(p) = floor(p / res)``,
``coordinates_at(c) = (c + 0.5) * res``, row-major ``y * width + x``, and
out-of-bounds cells are non-free.  Values are the ROS trinary: free 0,
unknown -1, occupied 100.

Host-known map facts (resolution, origin, free-cell count) are plain
Python values, so nothing downstream has to read them back from the card.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.lie import SE2, SO2

Tensor = torch.Tensor

FREE_VALUE = 0
UNKNOWN_VALUE = -1
OCCUPIED_VALUE = 100


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """Trinary occupancy grid on one device.

    Attributes:
      data: ``int8[H, W]`` cell values.
      resolution: meters per cell, rounded to float32.
      origin: ``SE2`` grid-local to world transform (0-d leading shape).
      free_xy: ``f32[H*W, 2]`` world coordinates of the free-cell centroids,
        packed in the prefix of length ``num_free``.
      num_free: number of free cells.
      origin_xytheta: host copy of the origin pose.
    """

    data: Tensor
    resolution: float
    origin: SE2
    free_xy: Tensor
    num_free: int
    origin_xytheta: tuple

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "OccupancyGrid":
        return dataclasses.replace(
            self, data=self.data.to(device), origin=self.origin.to(device),
            free_xy=self.free_xy.to(device),
        )

    # -- masks (occupancy_grid.hpp:183-213) --------------------------------

    @property
    def free_mask(self) -> Tensor:
        return self.data == FREE_VALUE

    @property
    def obstacle_mask(self) -> Tensor:
        return self.data == OCCUPIED_VALUE

    @property
    def unknown_mask(self) -> Tensor:
        return self.data == UNKNOWN_VALUE

    def obstacle_edge_mask(self) -> Tensor:
        """Occupied cells 4-adjacent to at least one free cell
        (occupancy_grid.hpp:191-206)."""
        pad = torch.nn.functional.pad(self.free_mask, (1, 1, 1, 1), value=False)
        any_free_neighbor = (
            pad[2:, 1:-1] | pad[:-2, 1:-1] | pad[1:-1, 2:] | pad[1:-1, :-2]
        )
        return self.obstacle_mask & any_free_neighbor

    # -- cell math ----------------------------------------------------------

    def cell_near(self, p_local: Tensor) -> Tensor:
        """``floor(p / resolution)`` for local points ``[..., 2]`` -> i32."""
        return torch.floor(p_local / self.resolution).to(torch.int32)

    def coordinates_at(self, cells: Tensor) -> Tensor:
        """Cell centroids in the local frame for ``int[..., 2]`` cells."""
        return (cells.to(torch.float32) + 0.5) * self.resolution

    def contains(self, cells: Tensor) -> Tensor:
        x, y = cells[..., 0], cells[..., 1]
        return (x >= 0) & (x < self.width) & (y >= 0) & (y < self.height)

    def value_at(self, cells: Tensor, fill: int = UNKNOWN_VALUE) -> Tensor:
        """Cell values; out-of-bounds reads return ``fill``."""
        inside = self.contains(cells)
        x = torch.clamp(cells[..., 0], 0, self.width - 1).long()
        y = torch.clamp(cells[..., 1], 0, self.height - 1).long()
        return torch.where(inside, self.data[y, x], fill)

    def free_at(self, cells: Tensor) -> Tensor:
        """True where the cell exists and is free (occupancy_grid.hpp:101-106)."""
        return self.value_at(cells) == FREE_VALUE


def make_grid(data, resolution: float, origin=None, device=None) -> OccupancyGrid:
    """Grid from an ``int8[H, W]`` array; ``origin`` is ``None`` (identity)
    or an ``(x, y, yaw)`` tuple.  Built with numpy, then copied to
    ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    arr = np.asarray(data, dtype=np.int8)
    h, w = arr.shape
    ox, oy, oyaw = (0.0, 0.0, 0.0) if origin is None else (float(v) for v in origin)
    oc, os_ = np.cos(oyaw), np.sin(oyaw)
    origin_se2 = SE2(
        torch.tensor([ox, oy], dtype=torch.float32, device=device),
        SO2(torch.tensor([oc, os_], dtype=torch.float32, device=device)),
    )

    ys, xs = np.nonzero(arr == FREE_VALUE)  # row-major order, like free_cells()
    local = np.stack(
        [(xs + 0.5) * resolution, (ys + 0.5) * resolution], axis=-1
    ).astype(np.float32)
    num_free = len(ys)
    rot = np.array([[oc, -os_], [os_, oc]], np.float32)
    world = np.zeros((h * w, 2), np.float32)
    world[:num_free] = local @ rot.T + np.array([ox, oy], np.float32)

    return OccupancyGrid(
        data=torch.as_tensor(arr).to(device),
        resolution=float(np.float32(resolution)),
        origin=origin_se2,
        free_xy=torch.as_tensor(world).to(device),
        num_free=num_free,
        origin_xytheta=(ox, oy, oyaw),
    )


def load_pgm_yaml(yaml_path: str, device=None) -> OccupancyGrid:
    """Load a ROS map_server map (PGM + YAML metadata) with map_server's
    value interpretation.  ``yaml`` is imported here, not with the module."""
    import yaml

    with open(yaml_path) as f:
        meta = yaml.safe_load(f)
    img_path = meta["image"]
    if not os.path.isabs(img_path):
        img_path = os.path.join(os.path.dirname(yaml_path), img_path)

    img = _read_pgm(img_path)
    p = (255.0 - img) / 255.0 if not meta.get("negate", 0) else img / 255.0
    occ = p > meta.get("occupied_thresh", 0.65)
    free = p < meta.get("free_thresh", 0.196)
    grid = np.full(img.shape, UNKNOWN_VALUE, np.int8)
    grid[occ] = OCCUPIED_VALUE
    grid[free] = FREE_VALUE
    grid = np.flipud(grid).copy()  # PGM row 0 is the top; grid row 0 the bottom

    ox, oy, oyaw = (float(v) for v in meta["origin"])
    return make_grid(grid, float(meta["resolution"]), (ox, oy, oyaw), device)


def _read_pgm(path: str) -> np.ndarray:
    """Minimal P5/P2 PGM reader (binary/ascii greyscale)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1
    if magic == b"P5":
        dtype = np.uint8 if maxval < 256 else ">u2"
        img = np.frombuffer(data, dtype=dtype, count=w * h, offset=i).reshape(h, w)
        return img.astype(np.float32) * (255.0 / maxval)
    if magic == b"P2":
        vals = np.array(data[i:].split(), dtype=np.float32)
        return (vals[: w * h].reshape(h, w)) * (255.0 / maxval)
    raise ValueError(f"unsupported PGM magic {magic!r}")

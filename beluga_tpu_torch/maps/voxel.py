"""Dense 3D distance voxel grids (port of ``beluga_tpu/maps/voxel.py``,
the beluga_vdb map equivalent).

The reference's 3D extension stores an OpenVDB narrow-band level set of
distances to the nearest obstacle, with a background value elsewhere
(beluga_vdb/sensor/vdb_likelihood_field_model.hpp:112-152).  Here it is a
dense ``f32[D, H, W]`` distance volume on the device, built with the exact
separable squared EDT in 3D: a column scan along z, then min-plus passes
along y and x.  A lookup rounds to the nearest voxel centre; with a code
table (:func:`make_distance_codes`) it goes through kernel B11
(``ops/cuda_codebook.py``) on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.ops.cuda_codebook import codebook_lookup
from beluga_tpu_torch.ops.gather2d import build_device_codebook, encode_table

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistanceGrid3:
    """Dense 3D distance-to-nearest-obstacle grid on one device.

    Attributes:
      values: ``f32[D, H, W]`` distances in meters, indexed [z][y][x].
      voxel_size: meters, rounded to float32.
      origin_xyz: ``f32[3]`` world coordinates of voxel (0, 0, 0)'s centre.
      background: the distance outside the volume, rounded to float32.
    """

    values: Tensor
    voxel_size: float
    origin_xyz: Tensor
    background: float

    @property
    def device(self) -> torch.device:
        return self.values.device

    def voxel_index(self, points_world: Tensor) -> Tensor:
        """``round((p − origin) / voxel_size)`` as int32 ``[..., 3]`` (x, y,
        z): the cell-centred index (worldToIndexCellCentered), half to even
        as ``jnp.round``; the division is by a tensor, as in float32 JAX."""
        size = torch.full((), self.voxel_size, dtype=torch.float32, device=points_world.device)
        return torch.round((points_world - self.origin_xyz) / size).to(torch.int32)

    def distance_at(self, points_world: Tensor, codes_book=None) -> Tensor:
        """Distances at ``f32[..., 3]`` world points, ``background`` outside
        the volume; with ``codes_book`` (from :func:`make_distance_codes`)
        through kernel B11 on the volume flattened to ``[H, D·W]``."""
        idx = self.voxel_index(points_world)
        d, h, w = self.values.shape
        x, y, z = idx[..., 0], idx[..., 1], idx[..., 2]
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (z >= 0) & (z < d)
        if codes_book is not None:
            codes2d, book = codes_book
            yi = torch.clamp(y, 0, h - 1)
            xi = torch.clamp(z, 0, d - 1) * w + torch.clamp(x, 0, w - 1)
            vals = codebook_lookup(codes2d, book, yi, xi)
        else:
            vals = self.values[torch.clamp(z, 0, d - 1).long(), torch.clamp(y, 0, h - 1).long(),
                               torch.clamp(x, 0, w - 1).long()]
        return torch.where(inside, vals, self.background)


def squared_distance_transform_3d(obstacle: Tensor, max_cells: float) -> Tensor:
    """Exact squared EDT (in cells²) of a ``bool[D, H, W]`` obstacle mask,
    clamped to ``max_cells²``; every value is a small integer in float32,
    so the result is exact.  The min-plus passes run one z slice at a
    time, as the reference's ``lax.map`` does."""
    d, h, w = obstacle.shape
    dev = obstacle.device
    f32 = torch.float32
    big = float(d + h + w + 1)
    max2 = torch.square(torch.full((), max_cells, dtype=f32, device=dev))

    zs = torch.arange(d, dtype=f32, device=dev)[:, None, None]
    neg_big = torch.full((), -big, dtype=f32, device=dev)
    above = torch.cummax(torch.where(obstacle, zs, neg_big), dim=0).values
    below = -torch.flip(torch.cummax(torch.flip(torch.where(obstacle, -zs, neg_big), [0]),
                                     dim=0).values, [0])
    g2 = torch.minimum(torch.square(torch.minimum(zs - above, below - zs)), max2)

    ys = torch.arange(h, dtype=f32, device=dev)
    py = torch.square(ys[:, None] - ys[None, :])  # [H(y), H(y')]
    xs = torch.arange(w, dtype=f32, device=dev)
    px = torch.square(xs[:, None] - xs[None, :])  # [W(x), W(x')]
    out = []
    for s in g2:  # [H, W] at one z
        s = torch.amin(s[None, :, :] + py[:, :, None], dim=1)
        out.append(torch.amin(s[:, None, :] + px[None, :, :], dim=2))
    return torch.minimum(torch.stack(out), max2)


def make_distance_grid(obstacle_mask, voxel_size: float, origin_xyz=(0.0, 0.0, 0.0),
                       max_distance: float = 100.0, device=None) -> DistanceGrid3:
    """The distance volume of a ``bool[D, H, W]`` obstacle mask, on
    ``device`` (default the card)."""
    device = resolve_device(device)
    mask = torch.as_tensor(np.asarray(obstacle_mask, bool)).to(device)
    size = torch.full((), voxel_size, dtype=torch.float32, device=device)
    max_cells = float(np.float32(max_distance / voxel_size))
    dist = torch.sqrt(squared_distance_transform_3d(mask, max_cells)) * size
    return DistanceGrid3(
        values=dist,
        voxel_size=float(np.float32(voxel_size)),
        origin_xyz=torch.as_tensor(np.asarray(origin_xyz, np.float32)).to(device),
        background=float(np.float32(max_distance)),
    )


def make_distance_grid_from_points(points_xyz, voxel_size: float, padding_cells: int = 4,
                                   max_distance: float = 100.0, device=None) -> DistanceGrid3:
    """The map of an obstacle point cloud (the common VDB workflow: a
    scanned cloud voxelized into a level set), padded by
    ``padding_cells`` voxels on every side."""
    pts = np.asarray(points_xyz, np.float64)
    lo = pts.min(0) - padding_cells * voxel_size
    hi = pts.max(0) + padding_cells * voxel_size
    w, h, d = (int(s) for s in np.ceil((hi - lo) / voxel_size).astype(int) + 1)
    mask = np.zeros((d, h, w), bool)
    idx = np.round((pts - lo) / voxel_size).astype(int)
    mask[idx[:, 2], idx[:, 1], idx[:, 0]] = True
    return make_distance_grid(mask, voxel_size, origin_xyz=lo, max_distance=max_distance,
                              device=device)


def _proposal_book(voxel_size: float, background: float, max_codes: int) -> np.ndarray:
    """The reference's host codebook proposal (maps/voxel.py:167-181): every
    ``sqrt(k)·voxel_size`` up to the background and the background itself,
    nearest gaps merged until ``max_codes`` remain, padded with the last."""
    voxel = float(voxel_size)
    bg = float(np.float32(background))
    kmax = int(min((bg / max(voxel, 1e-9)) ** 2, 4 * max_codes * max_codes)) + 1
    vals = np.unique((np.sqrt(np.arange(kmax, dtype=np.float64))
                      * np.float32(voxel)).astype(np.float32))
    vals = np.unique(np.concatenate([vals, [np.float32(bg)]]))
    while vals.size > max_codes:
        gaps = np.diff(vals)
        k = int(np.argmin(gaps))
        merged = np.float32(0.5 * (float(vals[k]) + float(vals[k + 1])))
        vals = np.concatenate([vals[:k], [merged], vals[k + 2:]])
    if vals.size < max_codes:
        vals = np.concatenate([vals, np.full(max_codes - vals.size, vals[-1], np.float32)])
    return vals.astype(np.float32)


def make_distance_codes(grid: DistanceGrid3, voxel_size: float, background: float,
                        max_codes: int = 256) -> tuple[Tensor, Tensor]:
    """``(codes uint8[H, D·W], codebook f32[max_codes])`` of the volume
    flattened to ``[H, D·W]`` (column z·W + x), on the grid's device, for
    kernel B11.

    Distances are ``sqrt(k)·voxel_size`` for integer k (the exact EDT) or
    the background, usually far fewer than 256 distinct values: then the
    codebook is the volume's own distinct values and the lookup is
    bit-exact.  Otherwise the reference's host proposal is the codebook.
    The proposal merges one gap at a time (minutes at a background of 500
    voxels), so it is computed only when it is used; the result is the
    reference's either way."""
    d, h, w = grid.values.shape
    table2d = grid.values.permute(1, 0, 2).reshape(h, d * w)
    if torch.unique(table2d).numel() <= max_codes:
        fallback = torch.zeros(max_codes, dtype=torch.float32)  # not used
    else:
        fallback = torch.as_tensor(_proposal_book(voxel_size, background, max_codes))
    book = build_device_codebook(table2d, fallback)
    return encode_table(table2d, book), book

"""Precomputed range LUT for the beam model, CDDT style (port of
``beluga_tpu/models/sensor/beam_lut.py``).

The map is static, so the range to the first obstacle from every cell in
every bearing bin is cast once per map load,

    ranges[k, yi, xi] = cast(centre of cell (xi, yi), θ_k = 2πk / K),

after which a beam evaluation is two table reads (the bearing blended
between its two bins) and the beam mixture.  The build casts the K × H × W
rays in one call of ``ops/raycast.py:cast_rays``, so kernel R1 runs it on
the card.  :func:`beam_lut_weights` reads the table by a plain tensor
gather, or through kernel B7 (``ops/cuda_beam_lut.py``) when it is given the
bf16 windowed table.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.models.sensor.beam import (
    BeamModelParams,
    exact_mixture,
    ranges_and_bearings,
)
from beluga_tpu_torch.ops.cuda_beam import mixture_pz3
from beluga_tpu_torch.ops.cuda_beam_lut import TWO_PI, beam_lut_windowed
from beluga_tpu_torch.ops.cuda_winlut import floor_mod
from beluga_tpu_torch.ops.raycast import cast_rays

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RangeLut:
    """``ranges[K, H, W]``: the cast distance per bearing bin from each
    cell centre (``max_range`` where the cast misses)."""

    ranges: Tensor
    resolution: float
    origin_inv: SE2  # world -> grid-local
    n_bearings: int
    max_range: float


def build_range_lut(grid: OccupancyGrid, max_range: float, n_bearings: int = 64) -> RangeLut:
    """Cast every (cell, bearing bin): ``n_bearings × H × W`` rays in one
    call, on the grid's device."""
    h, w = grid.height, grid.width
    dev = grid.device
    res = torch.tensor(grid.resolution, dtype=torch.float32, device=dev)
    thetas = torch.arange(n_bearings, dtype=torch.float32, device=dev) * (
        2.0 * math.pi / n_bearings)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * res
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * res
    src = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)
    dirs = torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)[:, None, None, :]
    dist, hit = cast_rays(grid, src[None], dirs, max_range)  # [K, H, W]
    return RangeLut(ranges=torch.where(hit, dist, max_range), resolution=grid.resolution,
                    origin_inv=grid.origin.inverse(), n_bearings=n_bearings,
                    max_range=float(max_range))


def lut_cells(lut: RangeLut, states: SE2):
    """Grid-local poses and their clipped cells ``(local, xi, yi)``, int32."""
    local = lut.origin_inv @ states
    _, h, w = lut.ranges.shape
    res = torch.tensor(lut.resolution, dtype=torch.float32, device=local.xy.device)
    xi = torch.clamp(torch.floor(local.x / res), 0, w - 1).to(torch.int32)
    yi = torch.clamp(torch.floor(local.y / res), 0, h - 1).to(torch.int32)
    return local, xi, yi


def beam_lut_weights(params: BeamModelParams, lut: RangeLut, states: SE2, points: Tensor,
                     beam_mask: Tensor, lut_bf16: Tensor | None = None) -> Tensor:
    """AMCL-parity beam weights ``Σ pz³`` through the range LUT,
    ``f32[..., N]``: the mixture of models/sensor/beam.py with ``z_mean``
    read from the LUT and blended between two bearing bins.

    ``lut_bf16`` (``ops.cuda_beam_lut.build_lut_bf16``) selects kernel B7,
    the windowed fleet path, on any device (its plain version on the CPU;
    the reference falls back to the gather off its TPU).  Out-of-window
    strays there read the max range; otherwise the table is read by a
    gather."""
    px, py = points[..., 0], points[..., 1]
    beam_bearing = torch.atan2(py, px)
    local, xi, yi = lut_cells(lut, states)
    if lut_bf16 is not None:
        z = torch.sqrt(px * px + py * py)
        mix = (params.z_hit, params.z_short, params.z_rand, params.z_max, params.sigma_hit,
               params.lambda_short, params.beam_max_range)
        return beam_lut_windowed(lut_bf16, local.theta, xi, yi, z, beam_bearing, beam_mask,
                                 lut.max_range, mix)
    z, _ = ranges_and_bearings(points)
    k, h, w = lut.ranges.shape
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=z.device)
    theta = local.theta[..., :, None] + beam_bearing[..., None, :]  # [..., N, nb]
    ft = floor_mod(theta, two_pi) / two_pi * k
    fl = torch.floor(ft)
    k0 = torch.remainder(torch.nan_to_num(fl).long(), k)  # a masked NaN beam reads bin 0
    k1 = torch.remainder(k0 + 1, k)
    a = ft - fl
    cell = yi.long()[..., None] * w + xi.long()[..., None]
    flat = lut.ranges.reshape(-1)
    r0, r1 = flat[k0 * (h * w) + cell], flat[k1 * (h * w) + cell]
    z_mean = (1.0 - a) * r0 + a * r1
    pz3 = mixture_pz3(z[..., None, :], z_mean, exact_mixture(params), erf=torch.erf)
    return torch.sum(torch.where(beam_mask[..., None, :], pz3, 0.0), dim=-1)

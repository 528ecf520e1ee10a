"""Plain reference of the likelihood-field sensor model in the fleet's
``codebook16`` form (nav2's ``likelihood_field`` model, Thrun's
likelihood field; likelihood_field_model.hpp).

The field is worked out again from the occupancy grid: the exact Euclidean
distance of every cell to the nearest occupied cell (scipy's
``distance_transform_edt``), ``pz = z_hit / (σ√(2π)) · exp(-d² / 2σ²) +
z_rand / laser_max_range`` in float64, the distance capped at
``laser_likelihood_max_dist`` (nav2's mapping of its parameters), and the
table the configuration states, ``pz³`` rounded to bfloat16.  A particle's
log-weight is ``log(1 + Σ pz³)`` over its unmasked beams, an endpoint off
the map reading ``(1 / laser_max_range)³``.  Each endpoint's cell is
``floor(x / res)`` of the endpoint composed in float32 in the model's own
order (``x = px·cos − py·sin + tx``), the order the port's kernels are
held to, so that the cells are the program's and the gap is the sum's
rounding alone.

The control reads the table in float8 (e4m3) and computes in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mclbench.reference.common import F64, LOW, free_cell_distance, low_free_cells

OCCUPIED = 100


class Sensor:
    draws_free_cells = True

    def __init__(self, data: np.ndarray, config: dict, device):
        from scipy.ndimage import distance_transform_edt

        lf = config["likelihood_field"]
        self.res = float(config["map"]["resolution"])
        self.device = device
        d = distance_transform_edt(data != OCCUPIED)
        d2 = np.minimum(np.round(d * d), (lf["laser_likelihood_max_dist"] / self.res) ** 2)
        d2 = d2 * self.res * self.res
        sigma = lf["sigma_hit"]
        amplitude = lf["z_hit"] / (sigma * math.sqrt(2.0 * math.pi))
        offset = lf["z_rand"] / lf["laser_max_range"]
        pz = amplitude * np.exp(-d2 / (2.0 * sigma * sigma)) + offset
        cube = torch.as_tensor(pz * pz * pz, dtype=F64)
        self.table = cube.to(torch.float32).to(torch.bfloat16).to(F64).to(device)
        self.table_low = cube.to(torch.float32).to(torch.float8_e4m3fn).to(F64).to(device)
        self.unknown3 = (1.0 / lf["laser_max_range"]) ** 3
        self.free = data == 0
        self.free_t = torch.as_tensor(self.free, device=device)

    def log_weight(self, xy, rot, points, mask, low: bool = False) -> torch.Tensor:
        """``f64[R, N]`` log-weights of states ``xy f32[R, N, 2]``, ``rot
        f32[R, N, 2]`` (cos, sin) for each robot's scan ``points f32[R, nb,
        2]``, ``mask bool[R, nb]``."""
        dt = LOW if low else torch.float32
        c, s = rot[..., 0, None].to(dt), rot[..., 1, None].to(dt)
        tx, ty = xy[..., 0, None].to(dt), xy[..., 1, None].to(dt)
        px, py = points[:, None, :, 0].to(dt), points[:, None, :, 1].to(dt)
        x = px * c - py * s + tx
        y = px * s + py * c + ty
        res = torch.full((), self.res, dtype=dt, device=x.device)
        fx, fy = torch.floor(x / res), torch.floor(y / res)
        h, w = self.table.shape
        inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
        table = self.table_low if low else self.table
        v = table[fy.clamp(0, h - 1).long(), fx.clamp(0, w - 1).long()]
        v = torch.where(inside, v, self.unknown3)
        v = torch.where(mask[:, None, :], v, 0.0)
        if not low:
            return torch.log1p(v.sum(-1))
        acc = torch.ones(v.shape[:-1], dtype=LOW, device=v.device)
        for j in range(v.shape[-1]):
            acc = acc + v[..., j].to(LOW)
        return torch.log(acc).to(F64)

    @staticmethod
    def gap(got: torch.Tensor, want: torch.Tensor, *states) -> float:
        """The widest log-weight gap: the cells are exact, so every gap is
        the sum's rounding."""
        return float((got - want).abs().max())

    def recovery_gap(self, xy, rot) -> float:
        d = free_cell_distance(xy, self.free_t, self.res)
        norm = (torch.hypot(rot[..., 0].to(F64), rot[..., 1].to(F64)) - 1.0).abs()
        return float(torch.maximum(d, norm).max()) if d.numel() else 0.0

    def recovery_distance(self, xy, th) -> torch.Tensor:
        return free_cell_distance(xy, self.free_t, self.res)

    def low_pool(self, shape, gen, device):
        return low_free_cells(shape, self.free, self.res, gen, device)

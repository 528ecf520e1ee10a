"""Plain reference of the 2D NDT sensor model (beluga's
``ndt_sensor_model.hpp``: Biber and Straßer's normal distributions
transform as a particle weight).

The map is worked out again from the occupancy grid: every occupied cell's
centre is a point, the points fall in square cells of ``cell_size`` and
each cell of at least ``map_min_points`` points gets its mean and sample
covariance, the diagonal floored at ``map_min_variance`` (beluga_tools'
``fit_normal_distribution``).  Each robot's scan is fitted the same way in
its own frame, cells by truncation of ``p / cell_size``, at least 5 points
a cell and a floor of 1e-5 (``to_cells``, hpp:86-111).  A particle's
weight is ``1 + Σ_cells max(Σ_stencil d1·exp(-d2/2 · eᵀ(Σa + Σb)⁻¹e),
min_likelihood)`` over the 3x3 stencil of map cells around the cell of
each measurement's mean in the world (hpp:112-147, 218-239), in float64.
The stencil's centre cell is taken from the world mean composed in float32
in the model's order (``c·m₀ − s·m₁ + tx``, ``s·m₀ + c·m₁ + ty``), as the
port's kernels are held to.  The measurement means enter it as float64
values rounded to float32, which may sit some ulps from the program's own
float32 sums; so where a world mean lies within ``EDGE_TOL`` of a cell
edge, the cell on either side is a candidate centre, and the gap of that
particle is the smallest over the candidates.  The gap compared is the
widest over every particle.

The control computes all of it in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from mclbench.reference.common import F64, LOW

OCCUPIED = 100
STENCIL = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]
MEAS_MIN_POINTS, MEAS_MIN_VARIANCE = 5, 1e-5
PAD = 2
EDGE_TOL = 1e-5  # m: about 40 float32 ulps of a 3.5 m mean


def fit_cells(points: np.ndarray, size: float, min_points: int, min_variance: float):
    """``{(cx, cy): (mean f64[2], cov f64[2, 2])}`` of the points' cells
    (floor of ``p / size``) holding at least ``min_points`` points."""
    keys = np.floor(points / size).astype(np.int64)
    out = {}
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    for k, key in enumerate(uniq):
        pts = points[inv.reshape(-1) == k]
        if len(pts) < min_points:
            continue
        cov = np.cov(pts.T)
        for i in range(2):
            cov[i, i] = max(cov[i, i], min_variance)
        out[tuple(int(v) for v in key)] = (pts.mean(0), cov)
    return out


def measurement_cells(points: np.ndarray, mask: np.ndarray, size: float):
    """The scan's cells (``to_cells``): float32 points, cells by truncation
    of ``p / size`` in float32; means and covariances ``f64[C, 2]``,
    ``f64[C, 2, 2]``."""
    p = points[mask]
    cell = np.trunc(p / np.float32(size)).astype(np.int64)
    means, covs = [], []
    uniq, inv = np.unique(cell, axis=0, return_inverse=True)
    for k in range(len(uniq)):
        q = p[inv.reshape(-1) == k].astype(np.float64)
        if len(q) < MEAS_MIN_POINTS:
            continue
        cov = np.cov(q.T)
        for i in range(2):
            cov[i, i] = max(cov[i, i], MEAS_MIN_VARIANCE)
        means.append(q.mean(0))
        covs.append(cov)
    return np.asarray(means, np.float64).reshape(-1, 2), np.asarray(covs).reshape(-1, 2, 2)


class Sensor:
    draws_free_cells = False

    def __init__(self, data: np.ndarray, config: dict, device):
        nd = config["ndt"]
        res = float(config["map"]["resolution"])
        self.size = float(nd["cell_size"])
        self.d1, self.d2, self.min_lik = nd["d1"], nd["d2"], nd["minimum_likelihood"]
        yy, xx = np.nonzero(data == OCCUPIED)
        pts = np.stack([xx, yy], -1).astype(np.float64) * res + res / 2.0
        cells = fit_cells(pts, self.size, nd["map_min_points"], nd["map_min_variance"])
        keys = np.asarray(list(cells))
        self.lo = keys.min(0) - PAD
        span = keys.max(0) + PAD + 1 - self.lo
        index = np.full(span, -1, np.int64)
        for i, k in enumerate(cells):
            index[k[0] - self.lo[0], k[1] - self.lo[1]] = i
        self.index = torch.as_tensor(index, device=device)
        self.means = torch.as_tensor(np.stack([v[0] for v in cells.values()]), device=device)
        self.covs = torch.as_tensor(np.stack([v[1] for v in cells.values()]), device=device)
        self.device = device

    def _rows(self, centre: torch.Tensor, ox: int, oy: int):
        """The map row of the stencil probe ``(ox, oy)`` about each centre
        cell ``int64[..., 2]``, and whether a map cell is there."""
        lo = torch.as_tensor(self.lo, device=centre.device)
        span = torch.as_tensor(self.index.shape, device=centre.device)
        q = centre + torch.as_tensor([ox, oy], device=centre.device) - lo
        inside = ((q >= 0) & (q < span)).all(-1)
        row = self.index.to(centre.device)[q[..., 0].clamp(0, span[0] - 1),
                                           q[..., 1].clamp(0, span[1] - 1)]
        return row.clamp_min(0), inside & (row >= 0)

    def _cells(self, xy, rot, points, mask, dt):
        """One robot's measurement cells in the world: the float32 (control:
        bfloat16) world means ``wx``, ``wy`` ``[N, C]``, and the Gaussians
        ``mw [N, C, 2]``, ``cw [N, C, 2, 2]`` in ``dt``; ``None`` where the
        scan has no cell."""
        means, covs = measurement_cells(points.cpu().numpy(), mask.cpu().numpy(), self.size)
        if not len(means):
            return None
        m = torch.as_tensor(means, device=xy.device)
        cv = torch.as_tensor(covs, device=xy.device)
        cdt = LOW if dt == LOW else torch.float32
        c32, s32 = rot[:, 0, None].to(cdt), rot[:, 1, None].to(cdt)
        m32 = m.to(cdt)
        wx = c32 * m32[None, :, 0] - s32 * m32[None, :, 1] + xy[:, 0, None].to(cdt)
        wy = s32 * m32[None, :, 0] + c32 * m32[None, :, 1] + xy[:, 1, None].to(cdt)
        c, s = rot[:, 0].to(dt), rot[:, 1].to(dt)
        r = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # [N, 2, 2]
        mw = torch.einsum("nij,cj->nci", r, m.to(dt)) + xy.to(dt)[:, None, :]
        cw = torch.einsum("nij,cjk,nlk->ncil", r, cv.to(dt), r)
        return wx, wy, mw, cw

    def _likelihood(self, centre, mw, cw, dt):
        """Each cell's stencil sum about ``centre`` ``int64[N, C, 2]``,
        floored at the minimum likelihood, ``[N, C]`` in ``dt``."""
        total = torch.zeros(mw.shape[:2], dtype=dt, device=mw.device)
        for ox, oy in STENCIL:
            row, found = self._rows(centre, ox, oy)
            e = mw - self.means[row].to(dt)
            t = cw + self.covs[row].to(dt)
            det = t[..., 0, 0] * t[..., 1, 1] - t[..., 0, 1] * t[..., 1, 0]
            det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
            quad = (e[..., 0] * e[..., 0] * t[..., 1, 1] - e[..., 0] * e[..., 1] * (
                t[..., 0, 1] + t[..., 1, 0]) + e[..., 1] * e[..., 1] * t[..., 0, 0]) / det
            lik = self.d1 * torch.exp((-self.d2 / 2.0) * quad)
            total = total + torch.where(found, lik, torch.zeros_like(lik))
        return torch.clamp_min(total, self.min_lik)

    def _robot(self, xy, rot, points, mask, dt):
        n = xy.shape[0]
        cells = self._cells(xy, rot, points, mask, dt)
        if cells is None:
            return torch.zeros(n, dtype=F64, device=xy.device)
        wx, wy, mw, cw = cells
        size = torch.full((), self.size, dtype=wx.dtype, device=xy.device)
        centre = torch.stack([torch.floor(wx / size), torch.floor(wy / size)], -1).long()
        total = self._likelihood(centre, mw, cw, dt)
        if dt == LOW:
            acc = torch.ones(n, dtype=LOW, device=xy.device)
            for j in range(total.shape[1]):
                acc = acc + total[:, j]
            return torch.log(acc).to(F64)
        return torch.log1p(total.sum(-1))

    def log_weight(self, xy, rot, points, mask, low: bool = False) -> torch.Tensor:
        """``f64[R, N]`` log-weights of states ``xy f32[R, N, 2]``, ``rot
        f32[R, N, 2]`` for each robot's scan ``points f32[R, nb, 2]``,
        ``mask bool[R, nb]``."""
        dt = LOW if low else F64
        return torch.stack([self._robot(xy[i], rot[i], points[i], mask[i], dt)
                            for i in range(xy.shape[0])])

    def gap(self, got, want, xy, rot, points, mask) -> float:
        """The widest gap over every particle of ``got`` ``[R, N]`` from the
        reference's log-weight, each particle's the smallest over its
        candidate centres (see the module); ``want`` is the reference at the
        float32 centres."""
        worst = 0.0
        for i in range(got.shape[0]):
            cells = self._cells(xy[i], rot[i], points[i], mask[i], F64)
            if cells is None:
                worst = max(worst, float((got[i] - want[i]).abs().max()))
                continue
            wx, wy, mw, cw = cells
            cands, near = [], []
            for w in (wx, wy):  # the cells either side of an edge within EDGE_TOL
                u = w.double() / self.size
                edge = torch.round(u)
                close = (u - edge).abs() * self.size < EDGE_TOL
                first = torch.floor(w / torch.full((), self.size, dtype=w.dtype,
                                                   device=w.device)).double()
                other = torch.where(first == edge, edge - 1.0, edge)
                cands.append((first.long(), torch.where(close, other, first).long()))
                near.append(close)
            near = near[0] | near[1]  # [N, C]
            lik = torch.stack([self._likelihood(torch.stack([cx, cy], -1), mw, cw, F64)
                               for cx, cy in ((cands[0][0], cands[1][0]),
                                              (cands[0][1], cands[1][0]),
                                              (cands[0][0], cands[1][1]),
                                              (cands[0][1], cands[1][1]))], -1)  # [N, C, 4]
            base = lik[..., 0].sum(-1)
            # one cell at a time on another centre (where no cell is near an
            # edge, every candidate is the base)
            alt = base[:, None, None] - lik[..., :1] + lik[..., 1:]
            total = torch.cat([base[:, None], alt.reshape(len(base), -1)], -1)
            g = (got[i, :, None].to(F64) - torch.log1p(total)).abs().amin(-1)
            for n in torch.nonzero(near.sum(-1) > 1).reshape(-1).tolist():
                g[n] = _every_choice(got[i, n], lik[n], near[n])  # two or more cells near edges
            worst = max(worst, float(g.max()))
        return worst

    def probe_hits(self, points: torch.Tensor, mask: torch.Tensor,
                   poses: np.ndarray) -> np.ndarray:
        """``int64[K]``: for each scan at its pose ``f64[K, 3]``, the stencil
        probes of its measurement cells that find a map cell."""
        out = np.zeros(len(poses), np.int64)
        for k, (x, y, yaw) in enumerate(poses):
            means, _ = measurement_cells(points[k].numpy(), mask[k].numpy(), self.size)
            if not len(means):
                continue
            c, s = np.cos(yaw), np.sin(yaw)
            w = np.stack([c * means[:, 0] - s * means[:, 1] + x,
                          s * means[:, 0] + c * means[:, 1] + y], -1)
            centre = torch.as_tensor(np.floor(w / self.size).astype(np.int64))
            out[k] = sum(int(self._rows(centre, ox, oy)[1].sum()) for ox, oy in STENCIL)
        return out


def _every_choice(got, lik, near) -> float:
    """The smallest gap of one particle over every choice of centre for its
    cells near an edge (``lik [C, 4]``, ``near bool[C]``)."""
    import itertools

    fixed = float(lik[~near, 0].sum())
    options = [sorted({float(v) for v in lik[c]}) for c in torch.nonzero(near).reshape(-1)]
    return min(abs(float(got) - float(np.log1p(fixed + sum(pick))))
               for pick in itertools.product(*options))

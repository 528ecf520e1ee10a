"""The plain reference of one fleet tick, stage by stage, and the numbers
that decide ``correct``.

A particle filter draws at random, so the reference follows the program
step by step from the program's own state: on each armed tick it takes the
sampled robots' particles as they entered the update and the standard
normals the motion model drew, and checks each stage's output against its
own computation of that stage from that stage's inputs.  Poses, odometry
and scans come from the benchmark's traffic, never from the program; the
map tables and the NDT cells are worked out again from the occupancy grid
by the sensor's own reference (``reference/<config>.py``).

The numbers, each against its limit in the configuration file:

* ``motion_gap``: the widest gap, over the sampled robots' particles, of
  the propagated pose (x, y in m, heading in rad) from the reference's
  differential-drive sample (float64) on the same normals;
* ``sensor_gap``: the widest gap, over the sampled robots' particles, of
  the propagated particle's log-weight from the reference's sensor model on
  the same states (the sensor file says where it admits more than one
  reference value);
* ``resample_gap``: the widest distance from an output particle of a robot
  that moved to the nearest particle of the reference's propagation (B2
  takes donors, copies and sorts them; :func:`nearest`, which past
  :data:`ALL_PAIRS_MAX` pairs reads :data:`NEAREST_RADIUS` where none
  lies within it), or, where a recovery state may sit in the slot, from
  the nearest free cell's centre if that is nearer; for a robot that
  stood, from its particle in the same slot before the update (kept bit
  for bit);
* ``resample_ks``: the Kolmogorov-Smirnov distance, times the square root
  of the particle count, between the donors (each output particle's
  nearest reference particle) and the reference's weights, the slots in
  the order of their weights (a multinomial draw reads under 2 nearly
  always), over the outputs that have a donor within the radius;
* ``recovery_gap`` (a sensor whose recovery draws free cells): the widest
  distance of a drawn recovery state from the centre of a free cell;
* ``estimate_gap``: the widest gap, over every robot of the fleet on the
  last armed tick, of the estimate read back from the reference's
  weighted mean of the robot's output particles.

The control (``low=True``) puts this reference, computed in bfloat16 (the
likelihood field's bf16 table in float8), in the program's place and takes
the same numbers; it has to fail at least one of them.

:func:`check` is the check of a configuration whose reference module
(``reference/<reference>.py``) defines none.  One that does brings its
own, with the same signature, ``check(records, inputs, sensor, config,
device, low=False, seed=0) -> dict``: it returns some of :data:`NUMBERS`,
each of which the configuration's ``limits`` must hold, and what a
driver's records hold is agreed between that driver and that check.  The
pieces here (:func:`nearest`, :func:`ks_distance`, :func:`motion`,
:func:`pose_gap`, :func:`thrun_probability`) take one filter of 2097152
particles as well as a fleet's.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

F64 = torch.float64
LOW = torch.bfloat16
NUMBERS = ("motion_gap", "sensor_gap", "resample_gap", "resample_ks", "recovery_gap",
           "estimate_gap")
# m and rad: how far :func:`nearest` looks for a donor; every configuration's
# resample_gap limit lies below it
NEAREST_RADIUS = 0.01
ALL_PAIRS_MAX = 4096 * 4096  # N·M up to which nearest searches every pair
_CELL = NEAREST_RADIUS * (1.0 + 1e-6)  # x, y cells: the radius and _EPS reach one cell
_BINS = int(2.0 * math.pi / NEAREST_RADIUS)  # heading bins, each wider than the radius
_WIDTH = torch.tensor([_CELL, _CELL, 2.0 * math.pi / _BINS], dtype=F64)
_OFFSETS = torch.tensor([d for d in itertools.product((-1, 0, 1), repeat=3) if any(d)])
_EPS = 1e-9  # added to each reach: above the rounding of a coordinate or a gap
_OUTPUTS = 1 << 18  # outputs a block of the grid search
_PAIRS = 1 << 23  # output-reference pairs a pass of the grid search
_NONE = torch.iinfo(torch.int64).max


def wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def pose_gap(xy_a, th_a, xy_b, th_b) -> torch.Tensor:
    """``max(|Δx|, |Δy|, |Δθ|)`` elementwise, the heading wrapped."""
    d = (xy_a - xy_b).abs().amax(-1)
    return torch.maximum(d, wrap(th_a - th_b).abs())


def heading(rot: torch.Tensor) -> torch.Tensor:
    return torch.atan2(rot[..., 1], rot[..., 0])


def motion(z, xy, theta, pose, prev, alphas, dist_threshold, dtype=F64):
    """Differential-drive sample (Thrun table 5.6, the rot1 - translate -
    rot2 decomposition of the odometry delta), for ``R`` robots: ``z``
    ``[R, 3, N]`` standard normals, states ``xy [R, N, 2]``, ``theta [R,
    N]``, odometry ``pose``, ``prev`` ``[R, 3]``; in ``dtype``."""
    z, xy, theta, pose, prev = (t.to(dtype) for t in (z, xy, theta, pose, prev))
    a1, a2, a3, a4 = alphas
    tx, ty = pose[:, 0] - prev[:, 0], pose[:, 1] - prev[:, 1]
    dist = torch.sqrt(tx * tx + ty * ty)
    rot1 = torch.where(dist > dist_threshold, wrap(torch.atan2(ty, tx) - prev[:, 2]),
                       torch.zeros_like(dist))
    rot2 = wrap(pose[:, 2] - prev[:, 2] - rot1)

    def rvar(r):
        d = torch.minimum(r.abs(), wrap(r + math.pi).abs())
        return d * d

    v1, v2, dv = rvar(rot1), rvar(rot2), dist * dist
    sd1 = torch.sqrt(a1 * v1 + a2 * dv)
    sdt = torch.sqrt(a3 * dv + a4 * (v1 + v2))
    sd2 = torch.sqrt(a1 * v2 + a2 * dv)
    r1 = rot1[:, None] + sd1[:, None] * z[:, 0]
    tr = dist[:, None] + sdt[:, None] * z[:, 1]
    r2 = rot2[:, None] + sd2[:, None] * z[:, 2]
    th1 = theta + r1
    new_xy = xy + torch.stack([torch.cos(th1) * tr, torch.sin(th1) * tr], -1)
    return new_xy, th1 + r2


def thrun_probability(thrun: torch.Tensor, avg: float, alpha_slow: float,
                      alpha_fast: float) -> torch.Tensor:
    """Thrun's random-state probability after this update, from the filters'
    ``[R, 4]`` (slow, slow seeded, fast, fast seeded) as the update found
    them and the post-normalize average weight ``avg``."""
    t = thrun.to(F64)

    def step(value, seeded, alpha):
        return torch.where(seeded > 0, value + alpha * (avg - value), torch.full_like(value, avg))

    slow, fast = step(t[:, 0], t[:, 1], alpha_slow), step(t[:, 2], t[:, 3], alpha_fast)
    safe = torch.where(slow.abs() < 1e-38, torch.ones_like(slow), slow)
    p = torch.clamp(1.0 - fast / safe, 0.0, 1.0)
    return torch.where(slow.abs() < float(torch.finfo(torch.float32).eps), 0.0, p)


def nearest(out_xy, out_th, ref_xy, ref_th, chunk: int = 1024):
    """For each output particle ``[N]``, the distance to and the index of
    the nearest reference particle ``[M]`` (``pose_gap``, ties to the
    lowest index).

    While ``N·M`` is at most :data:`ALL_PAIRS_MAX` (every filter of a
    fleet), the search over every pair (:func:`all_pairs`, ``chunk``
    outputs at a time).  Past that a grid of the reference particles, with
    memory bounded whatever ``N`` and ``M`` are: where the nearest lies
    within :data:`NEAREST_RADIUS`, both are those of :func:`all_pairs`,
    bit for bit on the card (on the CPU in one thread); where none does,
    the output reads ``NEAREST_RADIUS``, a lower bound, and the index -1."""
    n, m = out_xy.shape[0], ref_xy.shape[0]
    if n * m <= ALL_PAIRS_MAX:
        return all_pairs(out_xy, out_th, ref_xy, ref_th, chunk)
    dt = torch.promote_types(out_xy.dtype, ref_xy.dtype)
    dist = torch.full((n,), math.inf, dtype=dt, device=out_xy.device)
    idx = torch.full((n,), -1, dtype=torch.int64, device=out_xy.device)
    grid = _Grid(ref_xy, ref_th)
    for s in range(0, n, _OUTPUTS):
        grid.search(out_xy[s:s + _OUTPUTS], out_th[s:s + _OUTPUTS], dist[s:s + _OUTPUTS],
                    idx[s:s + _OUTPUTS])
    far = ~(dist <= NEAREST_RADIUS)
    dist[far], idx[far] = NEAREST_RADIUS, -1
    return dist, idx


class _Grid:
    """The finite reference particles sorted by cell: a hair over
    :data:`NEAREST_RADIUS` wide in x and y over their box, ``2π /
    _BINS`` in heading, the bins wrapping across ±π; so every particle
    within the radius of a point lies in the point's cell or one of its
    26 neighbours."""

    def __init__(self, xy, th):
        self.xy, self.th = xy, th
        finite = torch.nonzero(torch.isfinite(xy).all(-1) & torch.isfinite(th)).squeeze(1)
        xy, th = xy[finite], th[finite]
        self.origin = xy.amin(0) if len(finite) else xy.new_zeros(2)
        cell = torch.floor(self.units(xy, th)).long()
        cell[:, 2].clamp_(0, _BINS - 1)
        self.shape = (cell[:, :2].amax(0) + 1).tolist() if len(finite) else [0, 0]
        self.keys, order = torch.sort(self.key(cell))
        self.order = finite[order]

    def units(self, xy, th):
        """Coordinates in cells: ``[..., 3]`` (x, y, heading)."""
        xy = (xy - self.origin) / _CELL
        t = torch.remainder(th + math.pi, 2.0 * math.pi) * (_BINS / (2.0 * math.pi))
        return torch.cat([xy, t[..., None]], -1)

    def key(self, cell):
        return (cell[..., 0] * self.shape[1] + cell[..., 1]) * _BINS + cell[..., 2]

    def search(self, out_xy, out_th, dist, idx) -> None:
        """Lower ``dist``, ``idx`` of the outputs to their nearest reference
        particle within the radius: first in each output's own cell, then
        in the neighbours that the cube of the distance found so far (at
        most the radius) reaches."""
        ok = torch.isfinite(out_xy).all(-1) & torch.isfinite(out_th)
        u = self.units(torch.where(ok[:, None], out_xy, 0.0), torch.where(ok, out_th, 0.0))
        # far outside the box, two cells from it: no reference particle within reach
        top = torch.tensor([*self.shape, _BINS], dtype=u.dtype, device=u.device) + 1.0
        u = torch.minimum(torch.maximum(u, torch.full_like(u, -2.0)), top)
        cell = torch.floor(u).long()
        cell[:, 2].clamp_(0, _BINS - 1)
        own = ok & (cell[:, :2] >= 0).all(-1) & (cell[:, 0] < self.shape[0]) & (
            cell[:, 1] < self.shape[1])
        rows = torch.nonzero(own).squeeze(1)
        self._scan(rows, self.key(cell[rows]), out_xy, out_th, dist, idx)

        reach = (dist.clamp(max=NEAREST_RADIUS) + _EPS)[:, None] / _WIDTH.to(u)
        lo = torch.floor(u - reach).long()
        hi = torch.floor(u + reach).long()
        near = cell[:, None, :] + _OFFSETS.to(cell.device)  # [n, 26, 3]
        inside = ((near >= lo[:, None]) & (near <= hi[:, None])).all(-1)
        inside &= ok[:, None] & (near[..., :2] >= 0).all(-1)
        inside &= (near[..., 0] < self.shape[0]) & (near[..., 1] < self.shape[1])
        near[..., 2] %= _BINS
        rows, which = torch.nonzero(inside, as_tuple=True)
        self._scan(rows, self.key(near[rows, which]), out_xy, out_th, dist, idx)

    def _scan(self, rows, keys, out_xy, out_th, dist, idx) -> None:
        """Merge into ``dist``, ``idx`` the pairs of each output ``rows[s]``
        with every reference particle in cell ``keys[s]``, :data:`_PAIRS`
        pairs at a time."""
        start = torch.searchsorted(self.keys, keys)
        count = torch.searchsorted(self.keys, keys, right=True) - start
        some = count > 0
        rows, start, count = rows[some], start[some], count[some]
        if not len(count):
            return
        end = torch.cumsum(count, 0)
        total = int(end[-1])
        first = end - count
        for a in range(0, total, _PAIRS):
            k = torch.arange(a, min(a + _PAIRS, total), device=end.device)
            s = torch.searchsorted(end, k, right=True)
            o = rows[s]
            j = self.order[start[s] + k - first[s]]
            g = _gaps(out_xy, out_th, self.xy, self.th, o, j)
            best = torch.full_like(dist, math.inf).scatter_reduce(0, o, g, "amin")
            low = torch.full_like(idx, _NONE).scatter_reduce(
                0, o, torch.where(g == best[o], j, _NONE), "amin")
            tie = (best == dist) & (idx >= 0)
            idx.copy_(torch.where(best < dist, low,
                                  torch.where(tie, torch.minimum(idx, low), idx)))
            torch.minimum(dist, best, out=dist)


def _gaps(out_xy, out_th, ref_xy, ref_th, o, j):
    """``pose_gap`` of the pairs ``(o, j)``.  Their count is padded to a
    multiple of 16, so that on the CPU every heading takes the vector
    path of ``atan2``, as each pair does in :func:`all_pairs` (its scalar
    tail can differ in the last bit)."""
    t = o.numel()
    pad = -t % 16
    if pad:
        o = torch.cat([o, o.new_zeros(pad)])
        j = torch.cat([j, j.new_zeros(pad)])
    return pose_gap(out_xy[o], out_th[o], ref_xy[j], ref_th[j])[:t]


def all_pairs(out_xy, out_th, ref_xy, ref_th, chunk: int = 1024):
    """:func:`nearest` over every pair, ``chunk`` outputs at a time."""
    dist, idx = [], []
    for s in range(0, out_xy.shape[0], chunk):
        d = pose_gap(out_xy[s:s + chunk, None], out_th[s:s + chunk, None], ref_xy[None],
                     ref_th[None])
        m = d.min(-1)
        dist.append(m.values)
        idx.append(m.indices)
    return torch.cat(dist), torch.cat(idx)


def ks_distance(donors: torch.Tensor, weights: torch.Tensor) -> float:
    """``sqrt(n) · max |F_donors − F_weights|`` with the slots taken in
    the order of their weights, where a draw that does not follow the
    weights departs the most."""
    n = donors.numel()
    order = torch.argsort(weights)
    counts = torch.bincount(donors, minlength=weights.numel()).to(F64)[order]
    emp = torch.cumsum(counts, 0) / n
    cdf = torch.cumsum(weights[order], 0) / weights.sum()
    return float(math.sqrt(n) * (emp - cdf).abs().max())


def low_resample(prop_xy, prop_th, logw_low, gen):
    """The control's resample: a multinomial draw of ``N`` sorted uniforms
    on the CDF of bfloat16 weights, the running sum accumulated in
    bfloat16; returns the donors' states."""
    w = torch.softmax(logw_low.to(LOW).float(), -1).to(LOW)
    cdf = torch.empty_like(w)
    acc = torch.zeros(w.shape[:-1], dtype=LOW, device=w.device)
    for i in range(w.shape[-1]):
        acc = acc + w[..., i]
        cdf[..., i] = acc
    u = torch.sort(torch.rand(w.shape, generator=gen, dtype=F64, device="cpu"), -1).values
    cdf64 = cdf.to(F64)
    donors = torch.searchsorted(cdf64, (u * cdf64[..., -1:].cpu()).to(w.device))
    donors = donors.clamp_max(w.shape[-1] - 1)
    take = torch.gather
    xy = take(prop_xy, 1, donors[..., None].expand(*donors.shape, 2))
    return xy, take(prop_th, 1, donors)


def low_estimate(xy, rot, logw):
    w = torch.softmax(logw.to(LOW).float(), -1).to(LOW)
    mx = (w[..., None] * xy.to(LOW)).sum(-2)
    mz = (w[..., None] * rot.to(LOW)).sum(-2)
    return mx.to(F64), torch.atan2(mz[..., 1].to(F64), mz[..., 0].to(F64))


def check(records: list, inputs: dict, sensor, config: dict, device, low: bool = False,
          seed: int = 0) -> dict:
    """The numbers of :data:`NUMBERS` over the armed ticks ``records``
    (``drivers/fleet.py:Fleet.arm``, each with its ``tick`` of the traffic
    and ``est``, the estimates read back).  ``inputs`` holds the
    benchmark's lattice poses ``f32[K, 3]`` and scans ``points``, ``mask``
    on the host; ``sensor`` is the configuration's sensor reference."""
    f = config["filter"]
    alphas = config["motion_alphas"]
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = {k: 0.0 for k in NUMBERS}
    if not sensor.draws_free_cells:
        del out["recovery_gap"]
    lattice = inputs["poses"]
    for rec in records:
        tick = rec["tick"]
        rows = rec["rows"].cpu()
        moved = torch.as_tensor(tick.moved[rows.numpy()] | (tick.t == 0))
        pose = lattice[torch.as_tensor(tick.idx)[rows]].to(device)
        prev = lattice[torch.as_tensor(tick.prev_idx)[rows]].to(device)
        in_xy, in_rot = rec["in_xy"].to(device), rec["in_rot"].to(device)
        in_th = heading(in_rot.to(F64))
        n = in_xy.shape[-2]
        if "z" not in rec:  # no filter was due, so the update propagated none
            if bool(moved.any()):
                out["motion_gap"] = math.inf
            o_xy, o_th = (in_xy, in_th) if low else (
                rec["out_xy"].to(device), heading(rec["out_rot"].to(device).to(F64)))
            kept = pose_gap(o_xy.to(F64), o_th.to(F64), in_xy.to(F64), in_th)
            out["resample_gap"] = max(out["resample_gap"], float(kept.max()))
        else:
            z = rec["z"].to(device)
            ref_xy, ref_th = motion(z, in_xy, in_th, pose, prev, alphas, 0.01)
            if low:
                lx, lt = motion(z, in_xy, heading(in_rot.to(LOW)), pose, prev, alphas, 0.01, LOW)
                prop_xy, prop_th = lx.float(), lt.float()
                prop_rot = torch.stack([torch.cos(prop_th), torch.sin(prop_th)], -1)
            else:
                prop_xy, prop_rot = rec["prop_xy"].to(device), rec["prop_rot"].to(device)
                prop_th = heading(prop_rot.to(F64))
            idx = torch.as_tensor(tick.idx)[rows]
            points, mask = inputs["points"][idx].to(device), inputs["mask"][idx].to(device)
            ref_l = sensor.log_weight(prop_xy, prop_rot, points, mask)
            got_l = (sensor.log_weight(prop_xy, prop_rot, points, mask, low=True) if low
                     else rec["loglik"].to(device).to(F64))
            mv = moved.to(device)
            if bool(mv.any()):
                gap = pose_gap(prop_xy.to(F64), prop_th.to(F64), ref_xy, ref_th)[mv]
                out["motion_gap"] = max(out["motion_gap"], float(gap.max()))
                out["sensor_gap"] = max(out["sensor_gap"], sensor.gap(
                    got_l[mv], ref_l[mv], prop_xy[mv], prop_rot[mv], points[mv], mask[mv]))
            p_rand = thrun_probability(rec["in_thrun"].to(device), 1.0 / n, f["alpha_slow"],
                                       f["alpha_fast"])
            logw = rec["in_logw"].to(device).to(F64) + ref_l
            if low:
                o_xy, o_th = low_resample(prop_xy.float(), prop_th.float(),
                                          rec["in_logw"].to(device) + got_l.float(), gen)
            else:
                o_xy = rec["out_xy"].to(device)
                o_th = heading(rec["out_rot"].to(device).to(F64))
            for j in range(len(rows)):
                if not bool(moved[j]):
                    kept = pose_gap(o_xy[j].to(F64), o_th[j].to(F64), in_xy[j].to(F64), in_th[j])
                    out["resample_gap"] = max(out["resample_gap"], float(kept.max()))
                    continue
                d, donors = nearest(o_xy[j].to(F64), o_th[j].to(F64), ref_xy[j], ref_th[j])
                # recovery states may sit in any slot
                if sensor.draws_free_cells and float(p_rand[j]) > 0.0:
                    d = torch.minimum(d, sensor.recovery_distance(o_xy[j], o_th[j]))
                out["resample_gap"] = max(out["resample_gap"], float(d.max()))
                # an output with no donor within the radius (index -1, past
                # ALL_PAIRS_MAX) is resample_gap's: the radius, unless a recovery
                # state explains it; the draw is that of the outputs with one
                some = donors >= 0
                if bool(some.any()):
                    ks = ks_distance(donors[some], torch.softmax(logw[j], -1))
                    out["resample_ks"] = max(out["resample_ks"], ks)
            if "recovery_gap" in out and "pool_xy" in rec:
                if low:
                    pool_xy, pool_rot = sensor.low_pool(rec["pool_xy"].shape, gen, device)
                else:
                    pool_xy, pool_rot = rec["pool_xy"].to(device), rec["pool_rot"].to(device)
                gap = sensor.recovery_gap(pool_xy[mv], pool_rot[mv])
                out["recovery_gap"] = max(out["recovery_gap"], gap)
        if "all_xy" not in rec:
            continue
        # every robot's estimate against the reference's mean of its output particles
        all_xy, all_rot, all_logw = rec["all_xy"], rec["all_rot"], rec["all_logw"]
        for s in range(0, all_xy.shape[0], 512):
            xy = all_xy[s:s + 512].to(device).to(F64)
            rot = all_rot[s:s + 512].to(device).to(F64)
            w = torch.softmax(all_logw[s:s + 512].to(device).to(F64), -1)
            mean_xy = (w[..., None] * xy).sum(-2)
            mz = (w[..., None] * rot).sum(-2)
            mean_th = torch.atan2(mz[..., 1], mz[..., 0])
            if low:
                gx, gth = low_estimate(all_xy[s:s + 512].to(device), all_rot[s:s + 512].to(device),
                                       all_logw[s:s + 512].to(device))
            else:
                est = torch.as_tensor(rec["est"][s:s + 512], device=device).to(F64)
                gx, gth = est[:, :2], est[:, 2]
            gap = pose_gap(gx, gth, mean_xy, mean_th)
            out["estimate_gap"] = max(out["estimate_gap"], float(gap.max()))
    return out


def free_cell_distance(xy: torch.Tensor, free: torch.Tensor, res: float) -> torch.Tensor:
    """Distance of each point ``[..., 2]`` from the centre of its cell, 1 m
    where that cell is not free (``free`` ``bool[H, W]``)."""
    xy = xy.to(F64)
    h, w = free.shape
    c = torch.floor(xy / res)
    inside = (c[..., 0] >= 0) & (c[..., 0] < w) & (c[..., 1] >= 0) & (c[..., 1] < h)
    cx = c[..., 0].clamp(0, w - 1).long()
    cy = c[..., 1].clamp(0, h - 1).long()
    ok = inside & free[cy, cx]
    d = (xy - (c + 0.5) * res).abs().amax(-1)
    return torch.where(ok, d, torch.ones_like(d))


def low_free_cells(shape, free: np.ndarray, res: float, gen, device):
    """The control's recovery draw: uniform free cells and headings, in
    bfloat16; ``(xy, rot)`` of ``shape[:-1]`` states."""
    ys, xs = np.nonzero(free)
    k = torch.randint(0, len(xs), shape[:-1], generator=gen)
    xy = torch.stack([torch.as_tensor((xs + 0.5) * res)[k], torch.as_tensor((ys + 0.5) * res)[k]],
                     -1)
    th = torch.rand(shape[:-1], generator=gen, dtype=F64) * 2 * math.pi - math.pi
    xy, th = xy.to(LOW).to(device), th.to(LOW).to(device)
    return xy.float(), torch.stack([torch.cos(th), torch.sin(th)], -1).float()

"""Plain reference of a fleet of nav2-default AMCL filters under KLD
(``configs/nav2_fleet.json``: 500 to 2000 particles a filter in 2000
slots, Thrun's injection slot by slot), and its own check (``harness``
takes it as ``ref.check``).

The sensor is ``reference/lf_fleet.py``'s.  The motion, the donor search
and the Kolmogorov-Smirnov distance are ``reference/common.py``'s.  What
the adaptive count adds, stated after beluga:

* **the spatial hash** (``algorithm/spatial_hash.hpp:44-197``): each of x,
  y and the heading ``atan2(sin, cos)`` divided by its bin (0.5 m, 0.5 m,
  10°) in float32 IEEE, as the program divides, floored, taken as the
  32 bits of an int32, Fibonacci-hashed (times ``2^32 / φ`` modulo
  ``2^32``), rotated left by ``10 · axis`` bits and XOR-folded;
* **the take-while** (``views/take_while_kld.hpp:72-137``): the candidates
  in draw order, one at a time, each adding its bucket to a set; the
  ``count``-th is kept while ``count ≤ min`` or ``count ≤ target(k)``, ``k``
  the buckets so far, ``target(k) = ceil((k − 1) / 2ε · (1 − 2 / 9(k − 1)
  + √(2 / 9(k − 1)) · z)³)`` in float64 (unbounded for ``k ≤ 2``), and at
  most ``max`` are kept.  The program computes ``target`` in float32: the
  two differ only at ``k`` of 999 and more (ε 0.05, z 0.99), where either
  lies far past 2000, so the counts are the same integers;
* **Thrun's probability** from the filter's slow and fast averages as the
  update found them and its post-normalize average weight ``1 / active``,
  in float32 as the program holds them (the same operations, so the
  probability is 0 exactly where the program's is: whether a recovery
  state may sit in a slot must not turn on a rounding).

**The check** (:func:`check`) returns the six ``common.NUMBERS`` over the
armed ticks, from the records of ``drivers/kld_fleet.py``:

* ``motion_gap`` and ``sensor_gap`` over every slot of each sampled
  filter that moved (the program moves and weighs the dead slots too);
* ``resample_gap``: the widest distance from a live output to the nearest
  live propagated particle, over the outputs that are not recovery
  states, and the widest output log-weight (a resampled particle restarts
  at log 0).  It reads infinite where the adaptive stages part from the
  reference: a hash that differs from the reference's; a count that
  differs from the take-while's on the same candidates; a live prefix
  (the slots below ``active`` after the θ sort) that is not the first
  ``active`` candidates bit for bit, in some order; a recovery state in a
  slot at a probability of 0, or a number of them outside 6σ of
  Binomial(2000, p); a filter that stood whose slots or count changed;
* ``resample_ks`` over the live outputs that are not recovery states,
  against the weights of the live inputs;
* ``recovery_gap``: the recovery states' distance from a free cell's
  centre;
* ``estimate_gap``: every robot's estimate on the last armed tick against
  the mean of its live outputs in float64 (their weights are equal).

The control (``low=True``) puts this reference, computed in bfloat16, in
the program's place: its motion, its weights, the count of the program's
candidates rounded to bfloat16, a multinomial draw on a bfloat16 CDF over
the live inputs and its estimate; it has to fail at least one number.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mclbench.reference import common
from mclbench.reference.common import F64, LOW
from mclbench.reference.lf_fleet import Sensor  # noqa: F401  (the harness takes ref.Sensor)

FIB32 = 2654435769  # 2^32 / golden ratio
MASK32 = 0xFFFFFFFF


def spatial_hash(xy: torch.Tensor, rot: torch.Tensor, res: tuple) -> np.ndarray:
    """``uint64[..., N]`` bucket hashes in ``[0, 2^32)`` of float32 states
    ``xy [..., N, 2]``, ``rot [..., N, 2]`` (cos, sin), ``res`` the bins of
    x, y and the heading (rad)."""
    theta = torch.atan2(rot[..., 1], rot[..., 0])
    comps = (xy[..., 0], xy[..., 1], theta)
    bits = 32 // len(comps)
    out = None
    for i, (c, r) in enumerate(zip(comps, res)):
        q = torch.floor(c / torch.tensor(r, dtype=torch.float32, device=c.device))
        v = (q.to(torch.int64).cpu().numpy() & MASK32).astype(np.uint64)
        h = (v * np.uint64(FIB32)) & np.uint64(MASK32)
        s = (bits * i) % 32
        if s:
            h = ((h << np.uint64(s)) | (h >> np.uint64(32 - s))) & np.uint64(MASK32)
        out = h if out is None else out ^ h
    return out


def kld_target(k: int, epsilon: float, z: float) -> float:
    if k <= 2:
        return math.inf
    c = 2.0 / (9 * (k - 1))
    base = 1.0 - c + math.sqrt(c) * z
    return math.ceil((k - 1) / (2.0 * epsilon) * base * base * base)


def take_while(hashes, min_particles: int, max_particles: int, epsilon: float,
               z: float) -> int:
    """How many of the candidates (their hashes, in draw order) the
    sequential take-while keeps."""
    buckets = set()
    for count, h in enumerate(hashes, 1):
        if count > max_particles:
            return max_particles
        buckets.add(h)
        if not (count <= min_particles or count <= kld_target(len(buckets), epsilon, z)):
            return count - 1
    return min(len(hashes), max_particles)


def kld_params(config: dict, particles: int) -> tuple:
    """``(min, max, ε, z, bins)`` of the count; ``min`` capped at a quarter
    of ``particles``, as the driver caps it where the tests shrink it."""
    k = config["kld"]
    bins = (k["spatial_resolution_x"], k["spatial_resolution_y"],
            math.radians(k["spatial_resolution_theta_deg"]))
    return (min(k["min_particles"], particles // 4), particles, k["kld_epsilon"], k["kld_z"],
            bins)


def thrun_probability32(thrun: torch.Tensor, active: torch.Tensor, alpha_slow: float,
                        alpha_fast: float) -> torch.Tensor:
    """Thrun's random-state probability in float32, from the filters' ``[R,
    4]`` (slow, slow seeded, fast, fast seeded) as the update found them
    and their live counts ``active``."""
    avg = 1.0 / torch.clamp_min(active.float(), 1.0)

    def step(value, seeded, alpha):
        return torch.where(seeded > 0, value + alpha * (avg - value), avg)

    slow = step(thrun[:, 0], thrun[:, 1], alpha_slow)
    fast = step(thrun[:, 2], thrun[:, 3], alpha_fast)
    safe = torch.where(torch.abs(slow) < 1e-38, 1.0, slow)
    eps = float(torch.finfo(torch.float32).eps)
    return torch.where(torch.abs(slow) < eps, 0.0,
                       torch.clamp(1.0 - fast / safe, 0.0, 1.0))


def _bits(xy: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """The float32 bits of each state, ``int32[N, 4]``."""
    return torch.cat([xy, rot], -1).float().contiguous().view(torch.int32)


def _rows(bits: torch.Tensor) -> torch.Tensor:
    """The rows of ``bits`` in lexicographic order."""
    order = torch.arange(bits.shape[0], device=bits.device)
    for col in reversed(range(bits.shape[1])):
        order = order[torch.sort(bits[order, col], stable=True).indices]
    return bits[order]


def same_states(a_xy, a_rot, b_xy, b_rot) -> bool:
    """Whether two sets of states are equal bit for bit, in some order."""
    a, b = _bits(a_xy, a_rot), _bits(b_xy, b_rot)
    return a.shape == b.shape and torch.equal(_rows(a), _rows(b))


def injected_count_ok(count: int, n: int, p: float) -> bool:
    """Whether ``count`` recovery states among ``n`` candidates fit a
    Binomial(n, p) within 6σ, and 6 states either way."""
    if p <= 0.0:
        return count == 0
    sd = math.sqrt(n * p * (1.0 - p))
    return n * p - 6.0 * sd - 6.0 <= count <= n * p + 6.0 * sd + 6.0


def check(records: list, inputs: dict, sensor, config: dict, device, low: bool = False,
          seed: int = 0) -> dict:
    """The numbers of ``common.NUMBERS`` over the armed ticks ``records``
    (``drivers/kld_fleet.py:Fleet.arm``, each with its ``tick`` of the
    traffic and ``est``, the estimates read back)."""
    f = config["filter"]
    alphas = config["motion_alphas"]
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = {k: 0.0 for k in common.NUMBERS}
    lattice = inputs["poses"]
    for rec in records:
        tick = rec["tick"]
        rows = rec["rows"].cpu()
        moved = torch.as_tensor(tick.moved[rows.numpy()] | (tick.t == 0))
        in_xy, in_rot = rec["in_xy"].to(device), rec["in_rot"].to(device)
        in_th = common.heading(in_rot.to(F64))
        n = in_xy.shape[-2]
        kmin, kmax, eps, z, bins = kld_params(config, n)
        in_act = rec["in_active"].cpu().tolist()
        out_act = rec["out_active"].cpu().tolist()
        if not low:  # a filter that stood keeps its slots and its count
            for j in torch.nonzero(~moved).squeeze(1).tolist():
                if not (torch.equal(_bits(rec["out_xy"][j], rec["out_rot"][j]),
                                    _bits(rec["in_xy"][j], rec["in_rot"][j]))
                        and in_act[j] == out_act[j]):
                    out["resample_gap"] = math.inf
        if "z" not in rec:  # no filter was due, so the update propagated none
            if bool(moved.any()):
                out["motion_gap"] = math.inf
            continue
        pose = lattice[torch.as_tensor(tick.idx)[rows]].to(device)
        prev = lattice[torch.as_tensor(tick.prev_idx)[rows]].to(device)
        z_n = rec["z"].to(device)
        ref_xy, ref_th = common.motion(z_n, in_xy, in_th, pose, prev, alphas, 0.01)
        if low:
            lx, lt = common.motion(z_n, in_xy, common.heading(in_rot.to(LOW)), pose, prev, alphas,
                                   0.01, LOW)
            prop_xy, prop_th = lx.float(), lt.float()
            prop_rot = torch.stack([torch.cos(prop_th), torch.sin(prop_th)], -1)
        else:
            prop_xy, prop_rot = rec["prop_xy"].to(device), rec["prop_rot"].to(device)
            prop_th = common.heading(prop_rot.to(F64))
        idx = torch.as_tensor(tick.idx)[rows]
        points, mask = inputs["points"][idx].to(device), inputs["mask"][idx].to(device)
        ref_l = sensor.log_weight(prop_xy, prop_rot, points, mask)
        got_l = (sensor.log_weight(prop_xy, prop_rot, points, mask, low=True) if low
                 else rec["loglik"].to(device).to(F64))
        mv = moved.to(device)
        if bool(mv.any()):
            gap = common.pose_gap(prop_xy.to(F64), prop_th.to(F64), ref_xy, ref_th)[mv]
            out["motion_gap"] = max(out["motion_gap"], float(gap.max()))
            out["sensor_gap"] = max(out["sensor_gap"], sensor.gap(
                got_l[mv], ref_l[mv], prop_xy[mv], prop_rot[mv], points[mv], mask[mv]))
        p_rand = thrun_probability32(rec["in_thrun"].to(device), rec["in_active"].to(device),
                                     f["alpha_slow"], f["alpha_fast"]).tolist()
        logw = rec["in_logw"].to(device).to(F64) + ref_l
        cand_xy, cand_rot = rec["cand_xy"].to(device), rec["cand_rot"].to(device)
        hashes = spatial_hash(cand_xy, cand_rot, bins)
        if low:
            low_hashes = spatial_hash(cand_xy.to(LOW).float(), cand_rot.to(LOW).float(), bins)
        elif not np.array_equal(hashes.astype(np.int64), rec["hashes"].cpu().numpy()):
            out["resample_gap"] = math.inf
        pool_xy, pool_rot = rec["pool_xy"].to(device), rec["pool_rot"].to(device)
        for j in range(len(rows)):
            if not bool(moved[j]):
                continue
            a_in = in_act[j]
            want = take_while(hashes[j].tolist(), kmin, kmax, eps, z)
            live_ref = (ref_xy[j, :a_in], ref_th[j, :a_in])
            w_in = torch.softmax(logw[j, :a_in], -1)
            if low:
                gx, gt = common.low_resample(prop_xy[j:j + 1, :a_in], prop_th[j:j + 1, :a_in],
                                             rec["in_logw"][j:j + 1, :a_in].to(device)
                                             + got_l[j:j + 1, :a_in].float(), gen)
                got = take_while(low_hashes[j].tolist(), kmin, kmax, eps, z)
                o_xy, o_th = gx[0].to(F64), gt[0].to(F64)
                fresh = torch.ones(len(o_xy), dtype=torch.bool, device=device)
            else:
                a = got = out_act[j]
                o_xy = rec["out_xy"][j, :a].to(device)
                o_rot = rec["out_rot"][j, :a].to(device)
                # the live prefix is the first `active` candidates, reordered
                if not same_states(o_xy, o_rot, cand_xy[j, :a], cand_rot[j, :a]):
                    out["resample_gap"] = math.inf
                reset = float(rec["out_logw"][j, :a].abs().max()) if a else 0.0
                out["resample_gap"] = max(out["resample_gap"], reset)
                # recovery states: the slots where the candidate is the slot's draw
                drawn = (_bits(cand_xy[j], cand_rot[j]) == _bits(pool_xy[j], pool_rot[j])).all(-1)
                if not injected_count_ok(int(drawn.sum()), n, p_rand[j]):
                    out["resample_gap"] = math.inf
                fresh = ~drawn[:a]
                o_xy, o_th = cand_xy[j, :a].to(F64), common.heading(cand_rot[j, :a].to(F64))
            if got != want:
                out["resample_gap"] = math.inf
            if not bool(fresh.any()):
                continue
            d, donors = common.nearest(o_xy[fresh], o_th[fresh], *live_ref)
            out["resample_gap"] = max(out["resample_gap"], float(d.max()))
            some = donors >= 0
            if bool(some.any()):
                out["resample_ks"] = max(out["resample_ks"],
                                         common.ks_distance(donors[some], w_in))
        if low:
            pool_xy, pool_rot = sensor.low_pool(pool_xy.shape, gen, device)
        if bool(mv.any()):
            out["recovery_gap"] = max(out["recovery_gap"],
                                      sensor.recovery_gap(pool_xy[mv], pool_rot[mv]))
        if "all_xy" not in rec:
            continue
        # every robot's estimate against the mean of its live outputs
        all_xy, all_rot, all_logw = rec["all_xy"], rec["all_rot"], rec["all_logw"]
        all_act = rec["all_active"].to(device)
        for s in range(0, all_xy.shape[0], 512):
            xy = all_xy[s:s + 512].to(device)
            rot = all_rot[s:s + 512].to(device)
            live = torch.arange(xy.shape[1], device=device) < all_act[s:s + 512, None]
            lw = torch.where(live, all_logw[s:s + 512].to(device).to(F64), -math.inf)
            w = torch.softmax(lw, -1)
            mean_xy = (w[..., None] * xy.to(F64)).sum(-2)
            mz = (w[..., None] * rot.to(F64)).sum(-2)
            mean_th = torch.atan2(mz[..., 1], mz[..., 0])
            if low:
                gx, gth = common.low_estimate(xy, rot, lw.float())
            else:
                est = torch.as_tensor(rec["est"][s:s + 512], device=device).to(F64)
                gx, gth = est[:, :2], est[:, 2]
            gap = common.pose_gap(gx, gth, mean_xy, mean_th)
            out["estimate_gap"] = max(out["estimate_gap"], float(gap.max()))
    return out

"""nav2's default AMCL under KLD on a fleet (the benchmark's
``mclbench/configs/nav2_fleet.json``, through ``make_fleet_update``)
against the benchmark's plain reference (``mclbench/reference/
nav2_fleet.py``), on the CPU at 4 robots x 256 slots with
``min_particles`` 64, on seeded clouds.

The count is an integer taken from bit-equal hashes, so the port's must
equal the reference's sequential take-while exactly; the live prefix after
the theta sort is compared bit for bit as a multiset; the estimate to
1e-5 m and rad (float32 sums against float64).  Thrun's injection: at a
random-state probability of 0 no slot holds a recovery state, above it
their number fits Binomial(256, p) within 6 sigma.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from beluga_tpu_torch.algorithms.kld import kld_target_size
from beluga_tpu_torch.algorithms.thrun import ExpFilterState, ThrunState
from beluga_tpu_torch.core.particles import DEAD_LOG_WEIGHT, make_from_states, tree_sort_by
from beluga_tpu_torch.core.random import sample_normal_se2
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
from beluga_tpu_torch.parallel.fleet import make_fleet_update
from beluga_tpu_torch.utils.profiling import count
from mclbench import world
from mclbench.reference import nav2_fleet as ref
from mclbench.sensors import likelihood_field

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B, N = 4, 256
TEN_DEG = math.radians(10.0)


@pytest.fixture(scope="module")
def setup():
    """The configuration's filter on its arena, cut to 256 slots (the
    driver's cap puts ``min_particles`` at 64), and four robots' scans."""
    config = json.loads((ROOT / "mclbench/configs/nav2_fleet.json").read_text())
    kmin, kmax, eps, z, bins = ref.kld_params(config, N)
    f = config["filter"]
    params = amcl.AmclParams(
        update_min_d=f["update_min_d"], update_min_a=f["update_min_a"], min_particles=kmin,
        max_particles=kmax, alpha_slow=f["alpha_slow"], alpha_fast=f["alpha_fast"],
        kld_epsilon=eps, kld_z=z, spatial_resolution_x=bins[0], spatial_resolution_y=bins[1],
        spatial_resolution_theta=bins[2], resampling=f["resampling"],
        sorted_slots=f["sorted_slots"], recovery_pool=f["recovery_pool"])
    mcfg = config["map"]
    data = world.tracking_arena(mcfg["grid"], mcfg["resolution"])
    poses = world.lattice_poses(4096, mcfg["grid"], mcfg["resolution"], 1.2)[::1024]
    pts, mask = world.cast_scans(data, mcfg["resolution"], poses, config["scan"]["beams"],
                                 config["scan"]["max_range"], "cpu")
    models, ctx = likelihood_field.build(config, data,
                                         DifferentialDriveParams(*config["motion_alphas"]), "cpu")
    return dict(config=config, params=params, models=models, ctx=ctx, poses=poses, pts=pts,
                mask=mask)


def fleet(setup, heading_on_an_edge, seed=0, thrun=None):
    """Four filters of tight clouds (1 mm, 1 mrad) about a corner of the
    x-y bins near each robot: 4 buckets a filter (count ``min``), or 8
    with the heading on a bin's edge too (a count between ``min`` and
    ``max``)."""
    p = setup["params"]
    gen = torch.Generator().manual_seed(seed)
    corner = np.round(setup["poses"][:, :2] / 0.5) * 0.5
    th = np.round(setup["poses"][:, 2] / TEN_DEG) * TEN_DEG
    th = th if heading_on_an_edge else th + TEN_DEG / 2
    clouds = [sample_normal_se2(gen, N, amcl.host_pose(x, y, t), np.diag([1e-6, 1e-6, 1e-6]))
              for (x, y), t in zip(corner, th)]
    states = SE2(torch.stack([c.xy for c in clouds]),
                 SO2(torch.stack([c.rot.z for c in clouds])))
    state = amcl.init_state(gen, tree_sort_by(states.theta, states), p, device="cpu")
    if thrun is not None:
        state = state._replace(thrun=thrun)
    return state


def one_update(setup, state):
    """One forced update from the robots' poses (no motion), keeping what
    the KLD stage took and what the recovery drew."""
    kept = {}
    m = setup["models"]

    def hash_state(params, states):
        kept["cand"], kept["hashes"] = states, m.hash_state(params, states)
        return kept["hashes"]

    def random_state(*args):
        kept["pool"] = m.random_state(*args)
        return kept["pool"]

    update = make_fleet_update(setup["params"],
                               m._replace(hash_state=hash_state, random_state=random_state))
    poses = setup["poses"]
    odom = SE2.from_xytheta(poses[:, 0], poses[:, 1], poses[:, 2], device="cpu")
    new, est = update(setup["ctx"], state, odom, setup["pts"], setup["mask"])
    return new, est, kept


@pytest.mark.parametrize("heading_on_an_edge,where", [(False, "min"), (True, "between")])
def test_the_count_is_the_sequential_take_while(setup, heading_on_an_edge, where):
    new, _, kept = one_update(setup, fleet(setup, heading_on_an_edge))
    cand = kept["cand"]
    kmin, kmax, eps, z, bins = ref.kld_params(setup["config"], N)
    hashes = ref.spatial_hash(cand.xy, cand.rot.z, bins)
    assert np.array_equal(hashes.astype(np.int64), kept["hashes"].numpy())
    want = [ref.take_while(h.tolist(), kmin, kmax, eps, z) for h in hashes]
    assert new.particles.active.tolist() == want
    if where == "min":
        assert want == [kmin] * B
    else:
        assert all(kmin < w < kmax for w in want), want


def test_the_live_prefix_after_the_sort(setup):
    """Each filter's slots below its count are its first ``active``
    candidates (the θ sort moves no dead slot into them) in the order of
    their sort keys (strays last), at log-weight 0; the rest hold the dead
    log-weight."""
    new, _, kept = one_update(setup, fleet(setup, True))
    p, cand = new.particles, kept["cand"]
    keys = amcl.se2_sort_key(cand)
    for b, a in enumerate(p.active.tolist()):
        assert a < N
        assert ref.same_states(p.state.xy[b, :a], p.state.rot.z[b, :a], cand.xy[b, :a],
                               cand.rot.z[b, :a])
        order = torch.sort(keys[b, :a], stable=True).indices
        assert torch.equal(p.state.xy[b, :a], cand.xy[b, order])
        assert bool((p.log_weight[b, :a] == 0).all())
        assert bool((p.log_weight[b, a:] == DEAD_LOG_WEIGHT).all())


def test_the_estimate_ignores_dead_slots(setup):
    new, est, _ = one_update(setup, fleet(setup, True))
    p = new.particles
    live = torch.arange(N) < p.active[:, None]
    w = live.double() / live.double().sum(-1, keepdim=True)
    xy = (w[..., None] * p.state.xy.double()).sum(-2)
    zc = (w[..., None] * p.state.rot.z.double()).sum(-2)
    assert torch.allclose(est.pose.xy.double(), xy, atol=1e-5, rtol=0)
    gap = torch.remainder(est.pose.theta.double() - torch.atan2(zc[:, 1], zc[:, 0]) + math.pi,
                          2 * math.pi) - math.pi
    assert float(gap.abs().max()) < 1e-5
    junk = p.state.xy.clone()
    junk[~live] = 1e6  # stuffing the dead slots leaves the estimate as it was
    mean, _ = amcl.default_estimate(None, make_from_states(SE2(junk, p.state.rot), p.active))
    assert torch.equal(mean.xy, est.pose.xy)


def _thrun(slow, fast):
    seeded = torch.ones(B, dtype=torch.bool)
    return ThrunState(ExpFilterState(torch.full((B,), slow), seeded),
                      ExpFilterState(torch.full((B,), fast), seeded))


@pytest.mark.parametrize("thrun", [None, "risen"])
def test_recovery_states_appear_only_above_a_probability_of_0(setup, thrun):
    """Fresh Thrun filters (p = 0), and filters whose averages sit at 4 / n
    as though their count had just risen from n / 4 (p about 0.074)."""
    th = None if thrun is None else _thrun(4.0 / N, 4.0 / N)
    state = fleet(setup, True, seed=3, thrun=th)
    f = setup["config"]["filter"]
    in_thrun = torch.stack([state.thrun.slow.value, state.thrun.slow.seeded.float(),
                            state.thrun.fast.value, state.thrun.fast.seeded.float()], -1)
    p_rand = ref.thrun_probability32(in_thrun, state.particles.active, f["alpha_slow"],
                                     f["alpha_fast"]).tolist()
    _, _, kept = one_update(setup, state)
    cand, pool = kept["cand"], kept["pool"]
    drawn = (ref._bits(cand.xy, cand.rot.z) == ref._bits(pool.xy, pool.rot.z)).all(-1).sum(-1)
    for b in range(B):
        assert ref.injected_count_ok(int(drawn[b]), N, p_rand[b]), (drawn, p_rand)
        assert (int(drawn[b]) > 0) == (thrun is not None) == (p_rand[b] > 0.05)


def test_the_float32_target_is_the_float64_one_below_max(setup):
    """The port's float32 chi-squared target and beluga's float64 one give
    the same integer at every bucket count whose target can bind (at most
    the configuration's 2000 slots)."""
    c = setup["config"]["kld"]
    k = torch.arange(0, 2001)
    t32 = kld_target_size(k, c["kld_epsilon"], c["kld_z"]).tolist()
    t64 = [ref.kld_target(int(i), c["kld_epsilon"], c["kld_z"]) for i in k]
    assert all(a == b for a, b in zip(t32, t64) if min(a, b) <= 2000)
    assert sum(b <= 2000 for b in t64) > 100  # the comparison covers the range that binds


def test_count_marks_a_range_only_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    count("kld.live", 3)  # nothing records: a no-op
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        count("kld.live", 1234567)
    names = [e.name for e in prof.events()]
    assert "count.kld.live=1234567" in names and "count.kld.live=3" not in names

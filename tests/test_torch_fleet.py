"""Filter fleets of the PyTorch port: the theta sort, one fleet update
against ``jax.vmap`` of the reference's update, the fleet against separate
single-filter updates, per-filter gates and KLD counts, and a CPU run of
the fleet configuration, on the CPU.

Tolerances are those of ``tests/test_torch_filter.py``: particle states
within 1e-5 (sin/cos/atan2 of the motion sample differ in the last bits
between XLA and PyTorch), log-weights, counters and KLD counts equal, the
estimate within 1e-4.  The two packages' weights differ in the last bits,
so a resampling position within ~1e-7 of a CDF step may take the
neighbouring donor: up to 0.5% of the slots (at least one) may hold
another particle; with theta-sorted slots such a particle also moves the
slots between its two sort positions, so the states are then compared as
multisets, each port particle matched to its own reference particle within
1e-5; the particles left over, paired in slot order, give the offsets that
widen the estimate's tolerance, as in ``test_torch_filter.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.core.particles import tree_sort_by as j_tree_sort_by
from beluga_tpu.core.random import sample_normal_se2 as j_sample_normal_se2
from beluga_tpu.core.random import sample_uniform_free_cells as j_sample_free_cells
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.builders import make_likelihood_field_filter as j_make_filter
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.core.particles import make_from_states, tree_sort_by
from beluga_tpu_torch.core.random import sample_normal_se2
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.parallel.fleet import make_fleet_update

torch.set_num_threads(1)

GATE_POS, GATE_YAW = 0.9, math.radians(30.0)  # tests/test_system.py:44-45
LF = dict(max_obstacle_distance=2.0, max_laser_distance=100.0)  # nav2 defaults
SIZE, RES, BEAMS = 160, 0.05, 60


@pytest.fixture(scope="module")
def world():
    """The synthetic arena (160 cells at 5 cm), one trajectory and its
    scans, and both packages' code-table filters on it."""
    data = synthetic.tracking_arena(SIZE, RES)
    xs, ys, yaws = synthetic.circle_trajectory(3, SIZE, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    jmodels, jctx = j_make_filter(j_make_grid(data, RES), JLFParams(**LF), lookup_mode="codebook")
    models, _ = make_likelihood_field_filter(make_grid(data, RES, device="cpu"),
                                             LikelihoodFieldParams(**LF), device="cpu")
    return dict(data=data, jmodels=jmodels, jctx=jctx, models=models,
                ctx=convert.ctx(jax.device_get(jctx)), traj=(xs, ys, yaws), pts=pts, mask=mask)


def t(a):
    return torch.as_tensor(np.array(a, order="C"))


# -- the theta sort ----------------------------------------------------------------


def cloud_with_strays(lead, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 0.3, (*lead, n))
    y = rng.normal(-1.0, 0.2, (*lead, n))
    th = rng.normal(0.5, 0.3, (*lead, n))
    x[..., :6] += rng.choice([-4.0, 4.0], (*lead, 6))  # strays in x
    y[..., 6:9] += 3.0  # strays in y
    th[..., 9:12] += np.pi  # strays in heading
    th[..., 20:24] = th[..., 30:34]  # equal keys keep their order
    return [a.astype(np.float32) for a in (x, y, th)]


@pytest.mark.parametrize("lead", [(), (3,)])
def test_sort_key_and_tree_sort_by_match_reference(lead):
    n = 400
    x, y, th = cloud_with_strays(lead, n, seed=len(lead))
    jstates = JSE2.from_xytheta(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th))
    states = convert.se2(jax.device_get(jstates))
    active = np.full(lead, n - 37, np.int32)
    mask = np.arange(n) < active[..., None]
    key_fn, sort_fn = j_amcl.se2_sort_key, j_tree_sort_by
    for _ in lead:
        key_fn, sort_fn = jax.vmap(key_fn), jax.vmap(sort_fn)
    jkeys = np.where(mask, np.asarray(key_fn(jstates)), np.inf).astype(np.float32)
    keys = torch.where(torch.as_tensor(mask), amcl.se2_sort_key(states), torch.inf)
    # stray flags (+100) equal; theta within the atan2 tolerance
    np.testing.assert_array_equal(keys.numpy() > 50, jkeys > 50)
    assert 0 < int((jkeys[np.isfinite(jkeys)] > 50).sum()) < 20 * math.prod(lead)
    np.testing.assert_allclose(keys.numpy(), jkeys, rtol=0, atol=1e-5)
    # the sort itself: the reference's keys give the reference's order exactly
    jsorted = jax.device_get(sort_fn(jnp.asarray(jkeys), jstates))
    got = tree_sort_by(torch.as_tensor(jkeys), states)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(jsorted.xy))
    np.testing.assert_array_equal(got.rot.z.numpy(), np.asarray(jsorted.rot.z))
    # dead slots (inf keys) keep their order at the end; so do the port's keys
    np.testing.assert_array_equal(got.xy[..., n - 37:, :].numpy(), states.xy[..., n - 37:, :].numpy())
    own = tree_sort_by(keys, states)
    np.testing.assert_array_equal(own.xy.numpy(), np.asarray(jsorted.xy))


# -- one fleet update against jax.vmap(update) -----------------------------------


def fleet_draws(jstate, jctx, n, m):
    """Every draw each filter of the reference's vmapped update makes from
    its key (filters/amcl.py:315), stacked as the port's ``UpdateDraws``."""
    grid = jctx["grid"]
    parts = []
    for key in np.asarray(jax.device_get(jstate.key)):
        _, k_prop, k_res, k_rand, k_mask = jax.random.split(jnp.asarray(key), 5)
        parts.append((jax.random.normal(k_prop, (3, n), jnp.float32),
                      j_systematic_positions(k_res, m),
                      jax.random.uniform(k_mask, (m,), jnp.float32),
                      j_sample_free_cells(k_rand, m, grid.free_xy, grid.num_free)))
    stack = lambda i: t(np.stack([np.asarray(p[i]) for p in parts]))  # noqa: E731
    randoms = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[p[3] for p in parts])
    return amcl.UpdateDraws(stack(0), stack(1), stack(2), convert.se2(jax.device_get(randoms)))


def reference_fleet(params, batch, n, start_xyt, seed, cov=(0.01, 0.01, 0.005)):
    """A JAX fleet as bench.py:193-210 builds it, from ``seed``."""
    start = JSE2.from_xytheta(*map(float, start_xyt))

    def one(key):
        k1, k2 = jax.random.split(key)
        states = j_sample_normal_se2(k1, n, start, jnp.diag(jnp.asarray(cov, jnp.float32)))
        if params.sorted_slots:
            states = j_tree_sort_by(states.theta, states)
        return j_amcl.init_state(k2, states, params)

    return jax.vmap(one)(jax.random.split(jax.random.PRNGKey(seed), batch))


def fleet_odoms(traj, step, batch):
    xs, ys, yaws = traj
    off = 0.01 * np.arange(batch)  # each filter has its own odometry frame
    return xs[step] + off, ys[step] - off, yaws[step] + off


def match_states(a, b, atol=1e-5):
    """The particles of ``a`` and of ``b`` (rows of x, y, cos, sin) left
    over when each particle of ``a`` takes, in slot order, the first free
    particle of ``b`` within ``atol``: the multiset comparison of the
    module docstring, as boolean masks over ``a`` and ``b``."""
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1) <= atol
    free = np.ones(len(b), bool)
    left = np.ones(len(a), bool)
    for i in range(len(a)):
        hit = np.flatnonzero(d[i] & free)
        if hit.size:
            free[hit[0]], left[i] = False, False
    return left, free


def compare_filter(state, est, ref, jest, b, n):
    a = np.concatenate([state.particles.state.xy[b].numpy(),
                        state.particles.state.rot.z[b].numpy()], -1)
    r = np.concatenate([np.asarray(ref.particles.state.xy[b]),
                        np.asarray(ref.particles.state.rot.z[b])], -1)
    d = np.zeros(0)
    if (np.abs(a - r).max(1) > 1e-5).any():
        left, free = match_states(a, r)
        assert left.sum() == free.sum() <= max(1, n // 200), f"filter {b}: {left.sum()} slots differ"
        # each left-over particle paired, in slot order, with one of the
        # reference's: any pairing bounds the mean's shift by sum(d) / n
        d = np.abs(a[left] - r[free]).max(1)
    assert int(state.particles.active[b]) == int(ref.particles.active[b])
    np.testing.assert_array_equal(state.particles.log_weight[b].numpy(),
                                  np.asarray(ref.particles.log_weight[b]))
    for got, want in ((state.thrun.slow, ref.thrun.slow), (state.thrun.fast, ref.thrun.fast)):
        np.testing.assert_allclose(got.value[b].numpy(), np.asarray(want.value[b]), rtol=1e-6)
    assert state.resample_count[b] == int(ref.resample_count[b])
    # the tolerances of test_torch_filter.py::test_one_update_matches_reference
    moved = float(d.sum()) / n
    np.testing.assert_allclose(est.pose.xy[b].numpy(), np.asarray(jest.pose.xy[b]),
                               atol=1e-4 + moved)
    np.testing.assert_allclose(est.pose.rot.z[b].numpy(), np.asarray(jest.pose.rot.z[b]),
                               atol=1e-4 + moved)
    np.testing.assert_allclose(est.covariance[b].numpy(), np.asarray(jest.covariance[b]),
                               rtol=1e-3, atol=1e-5 + 2 * float((d * (d + 1.0)).sum()) / n)


def test_one_fleet_update_matches_reference_vmap(world):
    """B = 3, N = 256, systematic, min == max, sorted slots, code table:
    the forced first update, then a gated-in move."""
    b, n = 3, 256
    kw = dict(max_particles=n, min_particles=n, resampling="systematic", sorted_slots=True)
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    xs, ys, yaws = world["traj"]
    jstate = reference_fleet(jparams, b, n, (xs[0], ys[0], yaws[0]), seed=3)
    jstep = jax.jit(jax.vmap(functools.partial(j_amcl.update, jparams, world["jmodels"]),
                             in_axes=(None, 0, 0, 0, 0)))
    fleet_update = make_fleet_update(params, world["models"])
    for step in range(2):
        ox, oy, oyaw = fleet_odoms(world["traj"], step, b)
        pts = np.broadcast_to(world["pts"][step], (b, BEAMS, 2)).copy()
        mask = np.broadcast_to(world["mask"][step], (b, BEAMS)).copy()
        state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
        draws = fleet_draws(jstate, world["jctx"], n, n)
        jstate, jest = jstep(world["jctx"], jstate, JSE2.from_xytheta(*map(jnp.asarray, (ox, oy, oyaw))),
                             jnp.asarray(pts), jnp.asarray(mask))
        state, est = fleet_update(world["ctx"], state, SE2.from_xytheta(ox, oy, oyaw, device="cpu"),
                                  t(pts), t(mask), draws=draws)
        ref, jest = jax.device_get((jstate, jest))
        assert est.valid.tolist() == np.asarray(jest.valid).tolist() == [True] * b
        keys = amcl.se2_sort_key(state.particles.state)
        assert bool((keys[:, 1:] >= keys[:, :-1]).all())  # the slots are in key order
        for f in range(b):
            compare_filter(state, est, ref, jest, f, n)
        assert not state.force_update.any() and state.control_seeded.all()
        jstate = ref


# -- the fleet against separate updates -------------------------------------------


def port_fleet(params, batch, spreads, seed=0):
    gen = torch.Generator().manual_seed(seed)
    states = [sample_normal_se2(gen, params.max_particles, amcl.host_pose(2.5, 4.0, 1.5),
                                np.diag([s, s, s / 2])) for s in spreads]
    states = SE2(torch.stack([s.xy for s in states]), type(states[0].rot)(
        torch.stack([s.rot.z for s in states])))
    if params.sorted_slots:
        states = tree_sort_by(states.theta, states)
    return amcl.init_state(gen, states, params, device="cpu")


def fleet_inputs(world, step, batch):
    ox, oy, oyaw = fleet_odoms(world["traj"], step, batch)
    return (SE2.from_xytheta(ox, oy, oyaw, device="cpu"),
            t(np.broadcast_to(world["pts"][step], (batch, BEAMS, 2)).copy()),
            t(np.broadcast_to(world["mask"][step], (batch, BEAMS)).copy()))


def take_filter(tree, b):
    from beluga_tpu_torch.core.particles import tree_map

    return tree_map(lambda leaf: leaf[b], tree)


def single(state, b):
    """Filter ``b`` of a fleet state as a one-filter state."""
    p = state.particles
    return state._replace(
        particles=type(p)(take_filter(p.state, b), p.log_weight[b], p.active[b]),
        thrun=take_filter(state.thrun, b),
        resample_count=int(state.resample_count[b]),
        motion_latest=take_filter(state.motion_latest, b),
        motion_seeded=bool(state.motion_seeded[b]),
        control_prev=take_filter(state.control_prev, b),
        control_seeded=bool(state.control_seeded[b]),
        force_update=bool(state.force_update[b]),
    )


def random_draws(gen, batch, n, m):
    """Draws for every filter of a fleet; the recovery states are uniform
    over a box."""
    u = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    return amcl.UpdateDraws(
        motion_normals=torch.randn((batch, 3, n), generator=gen),
        positions=torch.sort(u(batch, m), -1).values,
        inject_uniform=u(batch, m),
        random_states=SE2.from_xytheta(1 + 6 * u(batch, m), 1 + 6 * u(batch, m),
                                       6 * u(batch, m) - 3),
    )


@pytest.mark.parametrize("kw", [
    dict(resampling="multinomial", sorted_slots=True),  # the fleet configuration
    dict(resampling="systematic", min_particles=100),  # adaptive KLD
    dict(resampling="stratified", resample_interval=2, sorted_slots=True),
], ids=["fleet", "kld", "interval"])
def test_fleet_equals_separate_updates(world, kw):
    b, n = 3, 400
    params = amcl.AmclParams(**{"max_particles": n, "min_particles": n, **kw})
    state = port_fleet(params, b, (0.01, 0.05, 0.2))
    gen = torch.Generator().manual_seed(7)
    # a recovery probability of ~0.8 in one filter: most of its slots inject
    state = state._replace(thrun=state.thrun._replace(
        slow=state.thrun.slow._replace(value=torch.tensor([0.0, 0.01, 0.0]),
                                       seeded=torch.tensor([False, True, False])),
        fast=state.thrun.fast._replace(value=torch.tensor([0.0, 0.002, 0.0]),
                                       seeded=torch.tensor([False, True, False]))))
    fleet_update = make_fleet_update(params, world["models"])
    for step in range(3):
        odoms, pts, mask = fleet_inputs(world, step, b)
        draws = random_draws(gen, b, n, n)
        new, est = fleet_update(world["ctx"], state, odoms, pts, mask, draws=draws)
        for f in range(b):
            one, one_est = amcl.update(params, world["models"], world["ctx"], single(state, f),
                                       take_filter(odoms, f), pts[f], mask[f],
                                       draws=take_filter(draws, f))
            got = single(new, f)
            assert torch.equal(got.particles.state.xy, one.particles.state.xy)
            assert torch.equal(got.particles.state.rot.z, one.particles.state.rot.z)
            assert torch.equal(got.particles.log_weight, one.particles.log_weight)
            assert torch.equal(got.particles.active, one.particles.active)
            assert torch.equal(got.thrun.slow.value, one.thrun.slow.value)
            assert got.resample_count == one.resample_count
            assert est.valid[f] == one_est.valid
            torch.testing.assert_close(est.pose.xy[f], one_est.pose.xy, rtol=0, atol=1e-6)
            torch.testing.assert_close(est.covariance[f], one_est.covariance, rtol=1e-5, atol=1e-7)
        state = new


def test_filters_gate_independently(world):
    """Filter 1's odometry does not move: it is gated out and keeps every
    bit of its state, with ``valid=False`` and the estimate of its old
    particles; filters 0 and 2 update exactly as when all three do."""
    b, n = 3, 300
    params = amcl.AmclParams(max_particles=n, min_particles=n, sorted_slots=True)
    fleet_update = make_fleet_update(params, world["models"])
    state = port_fleet(params, b, (0.02, 0.02, 0.02))
    odoms, pts, mask = fleet_inputs(world, 0, b)
    gen = torch.Generator().manual_seed(3)
    state, _ = fleet_update(world["ctx"], state, odoms, pts, mask, draws=random_draws(gen, b, n, n))
    moved, pts1, mask1 = fleet_inputs(world, 1, b)
    odoms = SE2(torch.where(torch.tensor([False, True, False])[:, None], odoms.xy, moved.xy),
                type(odoms.rot)(torch.where(torch.tensor([False, True, False])[:, None],
                                            odoms.rot.z, moved.rot.z)))
    draws = random_draws(gen, b, n, n)
    gated, est = fleet_update(world["ctx"], state, odoms, pts1, mask1, draws=draws)
    everyone, est_all = fleet_update(world["ctx"], state, moved, pts1, mask1, draws=draws)
    assert est.valid.tolist() == [True, False, True]
    kept, before = single(gated, 1), single(state, 1)
    for a, c in ((kept.particles.state.xy, before.particles.state.xy),
                 (kept.particles.state.rot.z, before.particles.state.rot.z),
                 (kept.particles.log_weight, before.particles.log_weight),
                 (kept.particles.active, before.particles.active),
                 (kept.thrun.slow.value, before.thrun.slow.value),
                 (kept.thrun.fast.value, before.thrun.fast.value),
                 (kept.control_prev.xy, before.control_prev.xy)):
        assert torch.equal(a, c)
    assert (kept.resample_count, kept.control_seeded, kept.force_update) == (
        before.resample_count, before.control_seeded, before.force_update)
    old_mean, _ = amcl.default_estimate(params, take_filter_particles(state, 1))
    assert torch.equal(est.pose.xy[1], old_mean.xy)
    for f in (0, 2):
        assert torch.equal(single(gated, f).particles.state.xy,
                           single(everyone, f).particles.state.xy)
        assert torch.equal(est.pose.xy[f], est_all.pose.xy[f])
    # no filter due: nothing is computed, nothing changes
    still, est = fleet_update(world["ctx"], gated, odoms, pts1, mask1)
    assert not est.valid.any()
    assert torch.equal(still.particles.state.xy, gated.particles.state.xy)


def take_filter_particles(state, b):
    p = state.particles
    return type(p)(take_filter(p.state, b), p.log_weight[b], p.active[b])


def test_adaptive_kld_counts_per_filter(world):
    """Three clouds of very different spread keep three different numbers
    of particles, each that filter's own KLD count."""
    b, n = 3, 2000
    params = amcl.AmclParams(max_particles=n, min_particles=100, resampling="systematic")
    state = port_fleet(params, b, (0.0005, 0.02, 0.5), seed=4)
    odoms, pts, mask = fleet_inputs(world, 0, b)
    fleet_update = make_fleet_update(params, world["models"])
    state, _ = fleet_update(world["ctx"], state, odoms, pts, mask)
    active = state.particles.active.tolist()
    assert state.particles.active.shape == (b,)
    assert 100 <= active[0] < active[1] < active[2] <= n, active
    lw = state.particles.log_weight
    for f, k in enumerate(active):
        assert bool((lw[f, :k] == 0).all()) and bool((lw[f, k:] < -1e29).all())
    # the estimate ignores dead slots: stuffing them leaves it unchanged
    mean, _ = amcl.default_estimate(params, state.particles)
    junk = state.particles.state.xy.clone()
    junk[torch.arange(n)[None, :] >= state.particles.active[:, None]] = 1e6
    stuffed = make_from_states(SE2(junk, state.particles.state.rot), state.particles.active)
    mean2, _ = amcl.default_estimate(params, stuffed)
    assert torch.equal(mean.xy, mean2.xy)


def test_fleet_configuration_tracks_on_cpu():
    """The JAX benchmark's fleet configuration (codebook16, theta-sorted
    slots, fixed count, multinomial resampling, pooled recovery) at
    4 x 512 particles tracks the arena's circle within the system-test
    gate, every filter at every scan."""
    b, n, scans = 4, 512, 16
    data = synthetic.tracking_arena(384, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, 384, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    models, ctx = make_likelihood_field_filter(make_grid(data, RES, device="cpu"),
                                               lookup_mode="codebook16", recovery_candidates=256,
                                               device="cpu")
    params = amcl.AmclParams(max_particles=n, min_particles=n, sorted_slots=True)
    state = amcl.init_fleet_state(0, b, amcl.host_pose(xs[0], ys[0], yaws[0]),
                                  np.diag([0.25, 0.25, 0.068]), params, device="cpu")
    keys = amcl.se2_sort_key(state.particles.state)
    assert bool((state.particles.state.theta[:, 1:] >= state.particles.state.theta[:, :-1]).all())
    fleet_update = make_fleet_update(params, models)
    for step in range(scans):
        odoms = SE2.from_xytheta(np.full(b, xs[step]), np.full(b, ys[step]),
                                 np.full(b, yaws[step]), device="cpu")
        state, est = fleet_update(ctx, state, odoms, t(np.broadcast_to(pts[step], (b, BEAMS, 2))),
                                  t(np.broadcast_to(mask[step], (b, BEAMS))))
        assert est.valid.all()
        pose = est.pose.as_xytheta().numpy()
        err = np.hypot(pose[:, 0] - xs[step], pose[:, 1] - ys[step])
        yaw = np.abs(np.arctan2(np.sin(pose[:, 2] - yaws[step]), np.cos(pose[:, 2] - yaws[step])))
        assert (err < GATE_POS).all() and (yaw < GATE_YAW).all(), (step, err, yaw)
        keys = amcl.se2_sort_key(state.particles.state)
        assert bool((keys[:, 1:] >= keys[:, :-1]).all())

"""The port's particle-sharded mega filter (``parallel/mega.py``) on gloo
CPU ranks: against the JAX package's ``make_mega_update`` (its
deterministic pieces, on 4 virtual devices), against the port's own dense
update on the same draws (1, 2 and 4 ranks, every strategy, a fixed count
and adaptive KLD), and the statistical checks of ``tests/test_mega.py`` on
4 ranks.

Each world size spawns its ranks once for the module (module-scoped
fixtures); a rank imports only torch and the port, and the JAX package and
the dense references run in this process.  The 96 x 96 world of
``tests/test_mega.py:15-24``, 1024 particles and 24 beams (scans from the
JAX package's simulator).

Tolerances: against JAX, log-weights within 1e-4, the estimate's x and y
within 1e-5 and its 2 x 2 translation covariance within 1e-4
(``tests/test_mega.py:66-93``); against the dense update on the same draws,
bit-equal at one rank; at 2 and 4 ranks the pre-resample log-weights within
1e-6 relative, the donors equal except where a position lies within 64 ulp
of a CDF edge (those that differ fewer than 1 in 1000), the active count
equal.  Multinomial resampling draws each rank's own sorted order
statistics and interleaves them within the rank: its expected donors are
the dense update's CDF-ordered donors, interleaved a rank at a time, and
its expected KLD count that of those donors.  The statistical checks keep
``tests/test_mega.py``'s gates.
"""

import dataclasses

import numpy as np
import pytest
import torch

from beluga_tpu_torch.parallel.multihost import spawn_ranks

N = 1024
BEAMS = 24
CDF_ULP = 64 * 2.0**-24
SPAWN_TIMEOUT = 60.0
TRUE_POSE = (4.8, 4.8, 0.3)
LOST_POSE = (2.0, 7.0, 1.0)  # tests/test_mega.py's mismatched scan
STRATEGIES = ("systematic", "stratified", "multinomial", "residual")
SAME_DRAWS = [dict(max_particles=N, min_particles=mn, resampling=r)
              for r in STRATEGIES for mn in (N, 128)]


def world_data():
    from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE

    data = np.zeros((96, 96), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[40:46, 60:66] = OCCUPIED_VALUE
    data[20:24, 20:30] = OCCUPIED_VALUE
    return data


def port_world(identity_motion=False):
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    models, ctx = make_likelihood_field_filter(make_grid(world_data(), 0.1, device="cpu"),
                                               device="cpu")
    if identity_motion:
        models = models._replace(propagate=lambda ctx, z, s, pose, prev: s)
    return models, ctx


def winlut_world(identity_motion=False, **kw):
    """``tests/test_mega.py:_winlut_world``: the flagship's models, sized
    for the small map."""
    from beluga_tpu_torch.filters.builders import make_windowed_scan_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    models, ctx = make_windowed_scan_filter(
        make_grid(world_data(), 0.1, device="cpu"), k_bins=32, win=(32, 128),
        max_point_radius=6.5, tile=128, tblk=12, coverage_threshold=0.0, exact_tail_frac=0.0,
        recovery_candidates=64, device="cpu", **kw)
    if identity_motion:
        models = models._replace(propagate=lambda ctx, z, s, pose, prev: s)
    return models, ctx


def initial_state(params, seed, cov=0.05, pose=TRUE_POSE, sort=False):
    from beluga_tpu_torch.core.particles import tree_sort_by
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import host_pose, init_state

    gen = torch.Generator()
    gen.manual_seed(seed)
    states = sample_normal_se2(gen, params.max_particles, host_pose(*pose), np.eye(3) * cov)
    if sort:
        states = tree_sort_by(states.theta, states)
    return init_state(gen, states, params, device="cpu")


def scan(scans, which):
    pts, mask = scans[which]
    return torch.tensor(pts), torch.tensor(mask)


def xytheta(est):
    return est.pose.as_xytheta().numpy()


# -- the ranks -----------------------------------------------------------------


def _same_draws_on_rank(mesh, scans, cases):
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose
    from beluga_tpu_torch.parallel.collectives import all_gather_last
    from beluga_tpu_torch.parallel.mega import (
        all_gather_states,
        make_mega_update,
        shard_draws,
        shard_mega_state,
    )

    group = mesh.get_group("tp")
    models, ctx = port_world()
    pts, mask = scan(scans, "true")
    out = []
    for kw, steps in cases:
        params = AmclParams(**kw)
        update = make_mega_update(params, models, mesh)
        keep = make_mega_update(dataclasses.replace(params, resample_interval=10**6), models,
                                mesh)
        got = []
        for step in steps:
            gen = torch.Generator()
            gen.manual_seed(0)
            state = shard_mega_state(mesh, step["before"]._replace(generator=gen))
            draws = shard_draws(step["draws"], params, mesh)
            odom = host_pose(*step["odom"])
            pre, _ = keep(ctx, state, odom, pts, mask, draws=draws)
            new, est = update(ctx, state, odom, pts, mask, draws=draws)
            s = all_gather_states(new.particles.state, group)
            got.append(dict(xy=s.xy.numpy(), z=s.rot.z.numpy(),
                            log_w=all_gather_last(new.particles.log_weight, group).numpy(),
                            pre_log_w=all_gather_last(pre.particles.log_weight, group).numpy(),
                            active=int(new.particles.active), est=xytheta(est),
                            cov=est.covariance.numpy()))
        out.append(got)
    return out


def _track(mesh, models, ctx, params, state, pts, mask, steps, sort_every=None):
    """Forced updates at the identity odometry: the last estimate, and per
    step whether the log-weights were finite and the active count."""
    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.parallel.collectives import all_gather_last
    from beluga_tpu_torch.parallel.mega import all_gather_states, make_mega_update

    group = mesh.get_group("tp")
    update = make_mega_update(params, models, mesh)
    finite, active = [], []
    for i in range(steps):
        sort_now = None if sort_every is None else i % sort_every == 0
        state, est = update(ctx, state._replace(force_update=True), host_pose(0.0, 0.0, 0.0),
                            pts, mask, sort_now=sort_now)
        lw = all_gather_last(state.particles.log_weight, group)
        xy = all_gather_states(state.particles.state, group).xy
        finite.append(bool(torch.isfinite(lw).all() and torch.isfinite(xy).all()))
        active.append(int(state.particles.active))
    return dict(est=xytheta(est), valid=bool(est.valid), finite=finite, active=active)


def _statistics_on_rank(mesh, scans):
    """``tests/test_mega.py``'s statistical checks (4 ranks)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose
    from beluga_tpu_torch.parallel.collectives import all_gather_last
    from beluga_tpu_torch.parallel.mega import (
        all_gather_states,
        make_mega_update,
        shard_mega_state,
    )

    group = mesh.get_group("tp")
    models, ctx = port_world()
    true, lost = scan(scans, "true"), scan(scans, "lost")
    out = {}
    params = AmclParams(max_particles=N, min_particles=128)
    out["tracks"] = _track(mesh, models, ctx, params,
                           shard_mega_state(mesh, initial_state(params, 0)), *true, 5)
    params = AmclParams(max_particles=N, min_particles=128, alpha_slow=0.0, alpha_fast=100.0)
    out["recovery_kld"] = _track(mesh, models, ctx, params,
                                 shard_mega_state(mesh, initial_state(params, 5)), *lost, 6)
    for strategy in STRATEGIES:
        params = AmclParams(max_particles=N, min_particles=128, resampling=strategy)
        out[strategy] = _track(mesh, models, ctx, params,
                               shard_mega_state(mesh, initial_state(params, 1)), *true, 4)
    flagship = dict(max_particles=N, min_particles=N, sorted_slots=True,
                    resampling="systematic", selective_resampling=True, sort_interval=2)
    wmodels, wctx = winlut_world(fused=True)
    params = AmclParams(recovery_pool=64, **flagship)
    out["flagship"] = _track(mesh, wmodels, wctx, params,
                             shard_mega_state(mesh, initial_state(params, 11, sort=True)),
                             *true, 6, sort_every=2)
    wmodels, wctx = winlut_world()
    params = AmclParams(recovery_pool=128, alpha_slow=0.9, alpha_fast=0.01, **flagship)
    out["burst"] = _track(mesh, wmodels, wctx, params,
                          shard_mega_state(mesh, initial_state(params, 17, pose=(4.8, 4.8, 0.0),
                                                               sort=True)),
                          *lost, 6, sort_every=2)
    # residual: the same propagated states with and without the resample
    n = 256
    kw = dict(max_particles=n, min_particles=n, resampling="residual", alpha_slow=0.0,
              alpha_fast=0.0)
    start = initial_state(AmclParams(**kw), 2, cov=0.04)._replace(force_update=True)
    odom = host_pose(0.0, 0.0, 0.0)
    kept, _ = make_mega_update(AmclParams(resample_interval=10**6, **kw), models, mesh)(
        ctx, shard_mega_state(mesh, start), odom, *true)
    resampled, _ = make_mega_update(AmclParams(**kw), models, mesh)(
        ctx, shard_mega_state(mesh, start), odom, *true)
    out["residual_floor"] = dict(
        log_w=all_gather_last(kept.particles.log_weight, group).numpy(),
        x_in=all_gather_states(kept.particles.state, group).x.numpy(),
        x_out=all_gather_states(resampled.particles.state, group).x.numpy())
    return out


def _jax_pieces_on_rank(mesh, scans, start):
    """``tests/test_mega.py:66-93`` on the port: no motion noise, no
    resample, from the JAX package's initial state."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose
    from beluga_tpu_torch.parallel.collectives import all_gather_last
    from beluga_tpu_torch.parallel.mega import make_mega_update, shard_mega_state

    models, ctx = port_world(identity_motion=True)
    params = AmclParams(max_particles=N, min_particles=128, resample_interval=1000000)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = shard_mega_state(mesh, start._replace(generator=gen))
    state, est = make_mega_update(params, models, mesh)(
        ctx, state, host_pose(0.0, 0.0, 0.0), *scan(scans, "level"))
    return dict(log_w=all_gather_last(state.particles.log_weight, mesh.get_group("tp")).numpy(),
                est=xytheta(est), cov=est.covariance.numpy())


def _flagship_two_ranks(mesh, scans):
    """``tests/test_mega.py:test_mega_flagship_tracks_single_device_run``:
    the sharded run's estimates, the dense run's on rank 0."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, update
    from beluga_tpu_torch.parallel.mega import make_mega_update, shard_mega_state

    models, ctx = winlut_world(identity_motion=True)
    params = AmclParams(max_particles=512, min_particles=512, sorted_slots=True,
                        resampling="systematic", recovery_pool=32, selective_resampling=True,
                        sort_interval=2, alpha_slow=0.0, alpha_fast=0.0)
    start = initial_state(params, 13, cov=0.04, sort=True)
    pts, mask = scan(scans, "true")
    sharded = make_mega_update(params, models, mesh)
    mstate, dstate = shard_mega_state(mesh, start), start
    gaps = []
    for i in range(4):
        sort_now = i % 2 == 0
        odom = host_pose(0.0, 0.0, 0.0)
        dstate, dest = update(params, models, ctx, dstate._replace(force_update=True), odom,
                              pts, mask, sort_now=sort_now)
        mstate, mest = sharded(ctx, mstate._replace(force_update=True), odom, pts, mask,
                               sort_now=sort_now)
        gaps.append(np.abs(xytheta(dest)[:2] - xytheta(mest)[:2]))
    return np.asarray(gaps)


def _mega_ranks(rank, world, device, scans, cases, start):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("tp",))
    out = {"same_draws": _same_draws_on_rank(mesh, scans, cases)}
    if world == 4:
        out["jax_pieces"] = _jax_pieces_on_rank(mesh, scans, start)
        out["statistics"] = _statistics_on_rank(mesh, scans)
    if world == 2:
        out["flagship_gaps"] = _flagship_two_ranks(mesh, scans)
    return out


# -- this process: the JAX package and the dense references ---------------------


@pytest.fixture(scope="module")
def scans():
    """The JAX package's simulated scans (``tests/test_mega.py:27-36``)."""
    import jax.numpy as jnp

    from beluga_tpu.io.replay import ScanSimulator, ScanSpec
    from beluga_tpu.lie import SE2 as JSE2
    from beluga_tpu.maps.occupancy import make_grid as j_make_grid

    sim = ScanSimulator(j_make_grid(jnp.asarray(world_data()), 0.1),
                        ScanSpec(num_beams=BEAMS, max_range=6.0, max_beams=BEAMS))
    out = {}
    for name, pose in (("true", TRUE_POSE), ("lost", LOST_POSE), ("level", (4.8, 4.8, 0.0))):
        dist, hit = sim._cast(JSE2.from_xytheta(*pose))
        ang = np.linspace(-np.pi, np.pi, BEAMS, endpoint=False)
        dist = np.asarray(dist)
        pts = np.stack([dist * np.cos(ang), dist * np.sin(ang)], -1).astype(np.float32)
        out[name] = (pts, np.asarray(hit))
    return out


@pytest.fixture(scope="module")
def jax_pieces(scans):
    """``tests/test_mega.py:66-93`` on the JAX package (4 devices), and its
    initial state carried to the port."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from beluga_tpu.core.random import sample_normal_se2 as j_sample
    from beluga_tpu.filters.amcl import AmclParams as JParams
    from beluga_tpu.filters.amcl import init_state as j_init_state
    from beluga_tpu.filters.builders import make_likelihood_field_filter as j_make_lf
    from beluga_tpu.lie import SE2 as JSE2
    from beluga_tpu.maps.occupancy import make_grid as j_make_grid
    from beluga_tpu.parallel.mega import make_mega_update as j_mega
    from beluga_tpu.parallel.mega import shard_mega_state as j_shard
    from beluga_tpu_torch import convert

    models, ctx = j_make_lf(j_make_grid(jnp.asarray(world_data()), 0.1))
    models = models._replace(propagate=lambda c, k, s, o, p: s)
    params = JParams(max_particles=N, min_particles=128, resample_interval=1000000)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    states = j_sample(k1, N, JSE2.from_xytheta(4.8, 4.8, 0.0), jnp.eye(3) * 0.05)
    start = j_init_state(k2, states, params)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("tp",))
    pts, mask = scans["level"]
    state, est = jax.jit(j_mega(params, models, mesh))(
        ctx, j_shard(mesh, start), JSE2.identity(), jnp.asarray(pts), jnp.asarray(mask))
    want = dict(log_w=np.asarray(state.particles.log_weight),
                est=np.asarray(est.pose.as_xytheta()), cov=np.asarray(est.covariance))
    return want, convert.amcl_state(jax.device_get(start), None)


def _dense_cases(scans):
    """The dense update of every ``SAME_DRAWS`` configuration for two
    updates, each from the previous one's state, on draws from a seed (no
    injection: every injection uniform is 1)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, draw_update, host_pose, update

    models, ctx = port_world()
    pts, mask = scan(scans, "true")
    cases = []
    for kw in SAME_DRAWS:
        params = AmclParams(**kw)
        keep = dataclasses.replace(params, resample_interval=10**6)
        state = initial_state(params, 5)
        steps = []
        for t in range(2):
            gen = torch.Generator()
            gen.manual_seed(100 + t)
            draws = draw_update(params, models, ctx, state.particles, gen)
            draws = draws._replace(inject_uniform=torch.ones_like(draws.inject_uniform))
            odom = (0.1 * t, 0.0, 0.0)
            before = state._replace(force_update=True)
            pre, _ = update(keep, models, ctx, before, host_pose(*odom), pts, mask, draws)
            state, est = update(params, models, ctx, before, host_pose(*odom), pts, mask, draws)
            steps.append(dict(
                before=before._replace(generator=None), draws=draws, odom=odom,
                xy=state.particles.state.xy.numpy(), z=state.particles.state.rot.z.numpy(),
                log_w=state.particles.log_weight.numpy(),
                pre_log_w=pre.particles.log_weight.numpy(),
                active=int(state.particles.active), est=xytheta(est), cov=est.covariance.numpy()))
        cases.append((kw, steps))
    return cases


@pytest.fixture(scope="module")
def dense(scans):
    return _dense_cases(scans)


def _world(world, scans, dense, start):
    inputs = [(kw, [{k: s[k] for k in ("before", "draws", "odom")} for s in steps])
              for kw, steps in dense]
    return spawn_ranks(_mega_ranks, world, "cpu", (scans, inputs, start), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world1(scans, dense):
    return _world(1, scans, dense, None)


@pytest.fixture(scope="module")
def world2(scans, dense):
    return _world(2, scans, dense, None)


@pytest.fixture(scope="module")
def world4(scans, dense, jax_pieces):
    return _world(4, scans, dense, jax_pieces[1])


# -- the expectations at several ranks -------------------------------------------


def _shard_interleave(x, world):
    """Slots ``[N, ...]`` in CDF order, interleaved a rank at a time."""
    from beluga_tpu_torch.ops.resample import interleave_ranks

    n_local = N // world
    ranks = interleave_ranks(torch.arange(n_local), n_local).numpy()
    return np.concatenate([x[s * n_local:(s + 1) * n_local][ranks] for s in range(world)])


def _dense_cdf_order(x):
    """Inverse of the dense update's interleave of ``N`` slots."""
    from beluga_tpu_torch.ops.resample import interleave_ranks

    ranks = interleave_ranks(torch.arange(N), N).numpy()
    out = np.empty_like(x)
    out[ranks] = x
    return out


def _expected(kw, step, world):
    """The dense donors ``(xy, z)``, active count and estimate ``(xytheta,
    covariance)`` as the sharded update at ``world`` ranks gives them."""
    from beluga_tpu_torch.algorithms.estimation import estimate_se2
    from beluga_tpu_torch.algorithms.kld import kld_active_count
    from beluga_tpu_torch.filters.amcl import AmclParams, default_hash_state
    from beluga_tpu_torch.lie import SE2, SO2

    if kw["resampling"] != "multinomial" or world == 1:
        return step["xy"], step["z"], step["active"], step["est"], step["cov"]
    xy, z = (_shard_interleave(_dense_cdf_order(a), world) for a in (step["xy"], step["z"]))
    states = SE2(torch.as_tensor(xy), SO2(torch.as_tensor(z)))
    params, active = AmclParams(**kw), step["active"]
    if params.min_particles < params.max_particles:
        active = int(kld_active_count(default_hash_state(params, states), params.min_particles,
                                      N, params.kld_epsilon, params.kld_z))
    live = torch.arange(N) < active
    mean, cov = estimate_se2(states, live.to(torch.float32), live)
    return xy, z, active, mean.as_xytheta().numpy(), cov.numpy()


def _slot_positions(kw, step, world):
    """Each sharded slot's resample position and the float64 CDF edges it
    is searched in: ``(positions [N], cdf id [N], cdfs)``."""
    from beluga_tpu_torch.ops.resample import interleave_ranks, sorted_residual_from_uniform

    adaptive = kw["min_particles"] < kw["max_particles"]
    w = np.exp(step["pre_log_w"].astype(np.float64))
    cdfs = [np.cumsum(w) / w.sum()]
    slots = torch.arange(N)
    if kw["resampling"] == "multinomial":
        p = step["draws"].positions.numpy().astype(np.float64)
        return _shard_interleave(p, world), np.zeros(N, int), cdfs
    ranks = (interleave_ranks(slots, N) if adaptive else slots).numpy()
    if kw["resampling"] != "residual":
        return step["draws"].positions.numpy().astype(np.float64)[ranks], np.zeros(N, int), cdfs
    w32 = np.exp(step["pre_log_w"]).astype(np.float32)
    w32 = w32 / w32.sum()
    counts = np.floor(w32 * N)
    r0 = counts.sum()
    res = w32 * N - counts
    cdfs += [np.cumsum(counts) / max(r0, 1), np.cumsum(res) / res.sum()]
    q = sorted_residual_from_uniform(step["draws"].residual_uniforms,
                                     torch.tensor(np.float32(r0))).numpy()
    det = ranks < r0
    pos = np.where(det, (ranks + 0.5) / max(r0, 1.0), q[ranks])
    return pos, np.where(det, 1, 2), cdfs


def _near_edge(kw, step, world):
    pos, which, cdfs = _slot_positions(kw, step, world)
    near = np.zeros(N, bool)
    for i, cdf in enumerate(cdfs):
        sel = which == i
        near[sel] = np.min(np.abs(pos[sel, None] - cdf[None, :]), axis=1) <= CDF_ULP
    return near


# -- the tests -------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(SAME_DRAWS)),
                         ids=[f"{kw['resampling']}-{'kld' if kw['min_particles'] < N else 'fixed'}"
                              for kw in SAME_DRAWS])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_update_matches_dense_on_same_draws(request, dense, world, case):
    got = request.getfixturevalue(f"world{world}")["same_draws"][case]
    kw, steps = dense[case]
    for t, (g, d) in enumerate(zip(got, steps)):
        xy, z, active, est, cov = _expected(kw, d, world)
        np.testing.assert_allclose(g["est"][:2], est[:2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["cov"][:2, :2], cov[:2, :2], rtol=0, atol=1e-4)
        if world == 1:
            for key in ("xy", "z", "log_w", "pre_log_w"):
                np.testing.assert_array_equal(g[key], d[key], err_msg=f"update {t}: {key}")
            assert g["active"] == d["active"]
            continue
        np.testing.assert_allclose(g["pre_log_w"], d["pre_log_w"], rtol=1e-6, atol=0)
        differ = np.any(g["xy"] != xy, -1) | np.any(g["z"] != z, -1)
        near = _near_edge(kw, d, world)
        assert not np.any(differ & ~near), f"update {t}: a donor differs away from a CDF edge"
        assert differ.sum() < N / 1000, f"update {t}: {differ.sum()} donors differ"
        assert g["active"] == active
        np.testing.assert_array_equal(g["log_w"], d["log_w"] if active == d["active"]
                                      else np.where(np.arange(N) < active, np.float32(0.0),
                                                    np.float32(-1e30)))


def test_matches_jax_mega_deterministic_pieces(jax_pieces, world4):
    want, got = jax_pieces[0], world4["jax_pieces"]
    np.testing.assert_allclose(got["log_w"], want["log_w"], atol=1e-4)
    np.testing.assert_allclose(got["est"][:2], want["est"][:2], atol=1e-5)
    np.testing.assert_allclose(got["cov"][:2, :2], want["cov"][:2, :2], atol=1e-4)


def _error(est, pose=TRUE_POSE):
    return float(np.hypot(est[0] - pose[0], est[1] - pose[1]))


def test_mega_update_tracks(world4):
    r = world4["statistics"]["tracks"]
    assert r["valid"] and all(r["finite"])
    assert _error(r["est"]) < 0.5
    assert 128 <= r["active"][-1] <= N


def test_mega_recovery_and_kld(world4):
    r = world4["statistics"]["recovery_kld"]
    assert all(r["finite"])
    assert all(128 <= a <= N for a in r["active"])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mega_resampling_strategies_track(world4, strategy):
    r = world4["statistics"][strategy]
    assert r["valid"]
    assert _error(r["est"]) < 0.5, f"{strategy}: err={_error(r['est']):.3f}"


def test_mega_flagship_winlut_sorted_slots_tracks(world4):
    r = world4["statistics"]["flagship"]
    assert r["valid"] and all(r["finite"])
    assert _error(r["est"]) < 0.3


def test_mega_flagship_tracks_dense_run_on_two_ranks(world2):
    gaps = world2["flagship_gaps"]
    assert np.all(gaps < 0.05), f"sharded diverged from dense by {gaps.max():.4f}"


def test_mega_flagship_recovery_burst(world4):
    assert all(world4["statistics"]["burst"]["finite"])


def test_mega_residual_floor_copies(world4):
    r = world4["statistics"]["residual_floor"]
    n = r["x_in"].shape[0]
    w = np.exp(r["log_w"].astype(np.float64))
    counts = np.floor(w / w.sum() * n)
    for i in np.nonzero(counts > 0)[0]:
        got = np.sum(r["x_out"] == r["x_in"][i])
        assert got >= counts[i], f"particle {i}: {got} copies < floor count {counts[i]}"


@pytest.mark.parametrize("pool", [0, 64])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_draw_update_draws_what_the_update_draws(strategy, pool):
    """``draw_update`` from a copy of the state's generator gives the draws
    that the dense update takes from the generator itself, in its order:
    the two updates are bit-equal (the first update's recovery probability
    is 0, so ``p_random=0.0``)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, draw_update, host_pose, update

    models, ctx = port_world()
    params = AmclParams(max_particles=N, min_particles=128, resampling=strategy,
                        recovery_pool=pool)
    state = initial_state(params, seed=3)._replace(force_update=np.asarray(True))
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-3, 3, (BEAMS, 2)),
                          dtype=torch.float32)
    mask = torch.ones(BEAMS, dtype=torch.bool)

    def copy(gen):
        out = torch.Generator()
        out.set_state(gen.get_state())
        return out

    draws = draw_update(params, models, ctx, state.particles, copy(state.generator),
                        p_random=0.0)
    runs = [update(params, models, ctx, state._replace(generator=copy(state.generator)),
                   host_pose(*TRUE_POSE), pts, mask, draws=d)[0].particles
            for d in (None, draws)]
    assert torch.equal(runs[0].log_weight, runs[1].log_weight)
    assert torch.equal(runs[0].active, runs[1].active)
    assert torch.equal(runs[0].state.xy, runs[1].state.xy)
    assert torch.equal(runs[0].state.rot.z, runs[1].state.rot.z)

"""The port's shared-scan filter (``filters/builders.py:make_shared_scan_filter``)
held against the JAX package on the CPU: one update with the reference's
draws, a fleet sharing one LUT (``tests/test_scan_lut.py:88-141``), and a
short tracking run.

Tolerances:
* the LUT that ``prepare`` builds (the roll build, the CPU default) within
  rtol 1e-5 / atol 1e-6 of the reference's (XLA contracts the four-corner
  sum into FMAs), and the model's log-weights on the reference's LUT
  within 1e-6 (``log`` in two libraries);
* one update of 1024 particles, systematic resampling, the reference's
  draws: states within 1e-5 where the same donor was taken (a weight within
  ~1e-7 of a CDF step may take the neighbouring one; at most 0.5% of the
  slots), the estimate within 1e-4 plus the moved slots' share.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.core.random import sample_normal_se2 as j_sample_normal_se2
from beluga_tpu.core.random import sample_uniform_free_cells as j_sample_free_cells
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.builders import make_shared_scan_filter as j_make_shared
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.builders import make_shared_scan_filter
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.parallel.fleet import make_fleet_update

torch.set_num_threads(1)

GATE_POS, GATE_YAW = 0.9, math.radians(30.0)  # tests/test_system.py:44-45
KW = dict(n_theta=16, max_point_radius=2.5)


def t(a):
    return torch.as_tensor(np.array(a))


def block_map():
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    return data


def scan():
    rng = np.random.default_rng(2)
    angles = np.linspace(-np.pi, np.pi, 24, endpoint=False)
    r = rng.uniform(0.5, 2.0, 24)
    return np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32), np.ones(
        24, bool)


@functools.partial(jax.jit, static_argnums=3)
def _draws(key, free_xy, num_free, n):
    _, k_prop, k_res, k_rand, k_mask = jax.random.split(key, 5)
    return (jax.random.normal(k_prop, (3, n), jnp.float32), j_systematic_positions(k_res, n),
            jax.random.uniform(k_mask, (n,), jnp.float32),
            j_sample_free_cells(k_rand, n, free_xy, num_free))


def reference_draws(jstate, jctx, n):
    """Every draw of the reference's update from its key
    (filters/amcl.py:315), as the port's ``UpdateDraws``; one jit, so the
    reference compiles once rather than per operation."""
    grid = jctx["grid"]
    normals, positions, uniform, randoms = _draws(jstate.key, grid.free_xy, grid.num_free, n)
    return amcl.UpdateDraws(
        motion_normals=t(normals),
        positions=t(positions),
        inject_uniform=t(uniform),
        random_states=convert.se2(jax.device_get(randoms)),
    )


def test_one_update_matches_reference():
    lf = dict(max_laser_distance=5.0)
    jmodels, jctx, jprepare = j_make_shared(j_make_grid(block_map(), 0.1), JLFParams(**lf), **KW)
    models, ctx, prepare = make_shared_scan_filter(make_grid(block_map(), 0.1, device="cpu"),
                                                   LikelihoodFieldParams(**lf), device="cpu",
                                                   **KW)
    pts, mask = scan()
    jsctx = jprepare(jctx, jnp.asarray(pts), jnp.asarray(mask))
    sctx = prepare(ctx, t(pts), t(mask))
    np.testing.assert_allclose(sctx["scan_lut"].values.numpy(),
                               np.asarray(jsctx["scan_lut"].values), rtol=1e-5, atol=1e-6)
    assert sctx["scan_lut"].pad_cells == jsctx["scan_lut"].pad_cells
    ref_ctx = convert.ctx(jax.device_get(jsctx))  # the reference's LUT in the port's types

    n = 1024
    kw = dict(max_particles=n, min_particles=n, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(4))
    jstates = j_sample_normal_se2(k_init, n, JSE2.from_xytheta(3.2, 3.2, 0.3),
                                  jnp.diag(jnp.asarray([0.1, 0.1, 0.05])))
    jstate = j_amcl.init_state(k_state, jstates, jparams)
    state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
    want_lw = np.asarray(jmodels.log_weight(jsctx, jstates, jnp.asarray(pts), jnp.asarray(mask)))
    got_lw = models.log_weight(ref_ctx, state.particles.state, t(pts), t(mask)).numpy()
    np.testing.assert_allclose(got_lw, want_lw, rtol=0, atol=1e-6)
    draws = reference_draws(jstate, jctx, n)
    odom = (0.3, 0.0, 0.0)
    jnew, jest = jax.jit(lambda s, o, p, m: j_amcl.update(jparams, jmodels, jsctx, s, o, p, m))(
        jstate, JSE2.from_xytheta(*odom), jnp.asarray(pts), jnp.asarray(mask))
    new, est = amcl.update(params, models, ref_ctx, state, amcl.host_pose(*odom), t(pts),
                           t(mask), draws=draws)
    ref = jax.device_get(jnew)
    assert est.valid and bool(jest.valid)
    xy, z = new.particles.state.xy.numpy(), new.particles.state.rot.z.numpy()
    jxy, jz = np.asarray(ref.particles.state.xy), np.asarray(ref.particles.state.rot.z)
    other = (np.abs(xy - jxy).max(1) > 1e-5) | (np.abs(z - jz).max(1) > 1e-5)
    assert other.sum() <= n // 200, f"{other.sum()} slots hold another donor"
    np.testing.assert_allclose(xy[~other], jxy[~other], rtol=0, atol=1e-5)
    np.testing.assert_allclose(z[~other], jz[~other], rtol=0, atol=1e-5)
    d = np.abs(np.concatenate([xy - jxy, z - jz], 1)).max(1)[other]
    np.testing.assert_allclose(est.pose.xy.numpy(), np.asarray(jest.pose.xy),
                               atol=1e-4 + float(d.sum()) / n)


@pytest.mark.parametrize("lut_build", ["roll", "pallas"])
def test_fleet_shares_one_lut(lut_build):
    """tests/test_scan_lut.py:88-141 in the port: a fleet of 4 filters
    from one prior scores one shared LUT through the fleet update; each
    filter's log-weights equal those of the same states scored alone, and
    the estimates agree."""
    models, ctx, prepare = make_shared_scan_filter(
        make_grid(block_map(), 0.1, device="cpu"), LikelihoodFieldParams(max_laser_distance=5.0),
        lut_build=lut_build, device="cpu", **KW)
    params = amcl.AmclParams(max_particles=256, min_particles=64)
    pts, mask = (t(a) for a in scan())
    sctx = prepare(ctx, pts, mask)
    batch = 4
    state = amcl.init_fleet_state(0, batch, amcl.host_pose(3.2, 3.2, 0.0), np.eye(3) * 0.2,
                                  params, device="cpu")
    fleet = state.particles.state
    stacked = models.log_weight(sctx, fleet, pts, mask)
    for b in range(batch):
        alone = SE2(fleet.xy[b], SO2(fleet.rot.z[b]))
        assert torch.equal(models.log_weight(sctx, alone, pts, mask), stacked[b])
    odoms = SE2.from_xytheta(np.full(batch, 0.3), np.zeros(batch), np.zeros(batch), device="cpu")
    step = make_fleet_update(params, models)
    state, est = step(sctx, state, odoms, pts.expand(batch, -1, -1).contiguous(),
                      mask.expand(batch, -1).contiguous())
    assert bool(np.all(est.valid))
    xy = est.pose.xy.numpy()
    assert np.isfinite(xy).all() and xy[:, 0].std() < 0.5


def test_shared_scan_filter_tracks_arena():
    """The bench's shared-scan configuration (``lut_build="pallas"`` with
    nearest sampling and downsample 2, systematic resampling, KLD), cut to
    2000 particles and 32 bins on a 160-cell arena, rebuilding the LUT every
    update: every estimate within 0.9 m / 30 degrees."""
    res, scans = 0.05, 8
    data = synthetic.tracking_arena(160, res)
    xs, ys, yaws = synthetic.circle_trajectory(scans, 160, res)
    pts, mask = synthetic.simulate_scans(data, res, xs, ys, yaws, 60)
    models, ctx, prepare = make_shared_scan_filter(
        make_grid(data, res, device="cpu"), n_theta=32, max_point_radius=3.6,
        lut_build="pallas", lut_build_kwargs=dict(sampling="nearest", downsample=2),
        device="cpu")
    params = amcl.AmclParams(max_particles=2000, min_particles=500, resampling="systematic")
    from beluga_tpu_torch.core.random import sample_normal_se2

    gen = torch.Generator().manual_seed(0)
    states = sample_normal_se2(gen, 2000, amcl.host_pose(xs[0], ys[0], yaws[0]),
                               np.diag([0.25, 0.25, 0.068]))
    state = amcl.init_state(gen, states, params, device="cpu")
    step = functools.partial(amcl.update, params, models)
    for i in range(scans):
        p, m = t(pts[i]), t(mask[i])
        sctx = prepare(ctx, p, m)
        assert sctx["scan_lut"].values.shape == (32, 160, 256)
        state, est = step(sctx, state._replace(force_update=True),
                          amcl.host_pose(xs[i], ys[i], yaws[i]), p, m)
        pose = est.pose.as_xytheta().numpy()
        err_yaw = abs(math.atan2(math.sin(pose[2] - yaws[i]), math.cos(pose[2] - yaws[i])))
        assert math.hypot(pose[0] - xs[i], pose[1] - ys[i]) < GATE_POS, i
        assert err_yaw < GATE_YAW, i


@pytest.mark.parametrize("lut_build", ["roll", "pallas"])
def test_map_swap_rebuilds_padded_field(lut_build):
    """The padded pz³ image lives in the ctx and ``update_map_ctx`` rebuilds
    it for the new map, at the new map's resolution: after a swap from 0.1 m
    to 0.05 m cells, ``prepare`` builds the LUT a fresh filter on the new
    map builds."""
    from beluga_tpu_torch.filters.builders import update_map_ctx
    from beluga_tpu_torch.models.sensor.likelihood_field_lut import scan_lut_padded

    lf = LikelihoodFieldParams(max_laser_distance=5.0)
    kw = dict(n_theta=8, max_point_radius=2.5, lut_build=lut_build, device="cpu")
    if lut_build == "pallas":
        kw["lut_build_kwargs"] = dict(sampling="nearest", downsample=2)
    _, ctx, prepare = make_shared_scan_filter(make_grid(block_map(), 0.1, device="cpu"), lf, **kw)
    down = 2 if lut_build == "pallas" else 1
    assert ctx["scan_lut_pad3"][1] == (27 if down == 1 else 15)
    fine = np.kron(block_map(), np.ones((2, 2), np.int8))
    swapped = update_map_ctx(ctx, make_grid(fine, 0.05, device="cpu"), lf)
    padded, pad = scan_lut_padded(swapped["field"], 2.5, lut_build, down)
    assert swapped["scan_lut_pad3"][1] == pad == (52 if down == 1 else 27)
    assert torch.equal(swapped["scan_lut_pad3"][0], padded)
    _, fresh, _ = make_shared_scan_filter(make_grid(fine, 0.05, device="cpu"), lf, **kw)
    pts, mask = (t(a) for a in scan())
    got, want = prepare(swapped, pts, mask)["scan_lut"], prepare(fresh, pts, mask)["scan_lut"]
    assert (got.pad_cells, got.resolution) == (want.pad_cells, want.resolution)
    assert torch.equal(got.values, want.values)


def test_unknown_build_rejected():
    with pytest.raises(ValueError, match="lut_build"):
        make_shared_scan_filter(make_grid(block_map(), 0.1, device="cpu"), lut_build="gpu",
                                device="cpu")

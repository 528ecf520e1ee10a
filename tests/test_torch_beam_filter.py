"""The port's beam filter (``filters/builders.py:make_beam_filter``) and the
beam node, held against the JAX package on the CPU.

* The model's log-weights in the ``exact``, ``supercover``, ``lut`` and
  ``sphere_trace`` modes on the same states and scans: every particle
  within rtol 2e-5 (``torch.erf``/``exp`` against XLA's, as
  tests/test_torch_beam.py), and at most 10% (exact modes) or 1% (``lut``,
  ``sphere_trace``) of them beyond 1e-6 (measured: at most 2.2e-6, on 5% of
  the particles).  XLA's CPU backend contracts the beam directions
  ``c·bx − s·by`` and ``|p|`` into FMAs, which moves them by an ulp and a
  grazing ray's cells with them; so the inputs are ones whose directions
  both packages compute exactly (beams along the robot's axes, or headings
  along the map's, and points on a 1/64 m grid), and no particle is left
  out.  Both packages read the same tables (``convert.ctx``).
* One filter update, the forced first one and then a gated-in move, and a
  fleet of B = 3 against ``jax.vmap(update)``, fed the reference's draws,
  at the slice-1 tolerances of ``tests/test_torch_filter.py`` (states
  within 1e-5, log-weights, gates and counters equal, the estimate within
  1e-4, up to 0.5% of the slots holding another donor).  So that no ray is
  ulp-sensitive, the particles head along +x, the beams run along the axes
  and the motion is noiseless along x: every direction is exact in both
  packages.
* ``windowed``: off its TPU the reference's filter falls back to the gather
  LUT (beam_lut.py:119); the port runs kernel B7's plain version, so its
  log-weights are held against the reference's kernel,
  ``_windowed_impl(interpret=True)``, at B7's tolerances
  (tests/test_torch_beam_lut.py).
* The ``AmclNode`` beam behaviours of tests/test_config_and_node.py:137-155
  and tracking runs within 0.9 m / 30 degrees.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_filter import reference_draws
from test_torch_fleet import compare_filter, fleet_draws
from test_torch_node import make_node, scan_toward_wall

from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.builders import make_beam_filter as j_make_beam_filter
from beluga_tpu.io.config import AmclNodeConfig as JAmclNodeConfig
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.lie import SO2 as JSO2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.motion.differential_drive import (
    DifferentialDriveParams as JDifferentialDriveParams,
)
from beluga_tpu.models.sensor.beam import BeamModelParams as JBeamModelParams
from beluga_tpu.ops.pallas_beam_lut import _windowed_impl
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.builders import make_beam_filter, sphere_trace_steps
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
from beluga_tpu_torch.models.sensor.beam import BeamModelParams
from beluga_tpu_torch.models.sensor.beam_lut import lut_cells
from beluga_tpu_torch.node import AmclNode
from beluga_tpu_torch.parallel.fleet import make_fleet_update

torch.set_num_threads(1)

GATE_POS, GATE_YAW = 0.9, math.radians(30.0)  # tests/test_system.py:44-45
SIZE, RES, BEAMS = 80, 0.1, 30
# mode: (the filter's keyword arguments, beam_max_range)
MODES = {
    "exact": (dict(), 4.0),
    "supercover": (dict(raycast_variant="supercover"), 4.0),
    "lut": (dict(use_range_lut=True, n_bearings=32), 4.0),
    "sphere_trace": (dict(use_sphere_trace=True), 4.0),
    "windowed": (dict(use_range_lut="windowed", n_bearings=32), 4.0),
}


@pytest.fixture(scope="module")
def world():
    """The synthetic arena (80 cells at 10 cm), one trajectory and its
    30-beam scans."""
    data = synthetic.tracking_arena(SIZE, RES)
    xs, ys, yaws = synthetic.circle_trajectory(3, SIZE, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    return dict(data=data, traj=(xs, ys, yaws), pts=pts, mask=mask)


def filters(world, mode):
    """Both packages' beam filters in ``mode``; the port reads the
    reference's tables."""
    kw, bmr = MODES[mode]
    jmodels, jctx = j_make_beam_filter(j_make_grid(world["data"], RES),
                                       JBeamModelParams(beam_max_range=bmr), **kw)
    models, _ = make_beam_filter(make_grid(world["data"], RES, device="cpu"),
                                 BeamModelParams(beam_max_range=bmr), device="cpu", **kw)
    return jmodels, jctx, models, convert.ctx(jax.device_get(jctx))


def exact_inputs(world, n, rng):
    """Two clouds and scans whose ray directions both packages compute
    exactly, so that no rounding separates them (XLA's CPU backend contracts
    ``c·bx − s·by`` and ``px² + py²`` into FMAs, the port does not):
    particles at random headings with beams along the robot's axes, and
    particles heading along the map's axes with beams at the scan's
    bearings.  Every coordinate of a point is a multiple of 1/64 m, so
    ``|p|`` rounds once in both."""
    xs, ys, yaws = world["traj"]
    x = rng.normal(xs[0], 0.2, (2, n)).astype(np.float32)
    y = rng.normal(ys[0], 0.2, (2, n)).astype(np.float32)
    th = rng.normal(yaws[0], 0.14, n)
    axes = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)
    z = np.stack([np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32),
                  axes[rng.integers(0, 4, n)]])
    pts = world["pts"][0]
    r = np.round(np.linalg.norm(pts, axis=-1) * 64) / 64
    along_axes = (r[:, None] * axes[np.arange(len(r)) % 4]).astype(np.float32)
    at_bearings = (np.round(pts * 64) / 64).astype(np.float32)
    return [(x[i], y[i], z[i], p, world["mask"][0])
            for i, p in enumerate((along_axes, at_bearings))]


@pytest.mark.parametrize("mode,beyond_1e6", [("exact", 0.1), ("supercover", 0.1),
                                            ("lut", 0.01), ("sphere_trace", 0.01)])
def test_beam_log_weights_match_reference(world, mode, beyond_1e6):
    """Every particle within rtol 2e-5 of the reference, and at most a
    ``beyond_1e6`` share of them beyond 1e-6 relative."""
    jmodels, jctx, models, ctx = filters(world, mode)
    for x, y, z, pts, mask in exact_inputs(world, 256, np.random.default_rng(0)):
        jstates = JSE2(jnp.stack([x, y], -1), JSO2(jnp.asarray(z)))
        states = SE2(torch.stack([torch.as_tensor(x), torch.as_tensor(y)], -1),
                     SO2(torch.as_tensor(z)))
        want = np.asarray(jmodels.log_weight(jctx, jstates, jnp.asarray(pts), jnp.asarray(mask)))
        got = models.log_weight(ctx, states, torch.as_tensor(pts), torch.as_tensor(mask)).numpy()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        assert (rel > 1e-6).mean() <= beyond_1e6
        assert np.ptp(want) > 5.0  # the weights do discriminate


def axis_world(world):
    """Particles about the first pose heading exactly along +x, beams along
    the axes only, a noiseless move along x: no direction rounds."""
    xs, ys, _ = world["traj"]
    d = np.array([0.7, 1.1, 1.6, 2.2], np.float32)
    pts = np.concatenate([np.stack([d, 0 * d], -1), np.stack([-d, 0 * d], -1),
                          np.stack([0 * d, d], -1), np.stack([0 * d, -d], -1)])
    mask = np.ones(len(pts), bool)
    mask[5] = False
    odoms = [(float(xs[0]), float(ys[0]), 0.0), (float(xs[0]) + 0.3, float(ys[0]), 0.0)]
    return pts, mask, odoms


def axis_filters(world, mode):
    kw, bmr = MODES[mode]
    motion = dict(motion_params=DifferentialDriveParams(0.0, 0.0, 0.0, 0.0))
    jmodels, jctx = j_make_beam_filter(j_make_grid(world["data"], RES),
                                       JBeamModelParams(beam_max_range=bmr),
                                       motion_params=JDifferentialDriveParams(0.0, 0.0, 0.0, 0.0),
                                       **kw)
    models, _ = make_beam_filter(make_grid(world["data"], RES, device="cpu"),
                                 BeamModelParams(beam_max_range=bmr), device="cpu", **motion,
                                 **kw)
    return jmodels, jctx, models, convert.ctx(jax.device_get(jctx))


@pytest.mark.parametrize("mode", ["exact", "supercover", "lut", "sphere_trace"])
def test_one_beam_update_matches_reference(world, mode):
    n = 512
    kw = dict(max_particles=n, min_particles=n, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx, models, ctx = axis_filters(world, mode)
    pts, mask, odoms = axis_world(world)
    rng = np.random.default_rng(5)
    x0, y0, _ = odoms[0]
    jstate = j_amcl.init_state(jax.random.PRNGKey(5), JSE2.from_xytheta(
        rng.normal(x0, 0.2, n).astype(np.float32), rng.normal(y0, 0.2, n).astype(np.float32),
        np.zeros(n, np.float32)), jparams)
    jstep = jax.jit(lambda s, o, p, m: j_amcl.update(jparams, jmodels, jctx, s, o, p, m))
    for odom in odoms:  # the forced first update, then a gated-in move
        state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
        draws = reference_draws(jstate, jctx, n, n)
        jstate, jest = jstep(jstate, JSE2.from_xytheta(*odom), jnp.asarray(pts),
                             jnp.asarray(mask))
        state, est = amcl.update(params, models, ctx, state, amcl.host_pose(*odom),
                                 torch.as_tensor(pts), torch.as_tensor(mask), draws=draws)
        ref, jest = jax.device_get((jstate, jest))
        assert est.valid and bool(jest.valid)
        xy, z = state.particles.state.xy.numpy(), state.particles.state.rot.z.numpy()
        jxy, jz = np.asarray(ref.particles.state.xy), np.asarray(ref.particles.state.rot.z)
        other = (np.abs(xy - jxy).max(1) > 1e-5) | (np.abs(z - jz).max(1) > 1e-5)
        assert other.sum() <= n // 200, f"{other.sum()} slots hold another donor"
        np.testing.assert_allclose(xy[~other], jxy[~other], rtol=0, atol=1e-5)
        np.testing.assert_allclose(z[~other], jz[~other], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(state.particles.log_weight.numpy(),
                                      np.asarray(ref.particles.log_weight))
        for got, want in ((state.thrun.slow, ref.thrun.slow), (state.thrun.fast, ref.thrun.fast)):
            np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-5)
        assert state.resample_count == int(ref.resample_count)
        d = np.abs(np.concatenate([xy - jxy, z - jz], 1)).max(1)[other]
        moved = float(d.sum()) / n
        np.testing.assert_allclose(est.pose.xy.numpy(), np.asarray(jest.pose.xy),
                                   atol=1e-4 + moved)
        np.testing.assert_allclose(est.pose.rot.z.numpy(), np.asarray(jest.pose.rot.z),
                                   atol=1e-4 + moved)
        jstate = ref


def test_windowed_filter_scores_as_the_reference_kernel(world):
    """The windowed filter's log-weights on a cloud with strays equal the
    log of the reference's kernel on the same cells; an update then runs
    and tracks."""
    _, jctx, models, ctx = filters(world, "windowed")
    assert ctx["range_lut_bf16"].dtype == torch.bfloat16
    xs, ys, yaws = world["traj"]
    rng = np.random.default_rng(6)
    n = 300
    px = rng.normal(xs[0], 0.2, n).astype(np.float32)
    py = rng.normal(ys[0], 0.2, n).astype(np.float32)
    px[::20] += 3.0  # strays beyond their window score as if every cast missed
    th = np.sort(rng.normal(yaws[0], 0.1, n)).astype(np.float32)
    states = SE2.from_xytheta(px, py, th)
    pts, mask = torch.as_tensor(world["pts"][0]), torch.as_tensor(world["mask"][0])
    got = models.log_weight(ctx, states, pts, mask)
    local, xi, yi = lut_cells(ctx["range_lut"], states)
    p = BeamModelParams(beam_max_range=4.0)
    mix = jnp.asarray([p.z_hit, p.z_short, p.z_rand, p.z_max, p.sigma_hit, p.lambda_short,
                       p.beam_max_range], jnp.float32)
    z = torch.sqrt(pts[:, 0] * pts[:, 0] + pts[:, 1] * pts[:, 1])
    bearing = torch.atan2(pts[:, 1], pts[:, 0])
    want = _windowed_impl(jctx["range_lut_bf16"], jnp.asarray(local.theta.numpy())[None],
                          jnp.asarray(xi.numpy())[None], jnp.asarray(yi.numpy())[None],
                          jnp.asarray(z.numpy())[None], jnp.asarray(bearing.numpy())[None],
                          jnp.asarray(mask.numpy())[None], 4.0, mix, interpret=True)[0]
    # the log of B7's tolerance (rtol 2e-4 where the reference's reciprocal
    # division moves a bin, tests/test_torch_beam_lut.py)
    np.testing.assert_allclose(got.numpy(), np.log(np.maximum(np.asarray(want), 1e-30)),
                               rtol=0, atol=2e-4)
    params = amcl.AmclParams(max_particles=n, min_particles=n, sorted_slots=True)
    state = amcl.init_state(0, states, params, device="cpu")
    for step in range(3):
        state, est = amcl.update(params, models, ctx, state._replace(force_update=True),
                                 amcl.host_pose(xs[step], ys[step], yaws[step]),
                                 torch.as_tensor(world["pts"][step]),
                                 torch.as_tensor(world["mask"][step]))
        assert est.valid and torch.isfinite(state.particles.log_weight).all()
    assert math.hypot(float(est.pose.x) - xs[2], float(est.pose.y) - ys[2]) < GATE_POS


@pytest.mark.parametrize("mode", ["exact", "sphere_trace"])
def test_one_beam_fleet_update_matches_reference_vmap(world, mode):
    """B = 3, N = 256, systematic, min == max, sorted slots, each filter
    with its own cloud, odometry frame and beam mask."""
    b, n = 3, 256
    kw = dict(max_particles=n, min_particles=n, resampling="systematic", sorted_slots=True)
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx, models, ctx = axis_filters(world, mode)
    pts, mask, odoms = axis_world(world)
    rng = np.random.default_rng(6)
    x0, y0, _ = odoms[0]
    keys = jax.random.split(jax.random.PRNGKey(6), b)
    jstate = jax.vmap(lambda k, x, y: j_amcl.init_state(
        k, JSE2.from_xytheta(x, y, jnp.zeros(n, jnp.float32)), jparams))(
        keys, jnp.asarray(rng.normal(x0, 0.2, (b, n)), jnp.float32),
        jnp.asarray(rng.normal(y0, 0.2, (b, n)), jnp.float32))
    jstep = jax.jit(jax.vmap(functools.partial(j_amcl.update, jparams, jmodels),
                             in_axes=(None, 0, 0, 0, 0)))
    fleet_update = make_fleet_update(params, models)
    pts_b = np.broadcast_to(pts, (b, *pts.shape)).copy()
    mask_b = np.broadcast_to(mask, (b, len(mask))).copy()
    mask_b[1, 8:11] = False  # the filters see different beams
    for ox, oy, _ in odoms:
        off = 0.01 * np.arange(b)  # each filter has its own odometry frame
        odom = (np.float32(ox) + off.astype(np.float32), np.full(b, oy, np.float32),
                np.zeros(b, np.float32))
        state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
        draws = fleet_draws(jstate, jctx, n, n)
        jstate, jest = jstep(jctx, jstate, JSE2.from_xytheta(*map(jnp.asarray, odom)),
                             jnp.asarray(pts_b), jnp.asarray(mask_b))
        state, est = fleet_update(ctx, state, SE2.from_xytheta(*odom, device="cpu"),
                                  torch.as_tensor(pts_b), torch.as_tensor(mask_b), draws=draws)
        ref, jest = jax.device_get((jstate, jest))
        assert est.valid.tolist() == [True] * b
        for f in range(b):
            compare_filter(state, est, ref, jest, f, n)
        jstate = ref


def test_march_budget_and_builder_checks():
    assert sphere_trace_steps(100.0, 0.05) == 89  # nav2's 100 m at 5 cm
    assert sphere_trace_steps(60.0, 0.1) == 48  # the long-range regime
    assert sphere_trace_steps(4.0, 0.05) == 20 and sphere_trace_steps(1e4, 0.01) == 96
    grid = make_grid(np.zeros((8, 8), np.int8), 0.1, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        make_beam_filter(grid, raycast_variant="dda", device="cpu")
    with pytest.raises(ValueError, match="use_range_lut"):
        make_beam_filter(grid, use_range_lut="sparse", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_beam_filter(grid)


# -- the node (tests/test_config_and_node.py:137-155) --------------------------


def test_beam_model_node():
    node = make_node(laser_model_type="beam", laser_max_range=8.0)
    assert set(node._ctx) == {"grid"}
    res = node.handle_scan((0.0, 0.0, 0.0), scan_toward_wall())
    assert res.valid and np.isfinite(res.pose).all()


@pytest.mark.parametrize("fast_path", ["lut", "windowed", "sphere_trace"])
def test_beam_fast_path_node(fast_path):
    node = make_node(laser_model_type="beam", laser_max_range=8.0, beam_fast_path=fast_path)
    if fast_path == "windowed":
        assert node._ctx["range_lut_bf16"].dtype == torch.bfloat16
    if fast_path == "sphere_trace":
        assert node._ctx["beam_dist"].dtype == torch.uint8
    res = node.handle_scan((0.0, 0.0, 0.0), scan_toward_wall())
    assert res.valid and np.isfinite(res.pose).all()


def test_invalid_beam_fast_path_rejected():
    with pytest.raises(ValueError):
        AmclNodeConfig(beam_fast_path="warp")


def test_beam_params_match_reference():
    """io/config.py:194-203: the nav2 names map onto BeamModelParams."""
    kw = dict(z_hit=0.6, z_short=0.1, z_max=0.02, z_rand=0.3, sigma_hit=0.25,
              lambda_short=0.2, laser_max_range=30.0)
    assert (dataclasses.asdict(AmclNodeConfig(**kw).beam_params())
            == dataclasses.asdict(JAmclNodeConfig(**kw).beam_params()))
    assert AmclNodeConfig().beam_params() == BeamModelParams(
        z_hit=0.5, z_short=0.05, z_max=0.05, z_rand=0.5, sigma_hit=0.2, lambda_short=0.1,
        beam_max_range=100.0)


@pytest.mark.parametrize("fast_path,max_range", [("sphere_trace", 100.0), ("windowed", 6.0)])
def test_beam_node_tracks_synthetic_arena(fast_path, max_range):
    """The beam node at nav2 defaults (KLD 500-2000, 60 beams, cluster
    estimate) tracks the 160-cell arena's circle within the gate; at 100 m
    in the sphere trace, and at 6 m (the 8 m arena's diagonal over its
    3.5 m scans) in the windowed mode, whose 128-bin LUT the plain version
    casts on the CPU."""
    scans = 10
    data = synthetic.tracking_arena(SIZE, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, SIZE, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    cfg = AmclNodeConfig(laser_model_type="beam", beam_fast_path=fast_path,
                         laser_max_range=max_range, set_initial_pose=True, initial_pose_x=float(xs[0]),
                         initial_pose_y=float(ys[0]), initial_pose_yaw=float(yaws[0]),
                         initial_pose_covariance_yaw=0.068)
    node = AmclNode(cfg, seed=1, device="cpu")
    node.set_map(make_grid(data, RES, device="cpu"))
    for step in range(scans):
        r = node.handle_scan((xs[step], ys[step], yaws[step]), pts[step], mask[step])
        assert r.valid
        yaw_err = abs(math.atan2(math.sin(r.pose[2] - yaws[step]), math.cos(r.pose[2] - yaws[step])))
        assert math.hypot(r.pose[0] - xs[step], r.pose[1] - ys[step]) < GATE_POS, step
        assert yaw_err < GATE_YAW, step

"""The NDT filters (2D, 3D and a small fleet), their estimate-based
recovery, the NDT nodes and the NDT map tools of the PyTorch port, held
against the JAX package on the CPU.

Every map is the synthetic arena fitted by ``tools/make_ndt_map.py``: at
0.4 m in 2D (287 rows) and, extruded to 2 m, at 0.5 m in 3D (996 rows),
so that the stencil probe (kernel B10's plain version) scores every
update; no test reads the C++ reference's HDF5 maps.

One update: the port is handed every draw the reference made from its key
splits (``filters/amcl.py:315``); a fresh Thrun state gives a recovery
probability of 0, so no slot is injected.  Tolerances are those of
``tests/test_torch_filter.py``: particle states within 1e-5, log-weights
within 2e-5 (the NDT weights themselves agree within rtol 1e-5,
``tests/test_torch_ndt.py``), the estimate within 1e-4 widened by the
offsets of slots that took the neighbouring donor, counters equal.  Up to
1% of the slots may hold another particle: a systematic position within
the weights' last bits of a CDF step takes the neighbouring donor.  The
recovery cores get the reference's normals times the eigenvector signs
that LAPACK's two builds pick differently (``test_torch_se3.py``), and
agree within 1e-4 (the estimate's own tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.core.particles import make_from_states as j_make_from_states
from beluga_tpu.core.random import sample_normal_se2 as j_sample_normal_se2
from beluga_tpu.core.random import sample_normal_se3 as j_sample_normal_se3
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.ndt_builders import make_ndt_filter_2d as j_make_ndt_2d
from beluga_tpu.filters.ndt_builders import make_ndt_filter_3d as j_make_ndt_3d
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.lie import SE3 as JSE3
from beluga_tpu.lie import SO3 as JSO3
from beluga_tpu.maps.ndt import load_ndt_hdf5 as j_load_ndt_hdf5
from beluga_tpu.maps.ndt import make_ndt_map as j_make_ndt_map
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu.tools import make_ndt_map as j_tools
from beluga_tpu_torch import convert
from beluga_tpu_torch.core.particles import tree_map
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.ndt_builders import (
    make_ndt_filter_2d,
    make_ndt_filter_3d,
    recovery_se2_from_draws,
    recovery_se3_from_draws,
)
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE2, SE3
from beluga_tpu_torch.maps.ndt import load_ndt_hdf5, make_ndt_map
from beluga_tpu_torch.ndt_node import NdtAmclNode, NdtAmclNode3D, pack_cloud_input
from beluga_tpu_torch.tools import make_ndt_map as tools

torch.set_num_threads(1)

TRUTH = np.array([7.0, 9.0, 0.3])  # a pose inside the arena


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def maps():
    data = synthetic.tracking_arena(384, 0.05)
    p2 = tools.grid_to_points(data, 0.05)
    p3 = np.concatenate([np.c_[p2, np.full(len(p2), z)] for z in np.arange(0, 2, 0.1)])
    out = {}
    for d, pts, cell in ((2, p2, 0.4), (3, p3, 0.5)):
        cells, means, covs = tools.fit_ndt_cells(pts, cell)
        out[d] = (j_make_ndt_map(cells, means, covs, cell),
                  make_ndt_map(cells, means, covs, cell, device="cpu"), p2)
    return out


def cloud(world2d, d, seed, n=60, live=12, pose=TRUTH):
    """Points about ``live`` map points near the pose, in its robot frame
    (bench.py:793-809 with live cells); in 3D at heights 0.1-1.9 m."""
    rng = np.random.default_rng(seed)
    near = world2d[np.linalg.norm(world2d - pose[:2], axis=1) < 3.0]
    sel = near[rng.integers(0, len(near), live)][rng.integers(0, live, n)]
    c, s = np.cos(pose[2]), np.sin(pose[2])
    local = (sel - pose[:2]) @ np.array([[c, -s], [s, c]]) + rng.normal(0, 0.01, (n, 2))
    if d == 3:
        local = np.c_[local, rng.uniform(0.1, 1.9, n)]
    return local.astype(np.float32)


def reference_draws(key, n):
    """The draws of one reference update from its key (systematic
    resampling): motion normals, positions, injection uniforms."""
    _, k_prop, k_res, _, k_mask = jax.random.split(key, 5)
    return (jax.random.normal(k_prop, (3, n), jnp.float32), j_systematic_positions(k_res, n),
            jax.random.uniform(k_mask, (n,), jnp.float32))


def draws_of(parts, states):
    """The port's draws; the recovery states are unused at a recovery
    probability of 0, so the port gets its own particles there."""
    z, pos, inj = (t(a) for a in parts)
    return amcl.UpdateDraws(motion_normals=z, positions=pos, inject_uniform=inj,
                            random_states=states)


def compare(state, est, ref, jest, n, dim):
    """The tolerances of the module docstring, for one filter."""
    leaves = ((state.particles.state.xy, ref.particles.state.xy),
              (state.particles.state.rot.z, ref.particles.state.rot.z)) if dim == 2 else (
        (state.particles.state.xyz, ref.particles.state.xyz),
        (state.particles.state.rot.q, ref.particles.state.rot.q))
    other = np.zeros(n, bool)
    for got, want in leaves:
        other |= np.abs(got.numpy() - np.asarray(want)).max(-1) > 1e-5
    assert other.sum() <= n // 100, f"{other.sum()} slots hold another donor"
    for got, want in leaves:
        np.testing.assert_allclose(got.numpy()[~other], np.asarray(want)[~other], atol=1e-5)
    active = int(state.particles.active)
    assert abs(active - int(ref.particles.active)) <= (n // 100 if other.any() else 0)
    live = np.arange(n) < min(active, int(ref.particles.active))
    np.testing.assert_allclose(state.particles.log_weight.numpy()[live],
                               np.asarray(ref.particles.log_weight)[live], atol=2e-5)
    assert state.resample_count == int(ref.resample_count)
    d = sum(np.abs(g.numpy() - np.asarray(w)).max(-1) for g, w in leaves)[other]
    moved = float(d.sum()) / n
    pose_leaves = ((est.pose.xy, jest.pose.xy), (est.pose.rot.z, jest.pose.rot.z)) if dim == 2 \
        else ((est.pose.xyz, jest.pose.xyz), (est.pose.rot.q, jest.pose.rot.q))
    for got, want in pose_leaves:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4 + moved)
    np.testing.assert_allclose(est.covariance.numpy(), np.asarray(jest.covariance), rtol=2e-3,
                               atol=1e-5 + 2 * float((d * (d + 1.0)).sum()) / n)


@pytest.mark.parametrize("adaptive", [False, True])
def test_one_2d_update_matches_reference(maps, adaptive):
    jm, m, world2d = maps[2]
    n = 300
    kw = dict(max_particles=n, min_particles=n // 4 if adaptive else n, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_ndt_2d(jm)
    models, ctx = make_ndt_filter_2d(m)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(1))
    jstates = j_sample_normal_se2(k_init, n, JSE2.from_xytheta(*TRUTH),
                                  jnp.diag(jnp.asarray([0.05, 0.05, 0.02])))
    jstate = j_amcl.init_state(k_state, jstates, jparams)
    pts = cloud(world2d, 2, 3)
    mask = np.ones(len(pts), bool)
    jstep = jax.jit(lambda s, o, p, k: j_amcl.update(jparams, jmodels, jctx, s, o, p, k))
    for odom in ((7.0, 9.0, 0.3), (7.3, 9.1, 0.35)):  # the forced first update, then a move
        state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
        draws = draws_of(reference_draws(jstate.key, n), state.particles.state)
        jstate, jest = jstep(jstate, JSE2.from_xytheta(*odom), jnp.asarray(pts),
                             jnp.asarray(mask))
        state, est = amcl.update(params, models, ctx, state, amcl.host_pose(*odom), t(pts),
                                 t(mask), draws=draws)
        ref = jax.device_get(jstate)
        assert est.valid and bool(jest.valid)
        compare(state, est, ref, jest, n, 2)
        jstate = ref


def test_one_3d_update_matches_reference(maps):
    jm, m, world2d = maps[3]
    n = 200
    kw = dict(max_particles=n, min_particles=n // 4, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_ndt_3d(jm)
    models, ctx = make_ndt_filter_3d(m)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(2))
    mean = JSE3(jnp.asarray([TRUTH[0], TRUTH[1], 0.0], jnp.float32),
                JSO3.from_rpy(jnp.float32(0), jnp.float32(0), jnp.float32(TRUTH[2])))
    cov = jnp.diag(jnp.asarray([0.05, 0.05, 0.01, 0.002, 0.002, 0.02]))
    jstate = j_amcl.init_state(k_state, j_sample_normal_se3(k_init, n, mean, cov), jparams,
                               odom_identity=JSE3.identity())
    pts = cloud(world2d, 3, 4, n=120)
    mask = np.ones(len(pts), bool)
    jstep = jax.jit(lambda s, o, p, k: j_amcl.update(jparams, jmodels, jctx, s, o, p, k))
    for xyz, yaw in (((0.0, 0.0, 0.0), 0.0), ((0.3, 0.0, 0.0), 0.05)):
        jodom = JSE3(jnp.asarray(xyz, jnp.float32), JSO3.from_rpy(
            jnp.float32(0), jnp.float32(0), jnp.float32(yaw)))
        state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
        assert isinstance(state.control_prev, SE3)
        draws = draws_of(reference_draws(jstate.key, n), state.particles.state)
        jstate, jest = jstep(jstate, jodom, jnp.asarray(pts), jnp.asarray(mask))
        state, est = amcl.update(params, models, ctx, state, convert.se3(jax.device_get(jodom)),
                                 t(pts), t(mask), draws=draws)
        ref = jax.device_get(jstate)
        assert est.valid and bool(jest.valid)
        assert est.covariance.shape == (6, 6)
        compare(state, est, ref, jest, n, 3)
        jstate = ref


def test_small_fleet_update_matches_reference_vmap(maps):
    """Three filters of 256 particles, a fixed count, each from its own
    cloud, against ``jax.vmap`` of the reference's update (the particle
    chunks of a fleet: ``test_torch_ndt.py``)."""
    jm, m, world2d = maps[2]
    b, n = 3, 256
    kw = dict(max_particles=n, min_particles=n, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_ndt_2d(jm)
    models, ctx = make_ndt_filter_2d(m)

    def one(key):
        k1, k2 = jax.random.split(key)
        st = j_sample_normal_se2(k1, n, JSE2.from_xytheta(*TRUTH),
                                 jnp.diag(jnp.asarray([0.05, 0.05, 0.02])))
        return j_amcl.init_state(k2, st, jparams)

    jstate = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(5), b))
    pts = np.stack([cloud(world2d, 2, 10 + i) for i in range(b)])
    mask = np.ones(pts.shape[:2], bool)
    odom = np.broadcast_to(TRUTH, (b, 3)).astype(np.float32)
    jodom = JSE2.from_xytheta(jnp.asarray(odom))
    state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
    draws = draws_of(jax.vmap(lambda k: reference_draws(k, n))(jstate.key),
                     state.particles.state)
    jstep = jax.jit(jax.vmap(functools.partial(j_amcl.update, jparams, jmodels),
                             in_axes=(None, 0, 0, 0, 0)))
    jstate, jest = jstep(jctx, jstate, jodom, jnp.asarray(pts), jnp.asarray(mask))
    state, est = amcl.update(params, models, ctx, state,
                             SE2.from_xytheta(t(odom), device="cpu"), t(pts), t(mask),
                             draws=draws)
    ref = jax.device_get(jstate)
    assert np.all(est.valid) and np.all(np.asarray(jest.valid))
    for i in range(b):
        def take(tree, i=i):
            return tree_map(lambda leaf: leaf[i], tree)

        one_state = state._replace(particles=take(state.particles),
                                   resample_count=int(state.resample_count[i]))
        one_est = amcl.Estimate(take(est.pose), est.covariance[i], True)
        pick = functools.partial(jax.tree_util.tree_map, lambda a, i=i: np.asarray(a)[i])
        compare(one_state, one_est, pick(ref), pick(jest), n, 2)


@pytest.mark.parametrize("dim", [2, 3])
def test_recovery_matches_reference_draws(maps, dim):
    """The estimate-based recovery (ndt_builders.py:63-68, :98-100) fed the
    reference's normals: ``sample_normal_se{2,3}(key, n, mean, cov +
    1e-6·I)`` of the reference's estimate."""
    rng = np.random.default_rng(6)
    n = 400
    if dim == 2:
        xyt = (TRUTH + rng.normal(0, [0.2, 0.3, 0.1], (n, 3))).astype(np.float32)
        jst = JSE2.from_xytheta(jnp.asarray(xyt))
        jmodels, _ = j_make_ndt_2d(maps[2][0])
    else:
        xyz = (np.r_[TRUTH[:2], 0.0] + rng.normal(0, [0.2, 0.3, 0.05], (n, 3))).astype(np.float32)
        rpy = rng.normal(0, [0.02, 0.03, 0.1], (n, 3)).astype(np.float32)
        jst = JSE3(jnp.asarray(xyz), JSO3.from_rpy(*(jnp.asarray(rpy[:, i]) for i in range(3))))
        jmodels, _ = j_make_ndt_3d(maps[3][0])
    jparts = j_make_from_states(jst)
    jparts = jparts.replace(log_weight=jnp.asarray(rng.normal(0, 0.5, n), jnp.float32))
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda k, p: jmodels.random_state(None, k, 500, p))(key, jparts)
    parts = convert.particles(jax.device_get(jparts))
    # the reference's covariance, for the eigenvector signs of its square root
    est = j_amcl.default_estimate if dim == 2 else jmodels.estimate
    _, jcov = est(None, jparts)
    k = 3 if dim == 2 else 6
    cov = np.asarray(jcov) + 1e-6 * np.eye(k, dtype=np.float32)
    _, vj = jnp.linalg.eigh(jnp.asarray(cov))
    _, vt = torch.linalg.eigh(t(cov))
    signs = np.sign(np.sum(np.asarray(vj) * vt.numpy(), axis=0)).astype(np.float32)
    z = np.asarray(jax.random.normal(key, (500, k), jnp.float32)) * signs
    core = recovery_se2_from_draws if dim == 2 else recovery_se3_from_draws
    got = core(t(z), parts)
    for g, w in ((got.xy, want.xy), (got.rot.z, want.rot.z)) if dim == 2 else (
            (got.xyz, want.xyz), (got.rot.q, want.rot.q)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# -- nodes --------------------------------------------------------------------


def test_2d_node_full_cycle_and_point_shapes(maps):
    """test_ndt_node.py:24-38 on the arena map: a valid first update, a
    gated one, a forced one; points not ``[P, 2]`` raise."""
    _, m, world2d = maps[2]
    cfg = AmclNodeConfig(max_particles=200, min_particles=50, set_initial_pose=True,
                         initial_pose_x=float(TRUTH[0]), initial_pose_y=float(TRUTH[1]),
                         initial_pose_yaw=float(TRUTH[2]))
    node = NdtAmclNode(cfg, device="cpu")
    node.set_map(m)
    pts = cloud(world2d, 2, 8)
    res = node.handle_point_cloud(tuple(TRUTH), pts)
    assert res.valid and np.isfinite(res.pose).all()
    assert np.hypot(res.pose[0] - TRUTH[0], res.pose[1] - TRUTH[1]) < 0.9
    assert not node.handle_point_cloud((TRUTH[0] + 0.01, TRUTH[1], TRUTH[2]), pts).valid
    node.request_nomotion_update()
    assert node.handle_point_cloud((TRUTH[0] + 0.01, TRUTH[1], TRUTH[2]), pts).valid
    with pytest.raises(ValueError, match=r"\[P, 2\]"):
        node.handle_point_cloud(tuple(TRUTH), np.zeros((10, 3), np.float32))
    with pytest.raises(ValueError, match="expected a 2D"):
        node.set_map(maps[3][1])


def test_3d_node_cycle_retention_and_gating(maps):
    """test_ndt_node.py:41-80 on the 3D arena map: the 6-vector estimate,
    clouds dropped while inactive, the estimate kept across cleanup and
    re-initialized from on the next map; points not ``[P, 3]`` raise."""
    _, m, world2d = maps[3]
    cfg = AmclNodeConfig(max_particles=150, min_particles=40)
    node = NdtAmclNode3D(cfg, device="cpu")
    node.set_map(m)
    node.set_initial_pose((TRUTH[0], TRUTH[1], 0.0), (0.0, 0.0, TRUTH[2]),
                          np.diag([0.05, 0.05, 0.01, 0.001, 0.001, 0.02]))
    pts = cloud(world2d, 3, 9, n=120)
    res = node.handle_point_cloud((0, 0, 0, 0, 0, 0), pts)
    assert res.valid and res.pose.shape == (6,) and res.covariance.shape == (6, 6)
    with pytest.raises(ValueError, match=r"\[P, 3\]"):
        node.handle_point_cloud((0, 0, 0, 0, 0, 0), pts[:, :2])
    node.deactivate()
    assert not node.handle_point_cloud((0, 0, 0, 0, 0, 0), pts).valid
    est_before = node.last_known_estimate[0].copy()
    node.cleanup()
    assert node._state is None
    node.configure()
    node.activate()
    node.set_map(m)  # re-initialized from the retained estimate
    xyz = node._state.particles.state.xyz.numpy()
    assert np.isfinite(xyz).all()
    assert abs(np.mean(xyz[:, 0]) - est_before[0]) < 1.0
    assert abs(np.mean(xyz[:, 1]) - est_before[1]) < 1.0
    assert pack_cloud_input((0,) * 6, pts).shape == (6 + 4 * len(pts),)


# -- tools --------------------------------------------------------------------


def test_tools_match_reference_and_round_trip_hdf5(tmp_path, maps):
    """``fit_ndt_cells`` and ``grid_to_points`` equal the reference's, and a
    map written by either package loads in both."""
    pytest.importorskip("h5py")
    data = synthetic.tracking_arena(384, 0.05)
    pts = tools.grid_to_points(data, 0.05, origin=(1.0, -2.0))
    np.testing.assert_array_equal(pts, j_tools.grid_to_points(data, 0.05, origin=(1.0, -2.0)))
    for got, want in zip(tools.fit_ndt_cells(pts, 0.4), j_tools.fit_ndt_cells(pts, 0.4)):
        np.testing.assert_array_equal(got, want)
    cells, means, covs = tools.fit_ndt_cells(pts, 0.4)
    ours, theirs = tmp_path / "port.hdf5", tmp_path / "ref.hdf5"
    tools.save_ndt_hdf5(ours, cells, means, covs, 0.4)
    j_tools.save_ndt_hdf5(theirs, cells, means, covs, 0.4)
    for path in (ours, theirs):
        m = load_ndt_hdf5(str(path), device="cpu")
        jm = j_load_ndt_hdf5(str(path))
        assert m.num_cells == int(jm.num_cells) == len(cells)
        np.testing.assert_array_equal(m.keys.numpy(), np.asarray(jm.keys).astype(np.int64))
        np.testing.assert_array_equal(m.covs.numpy(), np.asarray(jm.covs))
    ply = tmp_path / "a.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                   "property float y\nproperty float z\nend_header\n0 1 2\n3.5 -1.25 0.5\n")
    np.testing.assert_array_equal(tools.load_ply_points(ply), j_tools.load_ply_points(ply))

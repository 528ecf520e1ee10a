"""SO3 / SE3 algebra, the SE3 samplers, ``estimate_se3``, the SE3 spatial
hash, the flattened-3D diff-drive and the SE3 on-motion gate of the
PyTorch port, held against the JAX package on the CPU.

Inputs are made with numpy and handed to both packages; the samplers get
the reference's own draws.  Tolerances: the group operations agree within
2e-6 (XLA's and PyTorch's sin, cos, atan2 and asin differ in the last
bits, and XLA may contract products into FMAs); the sampled poses within
1e-5 (the eigendecomposition of the covariance adds its own last bits);
the estimate within 1e-5 and its covariance within rtol 1e-4 (sums in
other orders; ``eigh`` of a 4x4).  The spatial hash is exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu import lie as jlie
from beluga_tpu.algorithms.estimation import estimate_se3 as j_estimate_se3
from beluga_tpu.core.random import sample_normal_se3 as j_sample_normal_se3
from beluga_tpu.core.random import sample_uniform_box_se3 as j_sample_uniform_box_se3
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.models.motion.differential_drive import (
    DifferentialDriveParams as JDiffDriveParams,
)
from beluga_tpu.models.motion.differential_drive import (
    diff_drive_propagate_3d as j_propagate_3d,
)
from beluga_tpu.ops.spatial_hash import spatial_hash_se3 as j_hash_se3
from beluga_tpu_torch import convert
from beluga_tpu_torch.algorithms.estimation import estimate_se3
from beluga_tpu_torch.core.random import (
    normal_se3_from_draws,
    sample_normal_se3,
    uniform_box_se3_from_draws,
)
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.ndt_builders import make_ndt_filter_3d
from beluga_tpu_torch.lie import SE3, SO3, to_2d, to_3d
from beluga_tpu_torch.maps.ndt import make_ndt_map
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_propagate_3d,
)
from beluga_tpu_torch.ops.spatial_hash import spatial_hash_se3

torch.set_num_threads(1)

ATOL = 2e-6


def t(a):
    return torch.as_tensor(np.array(a))


def rotvecs(n, seed, small_every=4):
    """Rotation vectors up to ~3 rad, every ``small_every``-th one below the
    1e-6 small-angle branch."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    w[::small_every] *= 1e-7
    return w


def se3_pair(n, seed):
    """The same random SE3 poses in both packages."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    w = rotvecs(n, seed + 1)
    jpose = jlie.SE3(jnp.asarray(xyz), jlie.SO3.exp(jnp.asarray(w)))
    return jpose, convert.se3(jax.device_get(jpose))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_so3_exp_log_act_matrix():
    w = rotvecs(64, 0)
    jr, r = jlie.SO3.exp(jnp.asarray(w)), SO3.exp(t(w))
    close(r.q, jr.q)
    close(r.log(), jr.log())
    v = np.random.default_rng(1).normal(0, 2, (64, 3)).astype(np.float32)
    close(r.act(t(v)), jr.act(jnp.asarray(v)), 1e-5)
    close(r.as_matrix(), jr.as_matrix())
    close(r.inverse().q, jr.inverse().q)
    other = SO3.exp(t(w[::-1].copy()))
    close((r @ other).q, (jr @ jlie.SO3.exp(jnp.asarray(w[::-1].copy()))).q)
    close(SO3.from_quat_wxyz(t(w @ np.ones((3, 4), np.float32))).q,
          jlie.SO3.from_quat_wxyz(jnp.asarray(w @ np.ones((3, 4), np.float32))).q)


def test_so3_rpy_round_trip():
    rng = np.random.default_rng(2)
    roll, pitch, yaw = (rng.uniform(-1.4, 1.4, 50).astype(np.float32) for _ in range(3))
    jr = jlie.SO3.from_rpy(jnp.asarray(roll), jnp.asarray(pitch), jnp.asarray(yaw))
    r = SO3.from_rpy(t(roll), t(pitch), t(yaw))
    close(r.q, jr.q)
    for got, want in zip(r.rpy(), jr.rpy()):
        close(got, want, 1e-5)
    close(torch.stack(r.rpy(), -1), np.stack([roll, pitch, yaw], -1), 1e-5)


def test_se3_group_operations():
    ja, a = se3_pair(40, 3)
    jb, b = se3_pair(40, 4)
    for got, want in (((a @ b).xyz, (ja @ jb).xyz), ((a @ b).rot.q, (ja @ jb).rot.q),
                      (a.inverse().xyz, ja.inverse().xyz), (a.log(), ja.log())):
        close(got, want, 1e-5)
    tangent = np.concatenate([np.random.default_rng(5).normal(0, 1, (40, 3)),
                              rotvecs(40, 6)], 1).astype(np.float32)
    je, e = jlie.SE3.exp(jnp.asarray(tangent)), SE3.exp(t(tangent))
    close(e.xyz, je.xyz, 1e-5)
    close(e.rot.q, je.rot.q)
    close(e.log(), je.log(), 1e-5)


def test_to_3d_and_to_2d():
    rng = np.random.default_rng(7)
    x, y, th = (rng.uniform(-3, 3, 30).astype(np.float32) for _ in range(3))
    jp = jlie.to_3d(jlie.SE2.from_xytheta(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th)))
    p = to_3d(convert.se2(jax.device_get(jlie.SE2.from_xytheta(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(th)))))
    close(p.xyz, jp.xyz)
    close(p.rot.q, jp.rot.q)
    ja, a = se3_pair(30, 8)
    close(to_2d(a).xy, jlie.to_2d(ja).xy)
    close(to_2d(a).rot.z, jlie.to_2d(ja).rot.z, 1e-5)


def eigenvector_signs(cov):
    """±1 per eigenvector column: the LAPACK builds under XLA and PyTorch
    pick opposite signs for some eigenvectors of the same matrix, so the
    square roots ``V·sqrt(Λ)`` of the covariance differ by column signs.
    Feeding the port the reference's normals times these signs gives the
    reference's samples; the flips leave the distribution unchanged."""
    _, vj = jnp.linalg.eigh(jnp.asarray(cov, jnp.float32))
    _, vt = torch.linalg.eigh(torch.as_tensor(np.asarray(cov, np.float32)))
    return np.sign(np.sum(np.asarray(vj) * vt.numpy(), axis=0)).astype(np.float32)


def test_sample_normal_se3_from_reference_draws():
    """The reference's normals through the port's core, a covariance with
    distinct eigenvalues (so the eigenvectors are unique up to sign)."""
    key = jax.random.PRNGKey(11)
    a = np.random.default_rng(9).normal(0, 0.3, (6, 6))
    cov = (a @ a.T + np.diag(np.arange(1, 7) * 0.05)).astype(np.float32)
    mean = jlie.SE3(jnp.asarray([1.0, -2.0, 0.5]),
                    jlie.SO3.from_rpy(jnp.float32(0.1), jnp.float32(-0.2), jnp.float32(0.7)))
    want = jax.jit(j_sample_normal_se3, static_argnums=1)(key, 300, mean, jnp.asarray(cov))
    z = np.asarray(jax.random.normal(key, (300, 6), jnp.float32)) * eigenvector_signs(cov)
    got = normal_se3_from_draws(t(z), convert.se3(jax.device_get(mean)), cov)
    close(got.xyz, want.xyz, 1e-5)
    close(got.rot.q, want.rot.q, 1e-5)


def test_sample_normal_se3_per_filter_and_statistics():
    """A fleet's draws, each filter about its own mean and covariance, and
    the sample covariance of the port's own draws."""
    gen = torch.Generator().manual_seed(0)
    means = SE3(t(np.array([[0, 0, 0], [5, 5, 1]], np.float32)), SO3.identity((2,)))
    covs = torch.stack([torch.eye(6) * 0.01, torch.eye(6) * 0.04])
    s = sample_normal_se3(gen, 20000, means, covs, lead=(2,))
    assert s.xyz.shape == (2, 20000, 3) and s.rot.q.shape == (2, 20000, 4)
    for b, var in enumerate((0.01, 0.04)):
        close(s.xyz[b].mean(0), means.xyz[b], 0.01)
        np.testing.assert_allclose(s.xyz[b].var(0).numpy(), var, rtol=0.05)
        roll, pitch, yaw = s.rot.rpy()
        np.testing.assert_allclose(yaw[b].var().item(), var, rtol=0.05)


def test_uniform_box_se3_from_reference_draws():
    key = jax.random.PRNGKey(4)
    lo, hi = [-1.0, 0.0, 2.0], [3.0, 1.0, 2.5]
    want = j_sample_uniform_box_se3(key, 200, lo, hi)
    k_xyz, k_rot = jax.random.split(key)
    got = uniform_box_se3_from_draws(t(jax.random.uniform(k_xyz, (200, 3), jnp.float32)),
                                     t(jax.random.normal(k_rot, (200, 4), jnp.float32)), lo, hi)
    close(got.xyz, want.xyz, 1e-6)
    close(got.rot.q, want.rot.q, 1e-6)


@jax.jit
def reference_estimate(xyz, w, weights, mask):
    return j_estimate_se3(jlie.SE3(xyz, jlie.SO3.exp(w)), weights, mask)


@pytest.mark.parametrize("masked", [False, True])
def test_estimate_se3(masked):
    """One filter and a fleet of three against the reference per filter.
    A cloud about one rotation: the largest eigenvalue of Σ w q qᵀ is
    simple, so the mean is unique after the w >= 0 flip."""
    rng = np.random.default_rng(12)
    b, n = 3, 400
    xyz = rng.normal([1, 2, 0.3], 0.4, (b, n, 3)).astype(np.float32)
    w = (rng.normal([0, 0, 2.5], 0.2, (b, n, 3))).astype(np.float32)  # near ±π about z
    weights = rng.uniform(0.1, 1.0, (b, n)).astype(np.float32)
    mask = np.arange(n) < (300 if masked else n)
    mask = np.broadcast_to(mask, (b, n))
    states = SE3(t(xyz), SO3.exp(t(w)))
    mean, cov = estimate_se3(states, t(weights), t(mask))
    for i in range(b):
        jmean, jcov = reference_estimate(xyz[i], w[i], weights[i], mask[i])
        close(mean.xyz[i], jmean.xyz, 1e-5)
        close(mean.rot.q[i], jmean.rot.q, 1e-5)
        np.testing.assert_allclose(cov[i].numpy(), np.asarray(jcov), rtol=1e-4, atol=1e-6)
        single_mean, single_cov = estimate_se3(SE3(t(xyz[i]), SO3.exp(t(w[i]))),
                                               t(weights[i]), t(mask[i]))
        close(single_mean.rot.q, mean.rot.q[i], 1e-6)
        np.testing.assert_allclose(single_cov.numpy(), cov[i].numpy(), rtol=1e-5, atol=1e-7)
    assert bool((mean.rot.q[:, 0] >= 0).all())


def test_spatial_hash_se3_exact():
    ja, a = se3_pair(500, 13)
    want = jax.jit(lambda p: j_hash_se3(p.xyz, p.rot.rpy(), 0.5, math.radians(10)))(ja)
    got = spatial_hash_se3(a.xyz, a.rot.rpy(), 0.5, math.radians(10))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("motion", [(0.3, 0.1, 0.4), (0.0, 0.0, 0.0), (-0.2, 0.05, -1.0)])
def test_diff_drive_propagate_3d_from_reference_normals(motion):
    ja, a = se3_pair(256, 14)
    prev = jlie.SE3(jnp.asarray([1.0, 1.0, 0.0]), jlie.SO3.from_rpy(
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.3)))
    dx, dy, dth = motion
    pose = jlie.SE3(jnp.asarray([1.0 + dx, 1.0 + dy, 0.0]), jlie.SO3.from_rpy(
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.3 + dth)))
    key = jax.random.PRNGKey(15)
    want = jax.jit(lambda *a: j_propagate_3d(JDiffDriveParams(), *a))(key, ja, pose, prev)
    z = t(jax.random.normal(key, (3, 256), jnp.float32))
    got = diff_drive_propagate_3d(DifferentialDriveParams(), z, a,
                                  convert.se3(jax.device_get(pose)),
                                  convert.se3(jax.device_get(prev)))
    close(got.xyz, want.xyz, 1e-5)
    close(got.rot.q, want.rot.q, 1e-5)
    assert float(got.xyz[:, 2].abs().max()) == 0.0  # re-embedded at z = 0


def test_se3_motion_delta_matches_reference():
    ja, a = se3_pair(50, 16)
    jb, b = se3_pair(50, 17)
    for got, want in zip(amcl.se3_motion_delta(a, b), j_amcl.se3_motion_delta(ja, jb)):
        close(got, want, 1e-5)


def test_se3_on_motion_gate():
    """The 3D filter's gate (test_ndt_filter.py:99-117): the forced first
    update, then no motion gates out, then half a meter passes; the
    odometry memory holds SE3 poses on the host."""
    rng = np.random.default_rng(18)
    cells = np.unique(rng.integers(-4, 4, (60, 3)), axis=0)
    means = (cells + 0.5) * 0.5
    ndt_map = make_ndt_map(cells, means, np.broadcast_to(np.eye(3) * 0.02, (len(cells), 3, 3)),
                           0.5, device="cpu")
    models, ctx = make_ndt_filter_3d(ndt_map)
    params = amcl.AmclParams(max_particles=100, min_particles=25)
    gen = torch.Generator().manual_seed(7)
    states = sample_normal_se3(gen, 100, SE3.identity(), np.eye(6) * 0.05)
    state = amcl.init_state(gen, states, params, device="cpu", odom_identity=SE3.identity())
    assert isinstance(state.motion_latest, SE3)
    pts = t(means[rng.integers(0, len(means), 40)].astype(np.float32))
    mask = torch.ones(40, dtype=torch.bool)
    state, est = amcl.update(params, models, ctx, state, SE3.identity(), pts, mask)
    assert est.valid and est.covariance.shape == (6, 6)
    state, est = amcl.update(params, models, ctx, state, SE3.identity(), pts, mask)
    assert not est.valid
    moved = SE3(torch.tensor([0.5, 0.0, 0.0]), SO3.identity())
    state, est = amcl.update(params, models, ctx, state, moved, pts, mask)
    assert est.valid
    turned = SE3.from_xyzrpy([0.5, 0.0, 0.0], (0.0, 0.0, 0.25))  # 0.25 rad > update_min_a
    _, est = amcl.update(params, models, ctx, state, turned, pts, mask)
    assert est.valid

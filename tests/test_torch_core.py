"""SE2 algebra, particles and weights, samplers, diff-drive motion,
resampling positions, Thrun recovery, spatial hash and KLD, and the
estimators of the PyTorch port, held against the JAX package on the CPU.

Inputs and the reference's own random draws are handed to both packages.
Tolerances: integer results (hashes, bucket counts, KLD counts, cluster
roots through the estimate's cell choice, interleave orders) and pure
copies are exact; float results agree within 1e-5 absolute, for
transcendental functions (sin, cos, atan2, exp, log) that differ in the
last bits between XLA's and PyTorch's CPU implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.algorithms import cluster as j_cluster
from beluga_tpu.algorithms import estimation as j_est
from beluga_tpu.algorithms import kld as j_kld
from beluga_tpu.algorithms import thrun as j_thrun
from beluga_tpu.core import particles as j_particles
from beluga_tpu.core import random as j_random
from beluga_tpu.core import weights as j_weights
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.models.motion import differential_drive as j_dd
from beluga_tpu.ops import resample as j_resample
from beluga_tpu.ops import spatial_hash as j_hash
from beluga_tpu_torch import convert
from beluga_tpu_torch.algorithms.cluster import cluster_based_estimate
from beluga_tpu_torch.algorithms.estimation import estimate_se2
from beluga_tpu_torch.algorithms.kld import (
    distinct_prefix_count,
    kld_active_count,
    kld_target_size,
)
from beluga_tpu_torch.algorithms.thrun import ThrunState, thrun_update
from beluga_tpu_torch.core.particles import (
    DEAD_LOG_WEIGHT,
    ParticleSet,
    make_from_states,
    tree_scatter,
    tree_take,
    tree_where,
)
from beluga_tpu_torch.core.random import (
    normal_se2_from_draws,
    sample_normal_se2,
    sample_uniform_free_cells,
    uniform_free_cells_from_draws,
)
from beluga_tpu_torch.core.weights import effective_sample_size, normalize, normalized_weights
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_decompose,
    diff_drive_propagate,
)
from beluga_tpu_torch.ops.resample import (
    interleave_ranks,
    interleave_slots,
    sorted_multinomial_from_uniform,
    stratified_from_uniform,
    systematic_from_uniform,
)
from beluga_tpu_torch.ops.spatial_hash import spatial_hash_se2

torch.set_num_threads(1)

ATOL = 1e-5


def poses(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-spread, spread, n).astype(np.float32),
            rng.uniform(-spread, spread, n).astype(np.float32),
            rng.uniform(-3.1, 3.1, n).astype(np.float32))


def pair(x, y, th):
    return (JSE2.from_xytheta(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th)),
            SE2.from_xytheta(x, y, th))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def close_se2(got: SE2, want):
    close(got.xy, want.xy)
    close(got.rot.z, want.rot.z)


# -- SE2 algebra --------------------------------------------------------------


def test_se2_compose_inverse_act():
    ja, a = pair(*poses(64, 0))
    jb, b = pair(*poses(64, 1))
    close_se2(a @ b, ja @ jb)
    close_se2(a.inverse(), ja.inverse())
    close_se2(a.inverse() @ a, JSE2.identity((64,)))
    p = np.random.default_rng(2).normal(size=(64, 2)).astype(np.float32)
    close(a.act(torch.as_tensor(p)), ja.act(jnp.asarray(p)))
    close(a.theta, ja.theta)
    close(a.as_xytheta(), ja.as_xytheta())


@pytest.mark.parametrize("scale", [1.0, 1e-6])  # the small-angle branch too
def test_se2_exp_log(scale):
    rng = np.random.default_rng(3)
    tangent = (rng.normal(size=(50, 3)) * [1.0, 1.0, scale]).astype(np.float32)
    got, want = SE2.exp(torch.as_tensor(tangent)), JSE2.exp(jnp.asarray(tangent))
    close_se2(got, want)
    close(got.log(), want.log())
    close(got.log(), tangent, atol=2e-5)


def test_se2_from_xytheta_identity():
    got = SE2.from_xytheta(torch.tensor([[1.0, 2.0, 0.5]]))
    want = JSE2.from_xytheta(jnp.asarray([[1.0, 2.0, 0.5]]))
    close_se2(got, want)
    ident = SE2.identity((3,))
    assert torch.equal(ident.rot.z, torch.tensor([[1.0, 0.0]] * 3))
    assert ident.shape == (3,)


# -- particles and weights -----------------------------------------------------


@pytest.mark.parametrize("active", [10, 6, 1])
def test_normalize_and_ess(active):
    rng = np.random.default_rng(active)
    log_w = rng.normal(scale=3.0, size=10).astype(np.float32)
    jp = j_particles.make_from_states(jnp.arange(10.0), active=active)
    jp = jp.replace(log_weight=jnp.where(jp.mask, jnp.asarray(log_w), DEAD_LOG_WEIGHT))
    p = make_from_states(torch.arange(10.0), active=active)
    assert torch.equal(p.mask, torch.as_tensor(np.asarray(jp.mask)))
    p = p.replace(log_weight=torch.where(p.mask, torch.as_tensor(log_w), DEAD_LOG_WEIGHT))
    close(normalize(p).log_weight, j_weights.normalize(jp).log_weight)
    close(normalized_weights(p), j_weights.normalized_weights(jp))
    close(effective_sample_size(p), j_weights.effective_sample_size(jp), atol=1e-4)
    if active < 10:  # dead slots keep the dead log-weight
        assert float(normalize(p).log_weight[-1]) == float(np.float32(DEAD_LOG_WEIGHT))


def test_tree_helpers():
    s = SE2.from_xytheta(torch.arange(5.0), torch.zeros(5), torch.zeros(5))
    idx = torch.tensor([4, 0, 0])
    assert tree_take(s, idx).x.tolist() == [4.0, 0.0, 0.0]
    upd = SE2.from_xytheta(torch.tensor([9.0, 8.0]), torch.zeros(2), torch.zeros(2))
    out = tree_scatter(s, torch.tensor([1, 5]), upd)  # index 5 is dropped
    assert out.x.tolist() == [0.0, 9.0, 2.0, 3.0, 4.0]
    mixed = tree_where(torch.tensor([True, False, True, False, True]), s, out)
    assert mixed.x.tolist() == [0.0, 9.0, 2.0, 3.0, 4.0]
    p = ParticleSet(s, torch.zeros(5), torch.tensor(3, dtype=torch.int32))
    assert p.weight.tolist() == [1.0, 1.0, 1.0, 0.0, 0.0] and p.capacity == 5


# -- samplers, from the reference's draws --------------------------------------


def test_sample_normal_se2_from_reference_draws():
    key = jax.random.PRNGKey(4)
    cov = np.array([[0.25, 0.05, 0.0], [0.05, 0.3, 0.01], [0.0, 0.01, 0.068]], np.float32)
    mean_j = JSE2.from_xytheta(1.5, -2.0, 0.7)
    want = j_random.sample_normal_se2(key, 500, mean_j, jnp.asarray(cov))
    z = torch.as_tensor(np.asarray(jax.random.normal(key, (500, 3), jnp.float32)))
    got = normal_se2_from_draws(z, SE2.from_xytheta(1.5, -2.0, 0.7), cov)
    close_se2(got, want)
    # the generator wrapper draws the same distribution
    gen = torch.Generator().manual_seed(0)
    s = sample_normal_se2(gen, 20000, SE2.from_xytheta(1.5, -2.0, 0.7), cov)
    assert abs(float(s.x.mean()) - 1.5) < 0.02
    assert abs(float(s.xy.T.cov()[0, 1]) - 0.05) < 0.01


def test_sample_uniform_free_cells_from_reference_draws():
    from beluga_tpu.maps.occupancy import make_grid as j_make_grid

    data = np.full((30, 40), 100, np.int8)
    data[5:20, 3:30] = 0
    jgrid = jax.device_get(j_make_grid(data, 0.1, (0.5, -0.5, 0.3)))
    grid = convert.grid(jgrid)
    key = jax.random.PRNGKey(8)
    want = j_random.sample_uniform_free_cells(key, 300, jnp.asarray(jgrid.free_xy),
                                              jnp.asarray(jgrid.num_free))
    k_idx, k_th = jax.random.split(key)
    cells = jax.random.randint(k_idx, (300,), 0, max(int(jgrid.num_free), 1))
    theta = jax.random.uniform(k_th, (300,), jnp.float32, -jnp.pi, jnp.pi)
    got = uniform_free_cells_from_draws(torch.as_tensor(np.asarray(cells)).long(),
                                        torch.as_tensor(np.asarray(theta)), grid.free_xy)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    close(got.rot.z, want.rot.z)
    s = sample_uniform_free_cells(torch.Generator().manual_seed(1), 5000, grid.free_xy,
                                  grid.num_free)
    free = {tuple(r) for r in grid.free_xy[: grid.num_free].tolist()}
    assert all(tuple(r) in free for r in s.xy.tolist()[:200])
    assert float(s.theta.min()) < -3.0 and float(s.theta.max()) > 3.0


# -- differential drive ---------------------------------------------------------

DD = dict(rotation_noise_from_rotation=0.1, rotation_noise_from_translation=0.05,
          translation_noise_from_translation=0.1, translation_noise_from_rotation=0.05)


@pytest.mark.parametrize("motion", [(0.3, 0.1, 0.2), (0.005, 0.0, 0.4), (-0.2, 0.05, -3.0)])
def test_diff_drive_decompose_and_propagate(motion):
    prev = (1.0, 2.0, 0.3)
    pose = (prev[0] + motion[0], prev[1] + motion[1], prev[2] + motion[2])
    jparams, params = j_dd.DifferentialDriveParams(**DD), DifferentialDriveParams(**DD)
    jpose, jprev = JSE2.from_xytheta(*pose), JSE2.from_xytheta(*prev)
    tpose, tprev = SE2.from_xytheta(*pose), SE2.from_xytheta(*prev)
    for got, want in zip(diff_drive_decompose(params, tpose, tprev),
                         j_dd.diff_drive_decompose(jparams, jpose, jprev)):
        close(got[0], want[0])
        close(got[1], want[1])
    jstates, states = pair(*poses(300, 5))
    key = jax.random.PRNGKey(9)
    want = j_dd.diff_drive_propagate(jparams, key, jstates, jpose, jprev)
    z = torch.as_tensor(np.asarray(jax.random.normal(key, (3, 300), jnp.float32)))
    got = diff_drive_propagate(params, z, states, tpose, tprev)
    close_se2(got, want)


# -- resampling positions and the slot interleave ------------------------------


def test_positions_from_reference_uniforms():
    key = jax.random.PRNGKey(10)
    u0 = jax.random.uniform(key, (), jnp.float32)
    np.testing.assert_array_equal(
        systematic_from_uniform(torch.tensor(float(u0)), 1000).numpy(),
        np.asarray(j_resample.systematic_positions(key, 1000)))
    u = jax.random.uniform(key, (777,), jnp.float32)
    np.testing.assert_array_equal(
        stratified_from_uniform(torch.as_tensor(np.asarray(u))).numpy(),
        np.asarray(j_resample.stratified_positions(key, 777)))
    u = jax.random.uniform(key, (1001,), jnp.float32)
    got = sorted_multinomial_from_uniform(torch.as_tensor(np.asarray(u))).numpy()
    want = np.asarray(j_resample.sorted_multinomial_positions(key, 1000))
    # the cumsums add in other orders: a few ulp, always sorted, below 1
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    assert (np.diff(got) >= 0).all() and got.max() < 1.0


@pytest.mark.parametrize("m", [1, 4, 7, 12, 500, 2000, 2003, 65536])
def test_interleave_matches_reference(m):
    x = np.arange(m * 2, dtype=np.float32).reshape(m, 2)
    np.testing.assert_array_equal(interleave_slots(torch.as_tensor(x)).numpy(),
                                  np.asarray(j_resample.interleave_slots(jnp.asarray(x))))
    k = np.arange(m)
    np.testing.assert_array_equal(interleave_ranks(torch.as_tensor(k), m).numpy(),
                                  np.asarray(j_resample.interleave_ranks(jnp.asarray(k), m)))


# -- Thrun recovery ------------------------------------------------------------------


def test_thrun_sequence():
    js, s = j_thrun.ThrunState.init(), ThrunState.init()
    for avg in (0.002, 0.002, 0.0005, 0.001, 0.004, 0.0001, 0.0001, 0.002):
        js, jp = j_thrun.thrun_update(js, 0.001, 0.1, jnp.float32(avg))
        s, p = thrun_update(s, 0.001, 0.1, torch.tensor(avg, dtype=torch.float32))
        close(p, jp, atol=1e-6)
        close(s.slow.value, js.slow.value, atol=1e-9)
        close(s.fast.value, js.fast.value, atol=1e-9)
        assert bool(s.fast.seeded)


# -- spatial hash and KLD ------------------------------------------------------------


def test_spatial_hash_exact():
    x, y, th = poses(5000, 11, spread=40.0)
    jh = np.asarray(j_hash.spatial_hash_se2(jnp.stack([x, y], -1), jnp.asarray(th), 0.5, 0.17,
                                            res_y=0.4))
    h = spatial_hash_se2(torch.as_tensor(np.stack([x, y], -1)), torch.as_tensor(th), 0.5,
                         0.17, res_y=0.4)
    np.testing.assert_array_equal(h.numpy(), jh.astype(np.int64))


@pytest.mark.parametrize("n,buckets,min_p", [(2000, 40, 500), (2000, 600, 100),
                                             (4096, 3, 10), (300, 250, 50)])
def test_kld_counts_exact(n, buckets, min_p):
    rng = np.random.default_rng(n + buckets)
    hashes = rng.integers(0, buckets, n).astype(np.uint32) * np.uint32(2654435769)
    th = torch.as_tensor(hashes.astype(np.int64))
    np.testing.assert_array_equal(distinct_prefix_count(th).numpy(),
                                  np.asarray(j_kld.distinct_prefix_count(jnp.asarray(hashes))))
    k = np.arange(1, 700, dtype=np.int32)
    np.testing.assert_array_equal(kld_target_size(torch.as_tensor(k), 0.05, 3.0).numpy(),
                                  np.asarray(j_kld.kld_target_size(jnp.asarray(k), 0.05, 3.0)))
    got = kld_active_count(th, min_p, n, 0.05, 3.0)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(j_kld.kld_active_count(jnp.asarray(hashes), min_p, n, 0.05, 3.0))


# -- estimators -------------------------------------------------------------------------


def cloud(n, seed):
    """Two clusters and some strays, with uneven weights and dead slots."""
    rng = np.random.default_rng(seed)
    a = rng.normal([1.0, 1.0, 0.3], [0.1, 0.1, 0.05], (n // 2, 3))
    b = rng.normal([3.0, -1.0, 2.0], [0.15, 0.1, 0.1], (n // 3, 3))
    c = rng.uniform([-5, -5, -3], [5, 5, 3], (n - n // 2 - n // 3, 3))
    xyt = np.concatenate([a, b, c]).astype(np.float32)
    w = rng.gamma(1.0, 1.0, n).astype(np.float32)
    w[: n // 2] *= 3.0
    mask = np.arange(n) < n - n // 10
    return xyt, w, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_se2(seed):
    xyt, w, mask = cloud(600, seed)
    jst, st = pair(xyt[:, 0], xyt[:, 1], xyt[:, 2])
    jm, jc = j_est.estimate_se2(jst, jnp.asarray(w), jnp.asarray(mask))
    m, c = estimate_se2(st, torch.as_tensor(w), torch.as_tensor(mask))
    close_se2(m, jm)
    close(c, jc)
    # all-cancelled headings: yaw 0 with infinite variance
    opposite = SE2.from_xytheta(torch.zeros(2), torch.zeros(2), torch.tensor([0.0, np.pi]))
    m, c = estimate_se2(opposite, torch.ones(2))
    assert float(m.theta) == 0.0 and float(c[2, 2]) == float("inf")


@pytest.mark.parametrize("n,seed", [(600, 0), (2000, 1), (257, 2)])
def test_cluster_based_estimate_dense(n, seed):
    xyt, w, mask = cloud(n, seed)
    jst, st = pair(xyt[:, 0], xyt[:, 1], xyt[:, 2])
    jm, jc = j_cluster.cluster_based_estimate(jst, jnp.asarray(w), jnp.asarray(mask),
                                              method="dense")
    m, c = cluster_based_estimate(st, torch.as_tensor(w), torch.as_tensor(mask))
    close_se2(m, jm)
    close(c, jc, atol=1e-4)


def test_cluster_falls_back_to_plain_estimate():
    """No cell holds two particles: the plain estimate."""
    x = np.arange(6, dtype=np.float32) * 2.0
    st = SE2.from_xytheta(x, np.zeros(6, np.float32), np.zeros(6, np.float32))
    w = torch.arange(1.0, 7.0)
    m, c = cluster_based_estimate(st, w)
    pm, pc = estimate_se2(st, w)
    assert torch.equal(m.xy, pm.xy) and torch.equal(c, pc)
    with pytest.raises(NotImplementedError, match="sparse"):
        cluster_based_estimate(st, w, method="sparse")

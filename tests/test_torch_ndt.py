"""The NDT map, kernel B10's plain version and the NDT sensor model of the
PyTorch port, held against the JAX package on the CPU.

Every map is built in the repository: small random tables, the two-cell
map of the C++ golden values, and the synthetic arena fitted at 0.4 m
(287 rows, above the 256 at which the stencil probe, and so B10, takes
over from the dense cross-evaluation).

Tolerances: keys, lookups and B10's values are exact (B10 copies the
map's float32 values; the reference's interpret-mode kernel rebuilds them
exactly from f32 hi/lo planes).  ``fit_measurement_cells`` puts its slots
in the reference's order and count exactly; its means and covariances
agree within 1e-6 (the segment sums add in another order).  Likelihoods
agree within rtol 2e-6 and particle weights (sums of 60 cells) within rtol
1e-5 (XLA contracts the quadratic forms and the rotations into FMAs and
sums the einsums in its own order; its ``exp`` differs in the last bits);
through the 3x3 library inverse within rtol 1e-5.
The C++ golden values hold at rel 1e-5, as in ``tests/test_ndt.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beluga_tpu.models.sensor.ndt as j_ndt_mod
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.lie import SE3 as JSE3
from beluga_tpu.lie import SO3 as JSO3
from beluga_tpu.maps.ndt import encode_cells as j_encode_cells
from beluga_tpu.maps.ndt import make_ndt_map as j_make_ndt_map
from beluga_tpu.models.sensor.ndt import NdtModelParams as JNdtParams
from beluga_tpu.models.sensor.ndt import fit_measurement_cells as j_fit_cells
from beluga_tpu.ops.pallas_ndt import ndt_probe as j_ndt_probe
from beluga_tpu_torch import convert
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2, SE3, SO3
from beluga_tpu_torch.maps import ndt as ndt_map_mod
from beluga_tpu_torch.maps.ndt import encode_cells, make_ndt_map
from beluga_tpu_torch.models.sensor import ndt as ndt_mod
from beluga_tpu_torch.models.sensor.ndt import (
    KERNEL_2D,
    KERNEL_3D,
    NdtModelParams,
    fit_measurement_cells,
    ndt_likelihood_at,
    ndt_weights_2d,
    ndt_weights_3d,
)
from beluga_tpu_torch.ops import cuda_ndt
from beluga_tpu_torch.ops.cuda_ndt import ndt_probe, ndt_probe_reference
from beluga_tpu_torch.tools.make_ndt_map import fit_ndt_cells, grid_to_points

torch.set_num_threads(1)

DIAG_COV = np.diag([0.5, 0.5]).astype(np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def random_map(d, seed, n=60, span=40, resolution=0.5):
    """Unique random cells about the origin (negative and positive), with
    random means and SPD covariances, in both packages."""
    rng = np.random.default_rng(seed)
    cells = np.unique(rng.integers(-span, span, (n, d)).astype(np.int32), axis=0)
    m = cells.shape[0]
    means = rng.standard_normal((m, d)).astype(np.float32)
    a = rng.standard_normal((m, d, d)).astype(np.float32)
    covs = np.einsum("mab,mcb->mac", a, a) + 0.1 * np.eye(d, dtype=np.float32)
    return (j_make_ndt_map(cells, means, covs, resolution),
            make_ndt_map(cells, means, covs, resolution, device="cpu"), cells)


def arena_ndt(cell=0.4, device="cpu"):
    data = synthetic.tracking_arena(384, 0.05)
    cells, means, covs = fit_ndt_cells(grid_to_points(data, 0.05), cell)
    return (j_make_ndt_map(cells, means, covs, cell),
            make_ndt_map(cells, means, covs, cell, device=device))


@pytest.fixture(scope="module")
def arena():
    return arena_ndt()


@pytest.mark.parametrize("d", [2, 3])
def test_encode_cells_and_table_match_reference(d):
    """Keys on both sides of 2^31 in 2D (x + 32768 in the top bits), the
    uint32 wrap of out-of-range cells, and the sorted table."""
    rng = np.random.default_rng(d)
    lim = 40000 if d == 2 else 600  # past the biased range: the wrap
    cells = rng.integers(-lim, lim, (500, d)).astype(np.int32)
    want = np.asarray(j_encode_cells(jnp.asarray(cells))).astype(np.int64)
    np.testing.assert_array_equal(encode_cells(t(cells)).numpy(), want)
    if d == 2:
        assert (want >= 2**31).any() and (want < 2**31).any()
    jm, m, _ = random_map(d, 10 + d)
    np.testing.assert_array_equal(m.keys.numpy(), np.asarray(jm.keys).astype(np.int64))
    np.testing.assert_array_equal(m.means.numpy(), np.asarray(jm.means))
    np.testing.assert_array_equal(m.covs.numpy(), np.asarray(jm.covs))
    assert m.num_cells == int(jm.num_cells) and m.resolution == float(jm.resolution)
    assert np.all(np.diff(m.keys.numpy()) > 0)


@pytest.mark.parametrize("d", [2, 3])
def test_b10_plain_matches_interpret_kernel_and_gather(d):
    """B10's plain version against the reference's interpret-mode
    ``ndt_probe`` (f32 planes, and the hi/lo planes of
    ``_lookup_gaussians_onehot``) and its gather path, bit for bit: queries
    on both sides of the origin, misses, the 0xFFFFFFFE query padding and a
    0xFFFFFFFF key row past ``num_cells``.  A query of 0xFFFFFFFF itself
    (the 2D cell (32767, 32767)) matches such a row in the reference's
    one-hot probe but not in its gather path, which checks ``idx <
    num_cells``; B10 searches only the live rows, as the gather path."""
    jm, m, cells = random_map(d, 20 + d)
    rng = np.random.default_rng(30 + d)
    q = rng.integers(-42, 42, (9, 7, d)).astype(np.int32)
    q[0, :3] = cells[:3]  # certain hits
    got_m, got_c, got_f = m.lookup_gaussians(t(q))
    om, oc, of = jm._lookup_gaussians_onehot(jnp.asarray(q))
    gm, gc, gf = jm.lookup_gaussians(jnp.asarray(q))
    for want_m, want_c, want_f in ((om, oc, of), (gm, gc, gf)):
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_f.any() and not got_f.all()

    # the raw probe: f32 planes in interpret mode, with query padding and a
    # padding key row
    keys = np.concatenate([np.asarray(jm.keys), [np.uint32(0xFFFFFFFF)]])
    values = np.concatenate([m.values.numpy(), np.full((1, m.values.shape[1]), 7.0,
                                                       np.float32)])
    qk = np.asarray(j_encode_cells(jnp.asarray(q))).reshape(-1)
    qk = np.concatenate([qk, [np.uint32(0xFFFFFFFE), np.uint32(0xFFFFFFFF)]])
    want_v, want_f = j_ndt_probe(jnp.asarray(keys), jnp.asarray(values.T), jnp.asarray(qk),
                                 interpret=True)
    vals, found = ndt_probe_reference(t(keys.astype(np.int64)), t(values), m.num_cells,
                                      t(qk.astype(np.int64)))
    assert not bool(found[-2:].any())  # neither padding nor the key row past num_cells
    assert bool(np.asarray(want_f)[-1])  # the one-hot probe matches that row
    np.testing.assert_array_equal(found.numpy()[:-1], np.asarray(want_f)[:-1])
    np.testing.assert_array_equal(vals.numpy()[:-1], np.asarray(want_v)[:-1])
    # the CPU wrapper is the plain version
    same = ndt_probe(t(keys.astype(np.int64)), t(values), m.num_cells, t(qk.astype(np.int64)))
    assert torch.equal(same[0], vals) and torch.equal(same[1], found)


def test_lookup_matches_reference():
    jm, m, _ = random_map(2, 40)
    q = np.random.default_rng(41).integers(-42, 42, (100, 2)).astype(np.int32)
    idx, found = m.lookup(t(q))
    jidx, jfound = jm.lookup(jnp.asarray(q))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    empty = make_ndt_map(np.zeros((0, 2)), np.zeros((0, 2)), np.zeros((0, 2, 2)), 0.5,
                         device="cpu")
    assert not bool(empty.lookup_gaussians(t(q))[2].any())


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_fit_measurement_cells_matches_reference(d, masked):
    """Slots in the reference's order (ascending keys, masked points in the
    fill slot, padding after), truncation toward zero about the origin."""
    rng = np.random.default_rng(50 + d)
    centers = rng.uniform(-1.5, 1.5, (8, d))
    pts = (centers[rng.integers(0, 8, 60)] + rng.normal(0, 0.05, (60, d))).astype(np.float32)
    mask = rng.uniform(size=60) > (0.25 if masked else -1.0)
    jmeans, jcovs, jcm = jax.jit(j_fit_cells)(jnp.asarray(pts), jnp.asarray(mask),
                                              jnp.float32(0.5))
    means, covs, cm = fit_measurement_cells(t(pts), t(mask), 0.5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert cm.sum() >= 3
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=0, atol=1e-6)
    np.testing.assert_allclose(covs.numpy(), np.asarray(jcovs), rtol=0, atol=1e-6)
    # batched: each filter's cloud alone
    both = fit_measurement_cells(t(np.stack([pts, pts[::-1].copy()])),
                                 t(np.stack([mask, mask[::-1].copy()])), 0.5)
    np.testing.assert_array_equal(both[2][0].numpy(), cm.numpy())
    np.testing.assert_allclose(both[0][0].numpy(), means.numpy(), atol=1e-6)
    single_rev = fit_measurement_cells(t(pts[::-1].copy()), t(mask[::-1].copy()), 0.5)
    np.testing.assert_allclose(both[1][1].numpy(), single_rev[1].numpy(), atol=1e-6)


def test_fit_points_reference_cases():
    """tests/test_ndt.py:88-115 on the port: mean, variance floor and
    direction, and too few points."""
    means, covs, cm = fit_measurement_cells(t(np.array([[0.1, 0.2]] * 6, np.float32)),
                                            torch.ones(6, dtype=torch.bool), 0.5)
    i = int(torch.argmax(cm.to(torch.int32)))
    np.testing.assert_allclose(means[i].numpy(), [0.1, 0.2], atol=1e-6)
    assert float(covs[i, 0, 0]) >= 1e-5 * (1 - 1e-4)
    pts = np.array([[0.1, 0.2], [0.1, 0.9], [0.1, 0.2], [0.1, 0.9], [0.1, 0.2], [0.1, 0.2]],
                   np.float32)
    means, covs, cm = fit_measurement_cells(t(pts), torch.ones(6, dtype=torch.bool), 1.0)
    i = int(torch.argmax(cm.to(torch.int32)))
    np.testing.assert_allclose(means[i].numpy(), [0.1, 0.433333], atol=1e-5)
    assert float(covs[i, 1, 1]) > float(covs[i, 0, 0])
    few = t(np.array([[0.1, 0.2], [0.112, 0.22], [0.15, 0.23]], np.float32))
    assert not bool(fit_measurement_cells(few, torch.ones(3, dtype=torch.bool), 0.5)[2].any())


def two_cell_map():
    """The map of test_ndt_model.cpp's Likelihoood test."""
    return make_ndt_map([[0, 0], [1, 1]], [[0.5, 0.5], [1.5, 1.5]],
                        [[[0.5, 0.0], [0.0, 0.3]], [[0.5, 0.0], [0.0, 0.5]]], 1.0, device="cpu")


@pytest.mark.parametrize("point,expected", [
    ([0.5, 0.5], 1.3678794411714423), ([0.8, 0.5], 1.4307317817730123),
    ([0.5, 0.8], 1.4200370805919718), ([1.5, 1.5], 1.3246524673583497),
    ([1.8, 1.5], 1.1859229670198237), ([1.5, 1.8], 1.1669230426687498),
])
def test_likelihood_cpp_golden(point, expected):
    """test_ndt_model.cpp's golden values (tests/test_ndt.py:71-86), on the
    dense path (two rows) and, with the row limit lowered, the probe."""
    params = NdtModelParams(minimum_likelihood=1e-6)
    m = two_cell_map()
    lik = ndt_likelihood_at(params, m, t(np.array(point, np.float32)), t(DIAG_COV))
    assert float(lik) == pytest.approx(expected, rel=1e-5)
    limit = ndt_mod.DENSE_MAX_CELLS
    try:
        ndt_mod.DENSE_MAX_CELLS = 0
        lik = ndt_likelihood_at(params, m, t(np.array(point, np.float32)), t(DIAG_COV))
    finally:
        ndt_mod.DENSE_MAX_CELLS = limit
    assert float(lik) == pytest.approx(expected, rel=1e-5)


def test_min_likelihood_empty_map():
    m = make_ndt_map(np.zeros((0, 2)), np.zeros((0, 2)), np.zeros((0, 2, 2)), 0.5, device="cpu")
    params = NdtModelParams(minimum_likelihood=1e-6)
    for p in ([0.1, 0.1], [0.5, 0.5], [0.75, 0.75]):
        lik = ndt_likelihood_at(params, m, t(np.array(p, np.float32)), t(DIAG_COV))
        assert float(lik) == pytest.approx(1e-6)


def reference_kernel_likelihood(jm, q_mean, q_cov, kern, dense: bool):
    limit = j_ndt_mod._DENSE_MAX_CELLS
    try:  # the limit is read while the function is traced
        j_ndt_mod._DENSE_MAX_CELLS = 10**9 if dense else 0
        return np.asarray(jax.jit(lambda a, b: j_ndt_mod._kernel_likelihood(
            jm, JNdtParams(), a, b, kern))(jnp.asarray(q_mean), jnp.asarray(q_cov)))
    finally:
        j_ndt_mod._DENSE_MAX_CELLS = limit


@pytest.mark.parametrize("d", [2, 3])
def test_dense_and_probe_paths_agree_and_match_reference(d):
    """tests/test_ndt.py:143-160 on the port, and each path against the
    reference's same path."""
    rng = np.random.default_rng(60 + d)
    cells = np.unique(rng.integers(-6, 6, (40, d)), axis=0)
    means = ((cells + rng.uniform(0.2, 0.8, cells.shape)) * 0.5).astype(np.float32)
    covs = np.broadcast_to(np.eye(d, dtype=np.float32) * 0.02, (len(cells), d, d))
    jm = j_make_ndt_map(cells, means, covs, 0.5)
    m = make_ndt_map(cells, means, covs, 0.5, device="cpu")
    q_mean = rng.uniform(-3, 3, (25, d)).astype(np.float32)
    q_cov = np.broadcast_to(np.eye(d, dtype=np.float32) * 0.01, (25, d, d)).copy()
    kern = KERNEL_2D if d == 2 else KERNEL_3D
    params = NdtModelParams()
    dense = ndt_mod._kernel_likelihood_dense(m, params, t(q_mean), t(q_cov)).numpy()
    limit = ndt_mod.DENSE_MAX_CELLS
    try:
        ndt_mod.DENSE_MAX_CELLS = 0
        probe = ndt_mod._kernel_likelihood(m, params, t(q_mean), t(q_cov), kern).numpy()
    finally:
        ndt_mod.DENSE_MAX_CELLS = limit
    np.testing.assert_allclose(dense, probe, rtol=1e-5, atol=1e-8)
    assert dense.max() > 0.0
    np.testing.assert_allclose(dense, reference_kernel_likelihood(jm, q_mean, q_cov, kern, True),
                               rtol=2e-6, atol=1e-12)
    np.testing.assert_allclose(probe, reference_kernel_likelihood(jm, q_mean, q_cov, kern, False),
                               rtol=1e-5 if d == 3 else 2e-6, atol=1e-12)


def test_dense_3d_singular_covariance_not_max_likelihood():
    """tests/test_ndt.py:232-250: a planar cell and a measurement degenerate
    in the same direction score their in-plane error, not the maximum."""
    params = NdtModelParams()
    m = make_ndt_map([[0, 0, 0]], [[0.25, 0.25, 0.25]], [np.diag([0.04, 0.04, 0.0])], 0.5,
                     device="cpu")
    lik = float(ndt_mod._kernel_likelihood_dense(
        m, params, t(np.array([[0.30, 0.20, 0.25]], np.float32)),
        t(np.array([np.diag([0.01, 0.01, 0.0])], np.float32)))[0])
    assert np.isfinite(lik) and lik < 0.99 * params.d1
    assert abs(lik - np.exp(-0.5 * (0.05**2 + 0.05**2) / 0.05)) < 5e-3


def arena_measurement(d, seed, n=60, z_layers=None):
    """Map means near a pose, as points in the robot frame at (2.4, 9.0,
    0.3): a few live measurement cells."""
    data = synthetic.tracking_arena(384, 0.05)
    pts = grid_to_points(data, 0.05)
    rng = np.random.default_rng(seed)
    truth = np.array([7.0, 9.0, 0.3])
    near = pts[np.linalg.norm(pts - truth[:2], axis=1) < 3.0]
    sel = near[rng.integers(0, len(near), 12)][rng.integers(0, 12, n)]
    c, s = np.cos(truth[2]), np.sin(truth[2])
    local = (sel - truth[:2]) @ np.array([[c, -s], [s, c]])
    local = local + rng.normal(0, 0.01, local.shape)
    if d == 3:
        local = np.concatenate([local, rng.uniform(0.1, 1.9, (n, 1))], 1)
    return local.astype(np.float32), truth


def test_weights_2d_probe_path_match_reference(arena):
    """The arena map (287 rows: the probe path, B10's plain version)."""
    jm, m = arena
    assert m.keys.shape[0] > ndt_mod.DENSE_MAX_CELLS
    pts, truth = arena_measurement(2, 70)
    rng = np.random.default_rng(71)
    xyt = (truth + rng.normal(0, [0.3, 0.3, 0.1], (300, 3))).astype(np.float32)
    means, covs, cm = fit_measurement_cells(t(pts), torch.ones(60, dtype=torch.bool), m.resolution)
    states = SE2.from_xytheta(t(xyt))
    got = ndt_weights_2d(NdtModelParams(minimum_likelihood=1e-6), m, states, means, covs, cm,
                         particle_chunk=128)
    jstates = JSE2.from_xytheta(jnp.asarray(xyt))
    want = jax.jit(lambda s, a, b, c: j_ndt_mod.ndt_weights_2d(
        JNdtParams(minimum_likelihood=1e-6), jm, s, a, b, c, particle_chunk=128))(
        jstates, jnp.asarray(means.numpy()), jnp.asarray(covs.numpy()), jnp.asarray(cm.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert float(got.max()) > 1.5  # live cells match the map


def test_weights_3d_match_reference():
    """The 3D arena map (the arena's walls extruded to 2 m, ~1000 rows:
    the probe path), SE3 states with roll and pitch."""
    data = synthetic.tracking_arena(384, 0.05)
    p2 = grid_to_points(data, 0.05)
    p3 = np.concatenate([np.c_[p2, np.full(len(p2), z)] for z in np.arange(0, 2, 0.1)])
    cells, means3, covs3 = fit_ndt_cells(p3, 0.5)
    jm = j_make_ndt_map(cells, means3, covs3, 0.5)
    m = make_ndt_map(cells, means3, covs3, 0.5, device="cpu")
    assert m.keys.shape[0] > ndt_mod.DENSE_MAX_CELLS
    pts, truth = arena_measurement(3, 72, n=200)
    rng = np.random.default_rng(73)
    xyz = np.c_[truth[:2] + rng.normal(0, 0.3, (64, 2)), rng.normal(0, 0.05, 64)]
    rpy = rng.normal(0, 0.02, (64, 3)) + [0, 0, truth[2]]
    jst = JSE3(jnp.asarray(xyz, jnp.float32), JSO3.from_rpy(*(jnp.asarray(rpy[:, i], jnp.float32)
                                                             for i in range(3))))
    st = convert.se3(jax.device_get(jst))
    means, covs, cm = fit_measurement_cells(t(pts), torch.ones(200, dtype=torch.bool), 0.5)
    got = ndt_weights_3d(NdtModelParams(minimum_likelihood=1e-6), m, st, means, covs, cm)
    want = jax.jit(lambda s, a, b, c: j_ndt_mod.ndt_weights_3d(
        JNdtParams(minimum_likelihood=1e-6), jm, s, a, b, c))(
        jst, jnp.asarray(means.numpy()), jnp.asarray(covs.numpy()), jnp.asarray(cm.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert float(got.max()) > 1.5


def test_weights_prefer_true_pose():
    """tests/test_ndt.py:117-130 and :173-190 on the port."""
    m = two_cell_map()
    params = NdtModelParams(minimum_likelihood=1e-6)
    meas_means = t(np.array([[0.5, 0.5], [1.5, 1.5]], np.float32))
    meas_covs = t(np.array([np.eye(2) * 0.1] * 2, np.float32))
    states = SE2.from_xytheta(t([0.0, 3.0]), t([0.0, 3.0]), t([0.0, 0.0]))
    w = ndt_weights_2d(params, m, states, meas_means, meas_covs, torch.ones(2, dtype=torch.bool))
    assert float(w[0]) > float(w[1])
    assert float(w[1]) == pytest.approx(1.0 + 2e-6, abs=1e-7)
    m3 = make_ndt_map([[0, 0, 0], [1, 1, 1]], [[0.5, 0.5, 0.5], [1.5, 1.5, 1.5]],
                      [np.eye(3) * 0.3] * 2, 1.0, device="cpu")
    states3 = SE3(t(np.array([[0, 0, 0], [5, 5, 5]], np.float32)), SO3.identity((2,)))
    w3 = ndt_weights_3d(params, m3, states3, t(np.array([[0.5] * 3, [1.5] * 3], np.float32)),
                        t(np.array([np.eye(3) * 0.1] * 2, np.float32)),
                        torch.ones(2, dtype=torch.bool))
    assert float(w3[0]) > float(w3[1])


def test_particle_chunks_do_not_change_weights(arena):
    _, m = arena
    pts, truth = arena_measurement(2, 74)
    means, covs, cm = fit_measurement_cells(t(pts), torch.ones(60, dtype=torch.bool), m.resolution)
    xyt = (truth + np.random.default_rng(75).normal(0, 0.3, (2, 100, 3))).astype(np.float32)
    states = SE2.from_xytheta(t(xyt))
    fleet = ndt_weights_2d(NdtModelParams(), m, states, means.expand(2, -1, -1),
                           covs.expand(2, -1, -1, -1), cm.expand(2, -1), particle_chunk=37)
    for b in range(2):
        one = ndt_weights_2d(NdtModelParams(), m, SE2.from_xytheta(t(xyt[b])), means, covs, cm)
        np.testing.assert_array_equal(fleet[b].numpy(), one.numpy())


# -- the fused NDT stencil likelihood's wrapper and plain version -------------


def probe_map(d, seed, rows=300, span=None, res=0.5):
    """A map of ``rows`` (> 256: the probe path) distinct cells about the
    origin, each mean inside its cell, random SPD covariances, in both
    packages."""
    rng = np.random.default_rng(seed)
    span = span or (14 if d == 2 else 6)
    cells = np.unique(rng.integers(-span, span, (3 * rows, d)), axis=0)
    cells = cells[rng.permutation(len(cells))[:rows]].astype(np.int32)
    means = ((cells + rng.uniform(0.2, 0.8, cells.shape)) * res).astype(np.float32)
    a = rng.normal(0, 0.1, (len(cells), d, d))
    covs = (a @ a.transpose(0, 2, 1) + 0.01 * np.eye(d)).astype(np.float32)
    return (j_make_ndt_map(cells, means, covs, res),
            make_ndt_map(cells, means, covs, res, device="cpu"))


def probe_inputs(jm, d, seed, lead=(), n=40, c=24, nan_masked=False):
    """Poses about a random pose, and measurement cells ``[*lead, c]`` made
    from map means seen from it (two thirds live); masked slots carry NaN
    when ``nan_masked``."""
    rng = np.random.default_rng(seed)
    mu = np.asarray(jm.means)[rng.integers(0, int(jm.num_cells), (*lead, c))]
    yaw = rng.uniform(-np.pi, np.pi)
    cz, sz = np.cos(yaw), np.sin(yaw)
    rz = np.array([[cz, -sz], [sz, cz]]) if d == 2 else np.array(
        [[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    origin = rng.uniform(-1.0, 1.0, d)
    local = ((mu - origin) @ rz + rng.normal(0, 0.05, mu.shape)).astype(np.float32)
    a = rng.normal(0, 0.08, (*lead, c, d, d))
    covs = (a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(d)).astype(np.float32)
    cmask = rng.uniform(size=(*lead, c)) < 0.67
    if nan_masked:
        local[~cmask] = np.nan
        covs[~cmask] = np.nan
    xy = origin[:2] + rng.normal(0, 0.15, (*lead, n, 2))
    yaws = yaw + rng.normal(0, 0.05, (*lead, n))
    if d == 2:
        xyt = np.concatenate([xy, yaws[..., None]], -1).astype(np.float32)
        return (xyt, SE2.from_xytheta(t(xyt)), JSE2.from_xytheta(jnp.asarray(xyt)), local,
                covs, cmask)
    xyz = np.concatenate([xy, origin[2] + rng.normal(0, 0.05, (*lead, n, 1))], -1)
    rpy = [rng.normal(0, 0.02, (*lead, n)), rng.normal(0, 0.02, (*lead, n)), yaws]
    jst = JSE3(jnp.asarray(xyz, jnp.float32),
               JSO3.from_rpy(*(jnp.asarray(a, jnp.float32) for a in rpy)))
    return None, convert.se3(jax.device_get(jst)), jst, local, covs, cmask


def reference_weights(d, jm, params, jst, means, covs, cmask, lead, chunk=512):
    """The reference's ``ndt_weights_2d``/``_3d``, mapped over the fleet's
    leading axes."""
    fn = j_ndt_mod.ndt_weights_2d if d == 2 else j_ndt_mod.ndt_weights_3d

    def one(s, a, b, c):
        return fn(JNdtParams(*params), jm, s, a, b, c, particle_chunk=chunk)

    for _ in lead:
        one = jax.vmap(one)
    return np.asarray(jax.jit(one)(jst, jnp.asarray(means), jnp.asarray(covs),
                                   jnp.asarray(cmask)))


PROBE_CASES = {  # d, lead, minimum_likelihood, NaN in masked slots
    "2d": (2, (), 0.0, False),
    "2d-min-nan": (2, (), 1e-3, True),
    "2d-fleet": (2, (3,), 1e-3, True),
    "3d": (3, (), 0.0, False),
    "3d-min-nan": (3, (), 1e-3, True),
    "3d-fleet": (3, (2,), 0.0, True),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_fused_plain_version_matches_reference_probe_path(case):
    """The fused kernel's plain version (through ``ndt_weights_2d``/``_3d``
    on a map of 300 rows) against the reference's probe path within rtol
    1e-5: ``minimum_likelihood`` 0 and positive, masked slots that carry
    NaN (they add nothing), fleet axes.  Both invert the 3x3 total
    covariance by LU here; the kernel's closed form parts from LU only near
    a singular total covariance (see
    ``test_closed_form_parts_from_lu_only_near_singular``)."""
    d, lead, minl, nan = PROBE_CASES[case]
    jm, m = probe_map(d, 80 + d)
    _, st, jst, means, covs, cmask = probe_inputs(jm, d, 81, lead, nan_masked=nan)
    params = (minl, 1.0, 1.0)
    fn = ndt_weights_2d if d == 2 else ndt_weights_3d
    got = fn(NdtModelParams(*params), m, st, t(means), t(covs), t(cmask), particle_chunk=16)
    want = reference_weights(d, jm, params, jst, means, covs, cmask, lead, chunk=16)
    assert got.shape == (*lead, 40) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert float(got.max()) > 1.5  # cells match the map
    if minl:
        assert float(got.min()) >= 1.0 + minl * cmask.sum(-1).min() * (1 - 1e-6)


def test_fused_plain_version_on_an_empty_map():
    """An empty map on the probe path: every live cell scores the minimum
    likelihood, in both packages."""
    empty = (np.zeros((0, 2), np.int32), np.zeros((0, 2), np.float32),
             np.zeros((0, 2, 2), np.float32))
    jm, m = j_make_ndt_map(*empty, 0.5), make_ndt_map(*empty, 0.5, device="cpu")
    _, st, jst, means, covs, cmask = probe_inputs(probe_map(2, 82)[0], 2, 83)
    params = (1e-3, 1.0, 1.0)
    limit, j_limit = ndt_mod.DENSE_MAX_CELLS, j_ndt_mod._DENSE_MAX_CELLS
    try:  # the reference reads its limit while it traces
        ndt_mod.DENSE_MAX_CELLS = j_ndt_mod._DENSE_MAX_CELLS = 0
        got = ndt_weights_2d(NdtModelParams(*params), m, st, t(means), t(covs), t(cmask))
        want = reference_weights(2, jm, params, jst, means, covs, cmask, ())
    finally:
        ndt_mod.DENSE_MAX_CELLS, j_ndt_mod._DENSE_MAX_CELLS = limit, j_limit
    expect = np.float32(1.0) + np.float32(1e-3) * np.float32(cmask.sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.full(40, expect), rtol=1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_fused_plain_version_with_a_stencil_of_its_own(d):
    """A stencil other than the standard one (a cross with a far cell)
    takes the probe path on a map of any size; the reference's stencil
    swapped for it while it traces."""
    kern = np.array([[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1], [2, 0], [0, -2]], np.int32) \
        if d == 2 else np.array([[0, 0, 0], [1, 1, 0], [-1, 0, 1], [0, 2, 0]], np.int32)
    jm, m = probe_map(d, 84 + d, rows=100)  # under 256 rows: still the probe
    _, st, jst, means, covs, cmask = probe_inputs(jm, d, 85)
    params = (1e-4, 1.0, 2.0)
    name = "KERNEL_2D" if d == 2 else "KERNEL_3D"
    standard, limit = getattr(j_ndt_mod, name), j_ndt_mod._DENSE_MAX_CELLS
    try:  # the reference reads both while it traces; its dense path knows only its stencil
        setattr(j_ndt_mod, name, kern)
        j_ndt_mod._DENSE_MAX_CELLS = 0
        want = reference_weights(d, jm, params, jst, means, covs, cmask, ())
    finally:
        setattr(j_ndt_mod, name, standard)
        j_ndt_mod._DENSE_MAX_CELLS = limit
    got = ndt_mod._ndt_weights(NdtModelParams(*params), m, st, t(means), t(covs), t(cmask), 512,
                               kern)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert float(got.max()) > 1.2


@pytest.mark.parametrize("d", [2, 3])
def test_fused_wrapper_on_cpu_is_its_plain_version(d):
    """On CPU tensors the wrapper returns its plain version's weights bit
    for bit, launches nothing, and the model's probe path is the
    wrapper."""
    jm, m = probe_map(d, 86 + d)
    _, st, _, means, covs, cmask = probe_inputs(jm, d, 87, (2,), nan_masked=True)
    rot, trans = ndt_mod.pose_matrices(st)
    kern = ndt_mod.KERNEL_2D if d == 2 else ndt_mod.KERNEL_3D
    args = (m.keys, m.values, m.num_cells, m.resolution, rot, trans, t(means), t(covs),
            t(cmask), kern, 1e-3, 1.0, 1.0, 16)
    before = cuda_ndt.weights_launches, cuda_ndt.launches
    got = cuda_ndt.ndt_weights(*args)
    assert (cuda_ndt.weights_launches, cuda_ndt.launches) == before
    assert torch.equal(got, cuda_ndt.ndt_weights_reference(*args))
    fn = ndt_weights_2d if d == 2 else ndt_weights_3d
    assert torch.equal(got, fn(NdtModelParams(1e-3), m, st, t(means), t(covs), t(cmask),
                               particle_chunk=16))


def test_fused_wrapper_checks_its_inputs():
    _, m = probe_map(2, 88)
    _, st, _, means, covs, cmask = probe_inputs(probe_map(2, 88)[0], 2, 89)
    rot, trans = ndt_mod.pose_matrices(st)
    base = dict(keys=m.keys, values=m.values, num_cells=m.num_cells, resolution=m.resolution,
                rot=rot, trans=trans, meas_means=t(means), meas_covs=t(covs),
                cell_mask=t(cmask), offsets=ndt_mod.KERNEL_2D)
    assert cuda_ndt.ndt_weights(**base).shape == (40,)
    bad = {
        "keys must be int64": dict(keys=m.keys.to(torch.int32)),
        "values must be float32": dict(values=m.values[:, :5]),
        "num_cells": dict(num_cells=m.keys.shape[0] + 1),
        "rot must be": dict(rot=rot.double()),
        "trans must be": dict(trans=trans[:-1]),
        "meas_covs must be": dict(meas_covs=t(covs)[:-1]),
        "cell_mask must be": dict(cell_mask=t(cmask).to(torch.uint8)),
        "does not broadcast": dict(meas_means=t(means).expand(3, -1, -1),
                                   meas_covs=t(covs).expand(3, -1, -1, -1),
                                   cell_mask=t(cmask).expand(3, -1)),
        "offsets must be": dict(offsets=np.zeros((0, 2), np.int32)),
        "is on meta": dict(rot=rot.to("meta")),
    }
    for match, change in bad.items():
        with pytest.raises(ValueError, match=match):
            cuda_ndt.ndt_weights(**{**base, **change})
    with pytest.raises(ValueError, match="offsets must be"):
        cuda_ndt.ndt_weights(**{**base, "offsets": np.zeros((33, 2), np.int32)})


def test_closed_form_parts_from_lu_only_near_singular():
    """The inputs on which the kernel's 3D inverse (the adjugate of
    ``T + 1e-12·I``, as the dense path takes it) and the plain version's
    LU part: a total covariance singular to float32 precision.  A planar
    map cell and a planar measurement, flat along one tilted normal, with
    an in-plane error: at a thickness of 1e-3 the two agree within 1e-5 (as
    they do off the plane); at 1e-8 the total's smallest eigenvalue is
    float32 rounding and they part by more than 1e-4."""
    params = NdtModelParams()
    normal = np.array([0.3, -0.2, 0.93])
    normal /= np.linalg.norm(normal)
    u = np.cross(normal, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    basis = np.stack([u, np.cross(normal, u), normal], 1)

    def liks(thickness, direction):
        cov = (basis @ np.diag([0.04, 0.04, thickness]) @ basis.T).astype(np.float32)
        m = make_ndt_map([[0, 0, 0]], [[0.25, 0.25, 0.25]], [cov], 0.5, device="cpu")
        q = (np.array([[0.25, 0.25, 0.25]]) + 0.05 * direction).astype(np.float32)
        lu = float(ndt_mod._kernel_likelihood(m, params, t(q), t(cov[None]),
                                              ndt_mod.KERNEL_3D[:1]))
        closed = float(ndt_mod._kernel_likelihood_dense(m, params, t(q), t(cov[None]))[0])
        return lu, closed

    for direction in (u, normal, (u + normal) / np.sqrt(2)):
        lu, closed = liks(1e-3, direction)
        assert closed == pytest.approx(lu, rel=1e-5) and lu > 0.1
    lu, closed = liks(1e-8, u)
    assert abs(lu - closed) > 1e-4 * lu


# -- the cell index: the fused kernel's probe by address ----------------------


def _index_map(d, cells, sentinels=0):
    """``make_ndt_map`` of ``cells`` (random means, identity covariances),
    or with ``sentinels`` rows of key 0xFFFFFFFF past the live ones, as the
    empty map keeps one, with the index built from the live keys."""
    cells = np.asarray(cells, np.int32).reshape(-1, d)
    means = np.random.default_rng(len(cells)).normal(size=cells.shape).astype(np.float32)
    covs = np.broadcast_to(np.eye(d, dtype=np.float32), (len(cells), d, d))
    m = make_ndt_map(cells, means, covs, 0.5, device="cpu")
    if not sentinels:
        return m
    keys = np.concatenate([m.keys.numpy(), np.full(sentinels, 0xFFFFFFFF, np.int64)])
    pad = lambda a: torch.cat([a, a[:1].expand(sentinels, *a.shape[1:])])  # noqa: E731
    return ndt_map_mod.NdtMap(keys=t(keys), means=pad(m.means), covs=pad(m.covs),
                              values=pad(m.values), num_cells=m.num_cells,
                              resolution=m.resolution,
                              index=ndt_map_mod.cell_index(keys, m.num_cells, d, "cpu"))


def _index_cases():
    rng = np.random.default_rng(40)
    top2, top3 = (1 << 15) - 1, (1 << 9) - 1
    return {  # d, cells, sentinel rows
        "2d-random": (2, np.unique(rng.integers(-30, 30, (300, 2)), axis=0), 0),
        "3d-random": (3, np.unique(rng.integers(-8, 8, (400, 3)), axis=0), 0),
        # live cells beside the cell whose key the sentinel rows carry
        "2d-sentinel": (2, [[top2, top2 - 1], [top2 - 1, top2], [top2 - 3, top2 - 2]], 2),
        "3d-sentinel": (3, [[top3, top3, top3 - 1], [top3 - 2, top3, top3]], 1),
        # a box that runs across the key's wrap on every axis
        "2d-across-the-wrap": (2, [[top2, -(1 << 15)], [-(1 << 15) + 2, top2 - 3],
                                   [top2 - 1, top2]], 0),
        "3d-across-the-wrap": (3, [[top3, -(1 << 9), 0], [-(1 << 9) + 1, top3, top3],
                                   [top3 - 2, top3 - 1, -(1 << 9)]], 0),
        # the same cell twice (searchsorted finds the first row), cells out
        # of the key's range (they wrap), a one-cell box edge
        "2d-duplicates-and-wrapped": (2, [[3, 4], [3, 4], [65540, -2], [4, 4], [3, 5]], 0),
        "3d-duplicates-and-wrapped": (3, [[1, 1, 1], [1, 1, 1], [1025, 1, 0], [0, 0, 0]], 0),
        "2d-one-cell": (2, [[-7, 9]], 0),
        # every other cell of an axis: the padded box is the whole axis
        "3d-whole-axis": (3, np.stack([np.arange(-512, 512, 2), np.zeros(512), np.zeros(512)],
                                      -1), 0),
        "2d-empty": (2, np.zeros((0, 2)), 0),
        "3d-empty": (3, np.zeros((0, 3)), 0),
    }


@pytest.mark.parametrize("case", list(_index_cases()))
def test_cell_index_finds_the_rows_searchsorted_finds(case):
    """Every cell of the index's box, a band of 3 cells about it, and each
    of those moved by the key's period on every axis (an alias: the same
    key) gives through the index the row ``NdtMap.lookup`` gives by
    ``searchsorted``, or none; the same for far and random cells."""
    d, cells, sentinels = _index_cases()[case]
    m = _index_map(d, cells, sentinels)
    index = m.index
    assert index is not None and index.rows.dtype == torch.int16
    assert index.rows.numel() % 8 == 0 and index.rows.numel() >= np.prod(index.size)
    bits = 16 if d == 2 else 10
    bias = 1 << (bits - 1)
    band = 3
    axes = [np.arange(lo - band, lo + size + band) for lo, size in zip(index.lo, index.size)]
    u = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)
    probes = [u % (1 << bits) - bias]  # back to cell coordinates
    for a in range(d):
        for k in (-1, 1, 3):
            moved = probes[0].copy()
            moved[:, a] += k << bits
            probes.append(moved)
    rng = np.random.default_rng(41)
    probes.append(rng.integers(-(1 << 20), 1 << 20, (2000, d)))
    q = t(np.concatenate(probes))
    rows, found = m.lookup(q)
    want = torch.where(found, rows, ndt_map_mod.NO_ROW)
    got = index.lookup(q)
    assert torch.equal(got, want)
    if m.num_cells:
        assert bool(found.any()) and not bool(found.all())
        assert int(found.sum()) >= len(probes) - 1  # each alias of a live cell hits


@pytest.mark.parametrize("d", [2, 3])
def test_cell_index_only_within_its_budget(d):
    """A box of ``INDEX_MAX_CELLS`` cells has an index (with no room for
    the padding); one cell more, or two clusters far apart (a sparse
    map), has none, and the map alone decides.  The repo's maps fit with
    a cell of padding on each side: the arena at 0.4 m (48 x 48 live) and
    its 3D extrusion at 0.5 m (39 x 39 x 4)."""
    budget = ndt_map_mod.INDEX_MAX_CELLS
    side = (128, 256) if d == 2 else (32, 32, 32)
    corner = np.array(side) - 1
    assert np.prod(side) == budget
    fits = _index_map(d, [np.zeros(d), corner])
    assert fits.index is not None and fits.index.size == side
    over = corner.copy()
    over[0] += 1
    assert _index_map(d, [np.zeros(d), over]).index is None
    rng = np.random.default_rng(42)
    cluster = rng.integers(0, 6, (40, d))
    assert _index_map(d, np.concatenate([cluster, cluster + 300])).index is None
    from beluga_tpu_torch.tools import workloads

    m = workloads.ndt_map_2d("cpu") if d == 2 else workloads.ndt_map_3d("cpu")
    assert m.index.size == ((50, 50) if d == 2 else (41, 41, 6))
    assert m.to("cpu").index.size == m.index.size


def test_fused_wrapper_checks_the_cell_index():
    """The wrapper takes the map's index, and refuses one the kernel
    cannot read."""
    _, m = probe_map(2, 90)
    _, st, _, means, covs, cmask = probe_inputs(probe_map(2, 90)[0], 2, 91)
    rot, trans = ndt_mod.pose_matrices(st)
    args = (m.keys, m.values, m.num_cells, m.resolution, rot, trans, t(means), t(covs),
            t(cmask), ndt_mod.KERNEL_2D)
    assert m.index is not None
    assert torch.equal(cuda_ndt.ndt_weights(*args, index=m.index),
                       cuda_ndt.ndt_weights_reference(*args))
    idx = m.index
    bad = {
        "int16": dataclasses.replace(idx, rows=idx.rows.to(torch.int32)),
        "multiple of 8": dataclasses.replace(idx, rows=idx.rows[:-1]),
        "does not fit": dataclasses.replace(idx, size=(idx.size[0] + 1, idx.size[1])),
        "box": dataclasses.replace(idx, lo=(0, 0, 0), size=(1, 1, 1)),
        "a tensor on cpu": dataclasses.replace(idx, rows=idx.rows.to("meta")),
    }
    for match, index in bad.items():
        with pytest.raises(ValueError, match=match):
            cuda_ndt.ndt_weights(*args, index=index)

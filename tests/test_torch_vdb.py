"""The 3D distance grid, its code table, kernel B11's plain version, the
VDB likelihood-field model and the VDB filter of the PyTorch port, held
against the JAX package on the CPU.

Tolerances: the 3D EDT, the distance volume, the code table, the codebook
and every lookup through them are exact (B11 copies codebook entries; the
reference's interpret-mode kernel selects them exactly).  World points are
rounded to voxels after a rotation that XLA may contract into FMAs, so a
point within the last bits of a voxel boundary may round to the
neighbouring voxel: the tests count those flips (at most 0.5% of the
points) instead of hiding them.  Weights agree within rtol 1e-5 where no
voxel flipped (XLA's ``exp`` and its FMA of ``amplitude·exp + offset``);
one filter update within the tolerances of ``tests/test_torch_filter.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu import lie as jlie
from beluga_tpu.core.random import sample_normal_se3 as j_sample_normal_se3
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.vdb_builders import make_vdb_filter_3d as j_make_vdb
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.lie import SE3 as JSE3
from beluga_tpu.lie import SO3 as JSO3
from beluga_tpu.maps.voxel import make_distance_codes as j_make_codes
from beluga_tpu.maps.voxel import make_distance_grid as j_make_grid
from beluga_tpu.maps.voxel import make_distance_grid_from_points as j_grid_from_points
from beluga_tpu.maps.voxel import squared_distance_transform_3d as j_edt3
from beluga_tpu.models.sensor.vdb_likelihood import VdbLikelihoodFieldParams as JVdbParams
from beluga_tpu.models.sensor.vdb_likelihood import vdb_likelihood_weights as j_vdb_weights
from beluga_tpu.ops.pallas_lookup import pallas_codebook_lookup as j_codebook_lookup
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.vdb_builders import make_vdb_filter_3d
from beluga_tpu_torch.lie import SE2, SE3, SO3, to_3d
from beluga_tpu_torch.maps.voxel import (
    make_distance_codes,
    make_distance_grid,
    make_distance_grid_from_points,
    squared_distance_transform_3d,
)
from beluga_tpu_torch.models.sensor.vdb_likelihood import (
    VdbLikelihoodFieldParams,
    vdb_likelihood_weights,
)
from beluga_tpu_torch.ops.cuda_codebook import codebook_lookup, codebook_lookup_reference

torch.set_num_threads(1)

AMP = 0.5 / (0.2 * np.sqrt(2 * np.pi))


def t(a):
    return torch.as_tensor(np.array(a))


def room_points():
    """BASELINE config #4's room (bench.py:734-739): floor, two walls and a
    pillar as an obstacle cloud."""
    pts = [[x, y, 0.0] for x in np.arange(0, 8, 0.2) for y in np.arange(0, 8, 0.2)]
    for s in np.arange(0, 8, 0.1):
        for z in np.arange(0, 2.5, 0.25):
            pts += [[s, 0.0, z], [0.0, s, z]]
    pts += [[5.0, 5.0, z] for z in np.arange(0, 2.0, 0.2)]
    return np.asarray(pts)


@pytest.fixture(scope="module")
def room():
    pts = room_points()
    jgrid = j_grid_from_points(pts, 0.2, max_distance=5.0)
    grid = make_distance_grid_from_points(pts, 0.2, max_distance=5.0, device="cpu")
    return jgrid, grid


def test_edt3d_exact_against_brute_force_and_reference():
    rng = np.random.default_rng(0)
    obs = rng.random((6, 7, 8)) < 0.1
    got = squared_distance_transform_3d(t(obs), 100.0).numpy()
    zs, ys, xs = np.nonzero(obs)
    want = np.empty_like(got)
    for z in range(6):
        for y in range(7):
            for x in range(8):
                want[z, y, x] = ((zs - z) ** 2 + (ys - y) ** 2 + (xs - x) ** 2).min()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_edt3(jnp.asarray(obs), 100.0)))
    clamped = squared_distance_transform_3d(t(obs), 1.5).numpy()
    np.testing.assert_array_equal(clamped, np.minimum(want, np.float32(1.5) ** 2))


def test_grid_from_points_and_codes_match_reference(room):
    jgrid, grid = room
    assert tuple(grid.values.shape) == (21, 49, 49)  # the bench volume
    np.testing.assert_array_equal(grid.values.numpy(), np.asarray(jgrid.values))
    np.testing.assert_array_equal(grid.origin_xyz.numpy(), np.asarray(jgrid.origin_xyz))
    assert grid.voxel_size == float(jgrid.voxel_size)
    assert grid.background == float(jgrid.background)
    codes, book = make_distance_codes(grid, 0.2, 5.0)
    jcodes, jbook = j_make_codes(jgrid, 0.2, 5.0)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (49, 21 * 49)
    for got, want in zip(make_distance_codes(grid, 0.2, 100.0), (codes, book)):
        assert torch.equal(got, want)  # the filter's background: the same table
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(book.numpy(), np.asarray(jbook))


def test_distance_lookup_reference_cases():
    """tests/test_landmark_and_vdb.py:116-130 on the port."""
    obs = np.zeros((5, 5, 5), bool)
    obs[2, 2, 2] = True
    g = make_distance_grid(obs, 1.0, device="cpu")
    d = g.distance_at(t(np.array([[2.0, 2.0, 2.0], [2.0, 2.0, 4.0], [100.0, 0.0, 0.0]],
                                 np.float32)))
    np.testing.assert_allclose(d.numpy(), [0.0, 2.0, g.background], atol=1e-6)
    g2 = make_distance_grid_from_points([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]], 0.25, device="cpu")
    assert float(g2.distance_at(t(np.array([[1.0, 1.0, 1.0]], np.float32)))[0]) == 0.0
    # half to even, as jnp.round: 0.5 and 2.5 voxels round down, 1.5 up
    idx = g.voxel_index(t(np.array([[0.5, 1.5, 2.5]], np.float32)))
    np.testing.assert_array_equal(idx.numpy(), [[0, 2, 2]])


def test_b11_plain_matches_interpret_kernel():
    """tests/test_landmark_and_vdb.py:160-172: B11's plain version and the
    port's distance lookups against the reference's interpret-mode kernel
    and its gather, bit for bit (queries out of range on every side)."""
    rng = np.random.default_rng(0)
    occ = np.zeros((10, 40, 56), bool)
    occ[rng.integers(0, 10, 30), rng.integers(0, 40, 30), rng.integers(0, 56, 30)] = True
    jgrid = j_make_grid(occ, 0.25, max_distance=3.0)
    grid = make_distance_grid(occ, 0.25, max_distance=3.0, device="cpu")
    jcb = j_make_codes(jgrid, 0.25, 3.0)
    codes, book = make_distance_codes(grid, 0.25, 3.0)
    h, w = codes.shape
    yi = rng.integers(-5, h + 5, (300,)).astype(np.int32)
    xi = rng.integers(-5, w + 5, (300,)).astype(np.int32)
    want = np.asarray(j_codebook_lookup(jcb[0], jcb[1], jnp.asarray(yi), jnp.asarray(xi),
                                        interpret=True))
    got = codebook_lookup_reference(codes, book, t(yi), t(xi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(codebook_lookup(codes, book, t(yi), t(xi)), got)
    # a code beyond a short codebook reads 0, as the one-hot decode selects nothing
    assert float(codebook_lookup_reference(codes, book[:1], t(yi), t(xi)).max()) <= float(book[0])

    pts = rng.uniform(-1.0, 14.5, (300, 3)).astype(np.float32)
    jwant = np.asarray(jgrid.distance_at(jnp.asarray(pts), codes_book=jcb))
    np.testing.assert_array_equal(grid.distance_at(t(pts), codes_book=(codes, book)).numpy(),
                                  jwant)
    np.testing.assert_array_equal(grid.distance_at(t(pts)).numpy(),
                                  np.asarray(jgrid.distance_at(jnp.asarray(pts))))


def test_vdb_weights_reference_cases():
    """tests/test_landmark_and_vdb.py:132-157 on the port: a perfect hit
    scores 1 + amplitude + offset, from SE2 and SE3 states."""
    wall = [[3.0, y * 0.2, z * 0.2] for y in range(10) for z in range(5)]
    grid = make_distance_grid_from_points(wall, 0.1, max_distance=5.0, device="cpu")
    params = VdbLikelihoodFieldParams(max_laser_distance=5.0)
    points = t(np.array([[3.0, 1.0, 0.4]], np.float32))
    mask = torch.ones(1, dtype=torch.bool)
    w = vdb_likelihood_weights(params, grid, SE2.from_xytheta(t([0.0, 1.0]), t([0.0, 0.0]),
                                                              t([0.0, 0.0])), points, mask)
    assert float(w[0]) > float(w[1])
    assert float(w[0]) == pytest.approx(1.0 + AMP + 0.1, rel=1e-3)
    w3 = vdb_likelihood_weights(params, grid, SE3.identity((1,)), points, mask)
    assert float(w3[0]) == pytest.approx(1.0 + AMP + 0.1, rel=1e-3)


@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("se2", [False, True])
def test_vdb_weights_match_reference(room, codes, se2):
    jgrid, grid = room
    rng = np.random.default_rng(3)
    n, p = 256, 80
    if se2:
        xyt = np.c_[rng.normal(3, 0.3, (n, 2)), rng.normal(0.3, 0.1, n)].astype(np.float32)
        jst, st = JSE2.from_xytheta(jnp.asarray(xyt)), SE2.from_xytheta(t(xyt))
    else:
        xyz = np.c_[rng.normal(3, 0.3, (n, 2)), rng.normal(0, 0.05, n)].astype(np.float32)
        rpy = rng.normal(0, [0.03, 0.03, 0.2], (n, 3)).astype(np.float32)
        jst = JSE3(jnp.asarray(xyz), JSO3.from_rpy(*(jnp.asarray(rpy[:, i]) for i in range(3))))
        st = convert.se3(jax.device_get(jst))
    pts = rng.uniform([-3, -3, 0], [4, 4, 2], (p, 3)).astype(np.float32)
    mask = rng.uniform(size=p) > 0.1
    jcb = j_make_codes(jgrid, 0.2, 5.0) if codes else None
    cb = make_distance_codes(grid, 0.2, 5.0) if codes else None
    want = np.asarray(jax.jit(lambda s, a, b: j_vdb_weights(JVdbParams(), jgrid, s, a, b,
                                                           codes_book=jcb))(
        jst, jnp.asarray(pts), jnp.asarray(mask)))
    got = vdb_likelihood_weights(VdbLikelihoodFieldParams(), grid, st, t(pts), t(mask),
                                 codes_book=cb).numpy()
    # each point's voxel in both packages, to count rounding flips
    pose = to_3d(st) if se2 else st
    world = SO3(pose.rot.q[:, None, :]).act(t(pts)[None]) + pose.xyz[:, None, :]
    jworld = jax.jit(lambda s, a: (lambda q: q.act(a[None]))(
        jlie.SO3((jlie.to_3d(s) if se2 else s).rot.q[:, None, :]))
        + (jlie.to_3d(s) if se2 else s).xyz[:, None, :])(jst, jnp.asarray(pts))
    jvoxel = np.asarray(jnp.round((jworld - jgrid.origin_xyz) / jgrid.voxel_size)).astype(int)
    flips = (grid.voxel_index(world).numpy() != jvoxel).any(-1) & mask
    assert flips.sum() <= flips.size // 200, f"{flips.sum()} of {flips.size} voxels flipped"
    ok = ~flips.any(-1)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5)
    assert ok.sum() >= n - n // 20


def test_one_vdb_update_matches_reference(room):
    """One forced update of the VDB filter (BASELINE config #4's shape, cut
    to 400 particles x 80 points): the port with its code table (B11's
    plain version) against the reference with the same table put in its ctx
    (its lookup runs the Pallas kernel in interpret mode)."""
    jgrid, grid = room
    n = 400
    kw = dict(max_particles=n, min_particles=n // 4, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_vdb(jgrid, voxel_size_hint=0.2)
    # the reference builds its table only on a TPU; a background of 5 m
    # (the grid's) gives the same table and skips its slow host proposal
    jctx = {**jctx, "vdb_codes": j_make_codes(jgrid, 0.2, 5.0)}
    models, ctx = make_vdb_filter_3d(grid, voxel_size_hint=0.2)
    assert "vdb_codes" in ctx
    np.testing.assert_array_equal(ctx["vdb_codes"][0].numpy(), np.asarray(jctx["vdb_codes"][0]))
    rng = np.random.default_rng(4)
    wp = np.asarray([[5.0, 5.0, z] for z in np.arange(0, 2.0, 0.2)]
                    + [[s, 0.0, 1.0] for s in np.arange(0, 8, 0.4)]
                    + [[0.0, s, 1.0] for s in np.arange(0, 8, 0.4)])
    sel = wp[rng.integers(0, len(wp), 80)]
    c, s = np.cos(0.3), np.sin(0.3)
    pts = ((sel - [3.0, 3.0, 0.0]) @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
           + rng.normal(0, 0.02, sel.shape)).astype(np.float32)
    mask = np.ones(80, bool)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    mean = JSE3(jnp.asarray([3.0, 3.0, 0.0], jnp.float32),
                JSO3.from_rpy(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.3)))
    jstate = j_amcl.init_state(k2, j_sample_normal_se3(k1, n, mean, jnp.eye(6) * 0.05), jparams,
                               odom_identity=JSE3.identity())
    state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
    _, k_prop, k_res, _, k_mask = jax.random.split(jstate.key, 5)
    draws = amcl.UpdateDraws(
        motion_normals=t(jax.random.normal(k_prop, (3, n), jnp.float32)),
        positions=t(j_systematic_positions(k_res, n)),
        inject_uniform=t(jax.random.uniform(k_mask, (n,), jnp.float32)),
        random_states=state.particles.state)  # unused: recovery probability 0
    jstate, jest = jax.jit(lambda st, p, m: j_amcl.update(jparams, jmodels, jctx, st,
                                                          JSE3.identity(), p, m))(
        jstate, jnp.asarray(pts), jnp.asarray(mask))
    state, est = amcl.update(params, models, ctx, state, SE3.identity(), t(pts), t(mask),
                             draws=draws)
    ref = jax.device_get(jstate)
    assert est.valid and bool(jest.valid)
    xyz, q = state.particles.state.xyz.numpy(), state.particles.state.rot.q.numpy()
    jxyz, jq = np.asarray(ref.particles.state.xyz), np.asarray(ref.particles.state.rot.q)
    other = (np.abs(xyz - jxyz).max(1) > 1e-5) | (np.abs(q - jq).max(1) > 1e-5)
    assert other.sum() <= n // 100, f"{other.sum()} slots hold another donor"
    np.testing.assert_allclose(xyz[~other], jxyz[~other], atol=1e-5)
    assert abs(int(state.particles.active) - int(ref.particles.active)) <= (
        n // 100 if other.any() else 0)
    np.testing.assert_allclose(est.pose.xyz.numpy(), np.asarray(jest.pose.xyz), atol=1e-3)
    assert np.linalg.norm(est.pose.xyz.numpy() - [3.0, 3.0, 0.0]) < 0.5

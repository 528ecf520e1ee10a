"""The winlut fleet (``make_winlut_fleet_update``) in the port against the
JAX package's pieces on the CPU, at the sizes of
``tests/test_winlut_fleet.py`` (4 filters of 256 particles, a 48-cell
window of 32 bins, tiles of 128): the per-filter coverage gate against
``windowed_coverage_tiled_from_center`` on each filter, the fast branch's
log-weights against ``windowed_scan_lut_weights(interpret=True)`` on each
filter's prefix, the branch taken against the reference's rule, the exact
branch against the codebook16 fleet step, and a fleet that tracks.

Tolerances: coverage equal; the fast weights within 1e-6 relative on one
table (the reference's, converted) with the same miss set, the port's
float32 tents against the reference's dot products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor import likelihood_field_winlut as J
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.models.sensor.likelihood_field import make_likelihood_field as j_make_field
from beluga_tpu_torch import convert
from beluga_tpu_torch.core.particles import tree_map, tree_sort_by
from beluga_tpu_torch.core.random import sample_normal_se2, sample_uniform_box_se2
from beluga_tpu_torch.filters import builders
from beluga_tpu_torch.filters.amcl import AmclParams, init_state, update
from beluga_tpu_torch.filters.builders import make_winlut_fleet_update
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams

torch.set_num_threads(1)

CENTER = (3.2, 3.2, 0.7)
N, B, NB = 256, 4, 24
GEO = dict(k_bins=32, win=48, max_point_radius=2.5)
KW = dict(tile=128, tblk=8, **GEO)
DTH = 2.0 * np.pi / 128.0


def block_map():
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    data[45:48, 12:18] = OCCUPIED_VALUE
    return data


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, NB, endpoint=False)
    r = rng.uniform(0.5, 2.0, NB)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32)
    params = AmclParams(max_particles=N, min_particles=N, sorted_slots=True,
                        update_min_d=0.0, update_min_a=0.0)
    lf = dict(max_laser_distance=5.0)
    step, ctx = make_winlut_fleet_update(params, make_grid(block_map(), 0.1, device="cpu"),
                                         LikelihoodFieldParams(**lf), device="cpu", **KW)
    jfield = j_make_field(JLFParams(**lf), j_make_grid(block_map(), 0.1))
    return dict(params=params, step=step, ctx=ctx, jfield=jfield,
                points=torch.as_tensor(np.broadcast_to(pts, (B, NB, 2)).copy()),
                masks=torch.ones(B, NB, dtype=torch.bool), pts=pts)


def fleet(params, seed, diverged=False):
    """B filters about CENTER, tight enough in heading (0.03 rad) that each
    tile of 128 θ-sorted slots fits its 8-bin slab; with ``diverged``
    filter 0 is uniform over the map."""
    g = torch.Generator().manual_seed(seed)
    st = sample_normal_se2(g, N, SE2.from_xytheta(*CENTER, device="cpu"),
                           np.diag([0.01, 0.01, 0.001]), lead=(B,))
    if diverged:
        wide = sample_uniform_box_se2(g, N, [0.5, 0.5], [5.9, 5.9])
        st = SE2(torch.cat([wide.xy[None], st.xy[1:]]),
                 SO2(torch.cat([wide.rot.z[None], st.rot.z[1:]])))
    return init_state(g, tree_sort_by(st.theta, st), params, device="cpu")


def odoms(dx=0.0):
    c = [torch.full((B,), v) for v in (CENTER[0] + dx, CENTER[1], CENTER[2])]
    return SE2.from_xytheta(*c)


def jstates(st: SE2, i: int) -> JSE2:
    return JSE2(jnp.asarray(st.xy[i].numpy()), type(JSE2.identity().rot)(
        jnp.asarray(st.rot.z[i].numpy())))


def centre(st: SE2):
    return (torch.mean(st.x), torch.mean(st.y),
            torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos)))


@pytest.mark.parametrize("diverged", [False, True])
def test_per_filter_coverage_against_reference(world, diverged):
    """The gate's coverage ``[B]`` (one call for the fleet) equals the
    reference's per filter, each filter's exact tail left out."""
    st = fleet(world["params"], 1, diverged).particles.state
    s_tail = builders._exact_tail_slots(N, KW["tile"], 0.125)
    prefix = tree_map(lambda leaf: leaf[..., : N - s_tail, :], st)
    c = centre(st)
    got = builders.windowed_coverage_tiled_from_center(world["ctx"]["field"], prefix, *c,
                                                       tile=128, tblk=8, **GEO)
    assert got.shape == (B,)
    for i in range(B):
        want = J.windowed_coverage_tiled_from_center(
            world["jfield"], jstates(prefix, i), *(jnp.float32(float(v)) for v in c),
            tile=128, tblk=8, resolution_hint=0.1, **GEO)
        assert float(got[i]) == float(want)
    assert (float(got.min()) < 0.98) == diverged


def test_fast_log_weights_against_reference(world):
    """The fast branch's log-weights: each filter's prefix through the shared
    LUT in one flat lookup, equal to the reference's per-filter lookup on
    the same table; the tail through the codebook16 model."""
    st = fleet(world["params"], 2).particles.state
    c = centre(st)
    jlut = J.build_windowed_scan_lut(world["jfield"], jnp.asarray(world["pts"]),
                                     jnp.ones(NB, bool), *(jnp.float32(float(v)) for v in c),
                                     dth=DTH, resolution_hint=0.1, **GEO)
    lut = convert.windowed_scan_lut(jax.device_get(jlut))
    fctx = {**world["ctx"], "winlut": lut}
    models = world["step"].models_fast
    got = models.log_weight(fctx, st, world["points"], world["masks"])
    assert got.shape == (B, N)
    s_tail = builders._exact_tail_slots(N, 128, 0.125)
    for i in range(B):
        want = np.asarray(J.windowed_scan_lut_weights(
            jlut, jstates(tree_map(lambda leaf: leaf[..., : N - s_tail, :], st), i), tile=128,
            tblk=8, interpret=True))
        w = np.exp(got[i, : N - s_tail].numpy())
        miss = float(jlut.miss)
        assert np.array_equal(w == np.float32(miss), want == np.float32(miss))
        np.testing.assert_allclose(w, np.maximum(want, 1e-30), rtol=2e-6)
    tail = tree_map(lambda leaf: leaf[..., N - s_tail:, :], st)
    exact = world["step"].models_exact.log_weight(world["ctx"], tail, world["points"],
                                                  world["masks"])
    assert torch.equal(got[:, N - s_tail:], exact)


@pytest.mark.parametrize("diverged", [False, True])
def test_branch_taken_against_reference(world, diverged, monkeypatch):
    """The step builds the shared LUT exactly when the reference's rule,
    ``min(coverage) >= 0.98`` over its predicted poses, takes the fast
    branch; a diverged filter sends the fleet through the codebook16 step
    with its weights bit for bit."""
    built = []
    real = builders.build_windowed_scan_lut
    monkeypatch.setattr(builders, "build_windowed_scan_lut",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    state = fleet(world["params"], 3, diverged)
    od = odoms(0.05)
    new, est = world["step"](world["ctx"], state, od, world["points"], world["masks"])
    # the reference's prediction: the first update's delta is the identity
    st = state.particles.state
    c = centre(st)
    covs = [float(J.windowed_coverage_tiled_from_center(
        world["jfield"], jstates(tree_map(lambda leaf: leaf[..., : N - 128, :], st), i),
        *(jnp.float32(float(v)) for v in c), tile=128, tblk=8, resolution_hint=0.1, **GEO))
        for i in range(B)]
    assert bool(built) == (min(covs) >= 0.98) == (not diverged)
    assert np.all(est.valid)
    if diverged:  # a fresh copy of the state draws what the step drew
        want, _ = update(world["params"], world["step"].models_exact, world["ctx"],
                         fleet(world["params"], 3, diverged), od, world["points"],
                         world["masks"])
        assert torch.equal(new.particles.log_weight, want.particles.log_weight)
        assert torch.equal(new.particles.state.xy, want.particles.state.xy)


def test_fleet_tracks_within_the_gate(world, monkeypatch):
    """A tight fleet, odometry moving along x, starts on the fast branch and
    stays within 0.35 m of the truth (the reference's test), every filter,
    whichever branch the gate takes as the clouds spread."""
    built = []
    real = builders.build_windowed_scan_lut
    monkeypatch.setattr(builders, "build_windowed_scan_lut",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    state = fleet(world["params"], 4)
    for t in range(4):
        dx = 0.05 * t
        state, est = world["step"](world["ctx"], state, odoms(dx), world["points"],
                                   world["masks"])
        pose = est.pose.as_xytheta().numpy()
        assert np.all(est.valid) and np.isfinite(pose).all()
        err = np.hypot(pose[:, 0] - CENTER[0], pose[:, 1] - CENTER[1])
        assert np.all(err < 0.35), err
        if t == 0:
            assert built == [1]


def test_contracts_raise(world):
    grid = make_grid(block_map(), 0.1, device="cpu")
    with pytest.raises(ValueError, match="sorted_slots"):
        make_winlut_fleet_update(AmclParams(max_particles=N, min_particles=N), grid,
                                 device="cpu", **KW)
    with pytest.raises(ValueError, match="multiple of tile"):
        make_winlut_fleet_update(AmclParams(max_particles=300, min_particles=300,
                                            sorted_slots=True), grid, device="cpu", **KW)

"""The port's mega tracking filter (``make_windowed_scan_filter``, fused and
unfused) and the bounded recovery pool, held against the JAX package's
``filters/amcl.update`` on the CPU, plus the map-swap repair.

The port is fed every draw the reference made from its key splits
(``filters/amcl.py:315``, ``:449-456``): the motion normals, the
systematic positions, the recovery pool, the binomial count and the target
slots.  The slots the reference drew are distinct in these cases (checked),
since duplicate targets resolve in an unspecified order in both
frameworks.  Tolerances are those of ``tests/test_torch_filter.py``: states
within 1e-5 except up to 0.5% of the slots that may hold a neighbouring
donor (a systematic position at a CDF step that moved in the last bits),
Thrun values within 1e-6 relative, the estimate within 1e-4 plus the
offset of such slots.  The windowed (unfused) filter's table differs from
the reference's by one bf16 ulp in a few entries (``test_torch_winlut.py``),
so its log-likelihoods are compared within 2⁻⁷ relative of the weight.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.algorithms.thrun import ExpFilterState as JExpFilterState
from beluga_tpu.algorithms.thrun import ThrunState as JThrunState
from beluga_tpu.algorithms.thrun import thrun_update as j_thrun_update
from beluga_tpu.core.particles import tree_take as j_tree_take
from beluga_tpu.core.random import sample_normal_se2 as j_sample_normal_se2
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.builders import make_likelihood_field_filter as j_make_lf_filter
from beluga_tpu.filters.builders import make_windowed_scan_filter as j_make_windowed
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.core.random import sample_normal_se2
from beluga_tpu_torch.filters import amcl, builders
from beluga_tpu_torch.filters.builders import (
    make_likelihood_field_filter,
    make_windowed_scan_filter,
    update_map_ctx,
)
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
    precompute_padded_field,
    windowed_scan_lut_weights,
)

torch.set_num_threads(1)

N, POOL = 512, 16
CENTER = (3.2, 3.2, 0.7)
LF = dict(max_laser_distance=5.0)
FUSED = dict(k_bins=20, win=(32, 128), dth=2.0 * np.pi / 64.0, max_point_radius=3.6,
             tile=128, tblk=20, recovery_candidates=64, coverage_threshold=0.0,
             exact_tail_frac=0.0, fused=True)
WINDOWED = dict(k_bins=32, win=64, max_point_radius=2.5, tile=128, recovery_candidates=64)


def block_map(extra=True):
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    if extra:
        data[45:48, 12:18] = OCCUPIED_VALUE
    return data


def scan_at(pose, data=None):
    pts, mask = synthetic.simulate_scans(block_map() if data is None else data, 0.1,
                                         [pose[0]], [pose[1]], [pose[2]], 24)
    return pts[0], mask[0]


def reference_state(params, key, cov, forced_recovery):
    """A θ-sorted normal cloud about CENTER; ``forced_recovery`` sets the
    Thrun averages so that the recovery probability is ~0.8."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    states = j_sample_normal_se2(k1, N, JSE2.from_xytheta(*CENTER), jnp.diag(jnp.asarray(cov)))
    states = j_tree_take(states, jnp.argsort(states.theta))
    state = j_amcl.init_state(k2, states, params)
    if forced_recovery:
        state = state._replace(thrun=JThrunState(
            JExpFilterState(jnp.float32(0.01), jnp.asarray(True)),
            JExpFilterState(jnp.float32(0.002), jnp.asarray(True))))
    return state


def reference_draws(jparams, jmodels, jctx, jstate):
    """Every draw of the reference's update with a recovery pool, as the
    port's ``UpdateDraws``."""
    _, k_prop, k_res, k_rand, k_mask = jax.random.split(jstate.key, 5)
    m = jparams.max_particles
    k_cnt, k_slot = jax.random.split(k_mask)
    active = jnp.maximum(jstate.particles.active.astype(jnp.float32), 1.0)
    _, p_random = j_thrun_update(jstate.thrun, jparams.alpha_slow, jparams.alpha_fast,
                                 1.0 / active)
    slots = np.asarray(jax.random.randint(k_slot, (jparams.recovery_pool,), 0, m))
    assert len(set(slots.tolist())) == len(slots), "pick a key whose target slots are distinct"
    randoms = jmodels.random_state(jctx, k_rand, jparams.recovery_pool, jstate.particles)

    def t(a):
        return torch.as_tensor(np.array(a))

    return amcl.UpdateDraws(
        motion_normals=t(jax.random.normal(k_prop, (3, N), jnp.float32)),
        positions=t(j_systematic_positions(k_res, m)),
        inject_uniform=None,
        random_states=convert.se2(jax.device_get(randoms)),
        inject_count=t(jax.random.binomial(k_cnt, m, p_random)),
        inject_slots=t(slots),
    )


def compare(state, est, ref, jest, weight_rtol=0.0):
    """The slice-1 tolerances (tests/test_torch_filter.py)."""
    xy, z = state.particles.state.xy.numpy(), state.particles.state.rot.z.numpy()
    jxy, jz = np.asarray(ref.particles.state.xy), np.asarray(ref.particles.state.rot.z)
    other = (np.abs(xy - jxy).max(1) > 1e-5) | (np.abs(z - jz).max(1) > 1e-5)
    assert other.sum() <= N // 200, f"{other.sum()} slots hold another donor"
    np.testing.assert_allclose(xy[~other], jxy[~other], rtol=0, atol=1e-5)
    np.testing.assert_allclose(z[~other], jz[~other], rtol=0, atol=1e-5)
    lw, jlw = state.particles.log_weight.numpy(), np.asarray(ref.particles.log_weight)
    np.testing.assert_allclose(lw[~other], jlw[~other], rtol=0, atol=1e-5 + 2 * weight_rtol)
    assert int(state.particles.active) == int(ref.particles.active)
    for got, want in ((state.thrun.slow, ref.thrun.slow), (state.thrun.fast, ref.thrun.fast)):
        np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                                   rtol=1e-6 + weight_rtol)
    assert state.resample_count == int(ref.resample_count)
    d = np.abs(np.concatenate([xy - jxy, z - jz], 1)).max(1)[other]
    moved = float(d.sum()) / N
    np.testing.assert_allclose(est.pose.xy.numpy(), np.asarray(jest.pose.xy), atol=1e-4 + moved)
    np.testing.assert_allclose(est.pose.rot.z.numpy(), np.asarray(jest.pose.rot.z),
                               atol=1e-4 + moved)
    return other


def one_update(jparams, params, jmodels, jctx, models, ctx, jstate, odom, weight_rtol=0.0):
    pts, mask = scan_at(CENTER)
    draws = reference_draws(jparams, jmodels, jctx, jstate)
    state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
    jstep = jax.jit(functools.partial(j_amcl.update, jparams, jmodels))
    ref, jest = jstep(jctx, jstate, JSE2.from_xytheta(*odom), jnp.asarray(pts), jnp.asarray(mask))
    state, est = amcl.update(params, models, ctx, state, amcl.host_pose(*odom),
                             torch.as_tensor(pts), torch.as_tensor(mask), draws=draws)
    return compare(state, est, jax.device_get(ref), jest, weight_rtol), state, draws


@pytest.mark.parametrize("selective", [False, True])
def test_one_fused_update_matches_reference(selective):
    """The mega configuration at N = 512, tile 128: fused forward (kernel
    B5's plain version), systematic resampling, the bounded pool of 16 with
    the recovery forced, θ sort."""
    kw = dict(max_particles=N, min_particles=N, sorted_slots=True, resampling="systematic",
              recovery_pool=POOL, selective_resampling=selective)
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_windowed(j_make_grid(block_map(), 0.1), JLFParams(**LF), **FUSED)
    models, ctx = make_windowed_scan_filter(make_grid(block_map(), 0.1, device="cpu"),
                                            LikelihoodFieldParams(**LF), device="cpu", **FUSED)
    jstate = reference_state(jparams, 11, [0.01, 0.01, 0.005], forced_recovery=True)
    odom = (CENTER[0] + 0.1, CENTER[1] + 0.05, CENTER[2] + 0.05)
    one_update(jparams, params, jmodels, jctx, models, ctx, jstate, odom)


@pytest.mark.parametrize("branch", ["fast", "exact"])
def test_one_windowed_update_matches_reference(branch, monkeypatch):
    """The unfused windowed filter at N = 512, tile 128, with its hybrid
    exact tail (128 slots) and the coverage gate: a tight cloud takes the
    fast branch, a wide one falls back to the exact model."""
    kw = dict(max_particles=N, min_particles=N, sorted_slots=True, resampling="systematic",
              recovery_pool=POOL)
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_windowed(j_make_grid(block_map(), 0.1), JLFParams(**LF), **WINDOWED)
    models, ctx = make_windowed_scan_filter(make_grid(block_map(), 0.1, device="cpu"),
                                            LikelihoodFieldParams(**LF), device="cpu",
                                            **WINDOWED)
    cov = [0.01, 0.01, 0.005] if branch == "fast" else [4.0, 4.0, 1.0]
    jstate = reference_state(jparams, 4, cov, forced_recovery=True)
    lookups = []
    monkeypatch.setattr(builders, "windowed_scan_lut_weights",
                        lambda *a, **k: lookups.append(1) or windowed_scan_lut_weights(*a, **k))
    # one bf16 ulp of a table entry moves a fast-branch weight by up to 2^-7
    one_update(jparams, params, jmodels, jctx, models, ctx, jstate, CENTER,
               weight_rtol=2.0 ** -7 if branch == "fast" else 0.0)
    assert len(lookups) == (branch == "fast")


def test_bounded_pool_injection_matches_reference():
    """The bounded pool alone (the likelihood-field filter, no window):
    the binomial count clamps to the pool and the pool entries land on the
    reference's slots, bit for bit away from CDF-step slots."""
    kw = dict(max_particles=N, min_particles=N, resampling="systematic", recovery_pool=POOL)
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    jmodels, jctx = j_make_lf_filter(j_make_grid(block_map(), 0.1), JLFParams(**LF),
                                     lookup_mode="codebook", recovery_candidates=64)
    models, _ = make_likelihood_field_filter(make_grid(block_map(), 0.1, device="cpu"),
                                             LikelihoodFieldParams(**LF), device="cpu",
                                             recovery_candidates=64)
    ctx = convert.ctx(jax.device_get(jctx))
    jstate = reference_state(jparams, 11, [0.01, 0.01, 0.005], forced_recovery=True)
    other, state, draws = one_update(jparams, params, jmodels, jctx, models, ctx, jstate,
                                     CENTER)
    assert float(draws.inject_count) > POOL  # the clamp is exercised
    slots = draws.inject_slots.numpy()
    pool_xy = draws.random_states.xy.numpy()
    np.testing.assert_array_equal(state.particles.state.xy.numpy()[slots], pool_xy)


def test_pool_bounds_injection_count():
    """The port's own draws (torch.binomial, randint): a sentinel recovery
    generator marks injected slots; each update injects at most the pool
    and the recovery fires (tests/test_amcl_filter.py:286-321)."""
    params = amcl.AmclParams(max_particles=400, min_particles=100, alpha_slow=0.0,
                             alpha_fast=100.0, recovery_pool=32)
    models, ctx = make_likelihood_field_filter(make_grid(block_map(), 0.1, device="cpu"),
                                               LikelihoodFieldParams(**LF), device="cpu")

    def sentinel(ctx, gen, n, particles=None):
        return SE2.from_xytheta(torch.full((n,), 77.0), torch.full((n,), 77.0), torch.zeros(n))

    models = models._replace(random_state=sentinel)
    gen = torch.Generator().manual_seed(0)
    states = sample_normal_se2(gen, 400, amcl.host_pose(5.0, 5.0, 0.0), np.eye(3) * 0.01)
    state = amcl.init_state(gen, states, params, device="cpu")
    pts, mask = map(torch.as_tensor, scan_at((5.0, 5.0, 0.0)))
    counts = []
    for _ in range(8):
        state = state._replace(force_update=True)
        state, _ = amcl.update(params, models, ctx, state, amcl.host_pose(0, 0, 0), pts, mask)
        assert torch.isfinite(state.particles.log_weight).all()
        counts.append(int((state.particles.state.x == 77.0).sum()))
    assert 0 < max(counts) <= 32, counts


def test_fused_filter_tracks():
    """The port's counterpart of tests/test_winlut.py:325-371: the fused
    mega update on a 64x64 map, 512 particles, tile 128, tblk 12, pool 16,
    sort every second update, six forced updates, stays within 0.3 m."""
    kw = dict(k_bins=32, win=(32, 128), max_point_radius=6.5, tile=128, tblk=12,
              coverage_threshold=0.0, exact_tail_frac=0.0, fused=True, recovery_candidates=64)
    models, ctx = make_windowed_scan_filter(make_grid(block_map(), 0.1, device="cpu"),
                                            device="cpu", **kw)
    params = amcl.AmclParams(max_particles=N, min_particles=N, sorted_slots=True,
                             resampling="systematic", recovery_pool=POOL,
                             selective_resampling=True, sort_interval=2, update_min_d=0.0,
                             update_min_a=0.0)
    gen = torch.Generator().manual_seed(7)
    states = sample_normal_se2(gen, N, amcl.host_pose(*CENTER), np.eye(3) * 0.04)
    state = amcl.init_state(gen, states, params, device="cpu")
    pts, mask = map(torch.as_tensor, scan_at(CENTER))
    for i in range(6):
        state = state._replace(force_update=True)
        state, est = amcl.update(params, models, ctx, state, amcl.host_pose(0, 0, 0), pts, mask,
                                 sort_now=(i % 2 == 0))
    assert torch.isfinite(state.particles.log_weight).all()
    err = float(np.hypot(float(est.pose.x) - CENTER[0], float(est.pose.y) - CENTER[1]))
    assert err < 0.3, err


def test_map_swap_rebuilds_the_window_image():
    """``update_map_ctx`` rebuilds ``field_pad3`` (and the DFT matrices)
    for the new map, where the reference keeps the old image
    (builders.py:206-225): the windowed weights after the swap equal a
    filter built on the new map."""
    lfp = LikelihoodFieldParams(**LF)
    models, ctx = make_windowed_scan_filter(make_grid(block_map(), 0.1, device="cpu"), lfp,
                                            device="cpu", coverage_threshold=0.0, **WINDOWED)
    other = make_grid(block_map(extra=False), 0.1, device="cpu")
    swapped = update_map_ctx(ctx, other, lfp)
    _, fresh = make_windowed_scan_filter(other, lfp, device="cpu", coverage_threshold=0.0,
                                         **WINDOWED)
    want = precompute_padded_field(fresh["field"], 64, 2.5)
    assert torch.equal(swapped["field_pad3"], want)
    assert not torch.equal(swapped["field_pad3"], ctx["field_pad3"])
    assert swapped["winlut_geometry"] == ctx["winlut_geometry"]
    gen = torch.Generator().manual_seed(1)
    states = sample_normal_se2(gen, N, amcl.host_pose(1.5, 4.6, 0.2), np.eye(3) * 0.01)
    pts, mask = map(torch.as_tensor, scan_at((1.5, 4.6, 0.2)))
    got = models.log_weight(swapped, states, pts, mask)
    np.testing.assert_array_equal(got.numpy(), models.log_weight(fresh, states, pts, mask).numpy())
    assert not torch.equal(got, models.log_weight(ctx, states, pts, mask))


def test_convert_carries_the_window_image():
    """``convert.ctx`` carries the reference's ``field_pad3``, which is the
    port's image of the carried field bit for bit.  (Each package's own
    field differs by a few ulp of ``exp``, ROADMAP C.)"""
    _, jctx = j_make_windowed(j_make_grid(block_map(), 0.1), JLFParams(**LF), **WINDOWED)
    got = convert.ctx(jax.device_get(jctx))
    assert torch.equal(got["field_pad3"], precompute_padded_field(got["field"], 64, 2.5))

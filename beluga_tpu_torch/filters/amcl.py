"""Adaptive Monte Carlo Localization, one update (port of
``beluga_tpu/filters/amcl.py``; ``beluga::Amcl``, amcl_core.hpp:81-233).

The update order, gates and parity quirks are the reference's: the
on-motion policy updates its pose memory before the force-update check;
the control window advances only on updates that pass the gate; the Thrun
estimator sees the post-normalize average weight; it resets when a
resample fires while the random-state probability is > 0; resampled
particles restart with weight 1; ``every_n`` counts gated-in updates.

Where the JAX package branches with ``lax.cond``, the port decides on the
host without reading the particles back:

* the motion gate uses only the odometry, which the caller holds on the
  host; the delta is computed in float32 in the reference's operation
  order, so a move right at ``update_min_d`` gates the same way;
* ``force_update`` and the ``every_n`` counter are host values;
* the ESS gate of ``selective_resampling`` (off at nav2 defaults) reads
  one value back, once per gated-in update;
* the KLD active count stays a device tensor.

Resampling always takes the accelerator branch of the reference
(amcl.py:399-423): positions, then kernel B2 (ops/cuda_resample.py), on
the CPU through its plain version.  Random draws come from the state's
``torch.Generator``, which the update advances in place, or from
``draws`` (:class:`UpdateDraws`), which lets a test feed the reference's
own draws.  The theta-sorted slots, the bounded recovery pool, residual
resampling and the fused propagate+reweight path wait for later slices
(ROADMAP A8, A9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.algorithms.estimation import estimate_se2
from beluga_tpu_torch.algorithms.kld import kld_active_count
from beluga_tpu_torch.algorithms.thrun import ThrunState, thrun_update
from beluga_tpu_torch.core.particles import (
    DEAD_LOG_WEIGHT,
    ParticleSet,
    make_from_states,
    tree_map,
    tree_where,
)
from beluga_tpu_torch.core.weights import effective_sample_size, normalize
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.ops.cuda_resample import (
    resample_take_tree,
    resample_take_tree_multinomial,
)
from beluga_tpu_torch.ops.resample import (
    POSITIONERS,
    interleave_slots,
    sorted_multinomial_positions,
)
from beluga_tpu_torch.ops.spatial_hash import spatial_hash_se2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AmclParams:
    """nav2-parity filter parameters (amcl_core.hpp:34-55,
    beluga_ros/amcl.hpp:50-98)."""

    update_min_d: float = 0.25
    update_min_a: float = 0.2
    resample_interval: int = 1
    selective_resampling: bool = False
    min_particles: int = 500
    max_particles: int = 2000
    alpha_slow: float = 0.001
    alpha_fast: float = 0.1
    kld_epsilon: float = 0.05
    kld_z: float = 3.0
    spatial_resolution_x: float = 0.5
    spatial_resolution_y: float = 0.5
    spatial_resolution_theta: float = 10.0 * 3.141592653589793 / 180.0
    resampling: str = "multinomial"  # reference default (views/sample.hpp)

    def __post_init__(self):
        if self.resampling not in POSITIONERS:
            raise NotImplementedError(
                f"resampling {self.resampling!r} is not ported; the port has "
                f"{sorted(POSITIONERS)} (residual waits for ROADMAP A8)"
            )


class AmclModels(NamedTuple):
    """Model functions; each takes the opaque ``ctx`` dict.

    propagate:    (ctx, z f32[3, N], states, pose, prev_pose) -> states, with
                  ``z`` the standard normals of the motion sample
    log_weight:   (ctx, states, points, beam_mask) -> f32[N]
    random_state: (ctx, generator, n, particles) -> states (recovery)
    hash_state:   (params, states) -> int64[N] spatial hashes (KLD buckets)
    estimate:     (params, particles) -> (mean pose, covariance)
    """

    propagate: Callable
    log_weight: Callable
    random_state: Callable
    hash_state: Callable
    estimate: Callable


class AmclState(NamedTuple):
    """Filter state.  Particles and the Thrun filters live on the device;
    the odometry memory and the gates live on the host."""

    particles: ParticleSet
    generator: torch.Generator
    thrun: ThrunState
    resample_count: int  # every_n internal counter
    motion_latest: SE2  # on-motion policy memory (host)
    motion_seeded: bool
    control_prev: SE2  # previous odometry of the control window (host)
    control_seeded: bool
    force_update: bool


class Estimate(NamedTuple):
    pose: SE2
    covariance: Tensor  # f32[3, 3]
    valid: bool  # False when the update was gated out


class UpdateDraws(NamedTuple):
    """Every random draw of one update, in place of the generator's:
    ``motion_normals`` f32[3, N]; ``positions`` f32[M] for the resampler;
    ``inject_uniform`` f32[M] (slot m is replaced by a recovery state when
    it is below the random-state probability); ``random_states`` the M
    recovery states."""

    motion_normals: Tensor
    positions: Tensor
    inject_uniform: Tensor
    random_states: Any


def default_hash_state(params: AmclParams, states: SE2) -> Tensor:
    return spatial_hash_se2(
        states.xy, states.theta, params.spatial_resolution_x,
        params.spatial_resolution_theta, res_y=params.spatial_resolution_y,
    )


def default_estimate(params: AmclParams, particles: ParticleSet):
    del params
    return estimate_se2(particles.state, particles.weight, particles.mask)


def host_pose(x: float, y: float, theta: float) -> SE2:
    """A 0-d SE2 on the host from float components (float32)."""
    return SE2.from_xytheta(float(x), float(y), float(theta), device="cpu")


def init_state(generator: torch.Generator | int, states: SE2, params: AmclParams,
               device=None) -> AmclState:
    """Filter state from ``max_particles`` initial states (amcl_core.hpp:
    131-137): unit weights and a forced first update.  ``generator`` is a
    ``torch.Generator`` on ``device`` or a seed for a new one; ``device``
    defaults to ``"cuda"``."""
    device = resolve_device(device)
    if isinstance(generator, int):
        seed = generator
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    states = tree_map(lambda t: t.to(device), states)
    particles = make_from_states(states)
    if particles.capacity != params.max_particles:
        raise ValueError(
            f"need exactly max_particles={params.max_particles} initial states, "
            f"got {particles.capacity}"
        )
    identity = host_pose(0.0, 0.0, 0.0)
    return AmclState(
        particles=particles,
        generator=generator,
        thrun=ThrunState.init(device),
        resample_count=0,
        motion_latest=identity,
        motion_seeded=False,
        control_prev=identity,
        control_seeded=False,
        force_update=True,
    )


def reinit_particles(state: AmclState, states: SE2) -> AmclState:
    """Replace the particle set (re-initialization, global relocation),
    keep the odometry memory, and schedule a forced update."""
    device = state.particles.log_weight.device
    states = tree_map(lambda t: t.to(device), states)
    return state._replace(particles=make_from_states(states), force_update=True)


def se2_motion_delta(prev: SE2, pose: SE2):
    """(translation, |rotation|) of the relative motion (on_motion.hpp:
    63-76), in float32 in the reference's operation order."""
    delta = prev.inverse() @ pose
    dist = torch.sqrt(delta.x * delta.x + delta.y * delta.y)
    return dist, torch.abs(delta.theta)


def _on_motion(params: AmclParams, latest: SE2, seeded: bool, pose: SE2):
    dist, angle = se2_motion_delta(latest, pose)
    moved = (not seeded) or bool(dist > params.update_min_d) or bool(
        angle > params.update_min_a
    )
    return moved, (pose if moved else latest)


def update(
    params: AmclParams,
    models: AmclModels,
    ctx: Any,
    state: AmclState,
    odom_pose: SE2,
    points: Tensor,
    beam_mask: Tensor,
    draws: UpdateDraws | None = None,
) -> tuple[AmclState, Estimate]:
    """One filter update.

    Args:
      ctx: map and model context forwarded to the model functions.
      odom_pose: base pose in the odom frame, a 0-d SE2 on the host.
      points: ``f32[B, 2]`` measurement points in the base frame, on the
        particles' device; beam_mask: ``bool[B]``.
      draws: the update's random draws; ``None`` draws them from
        ``state.generator``.
    """
    moved, motion_latest = _on_motion(
        params, state.motion_latest, state.motion_seeded, odom_pose
    )
    state = state._replace(motion_latest=motion_latest, motion_seeded=True)
    if not (moved or state.force_update):
        mean, cov = models.estimate(params, state.particles)
        return state, Estimate(mean, cov, False)

    gen = state.generator
    particles = state.particles
    n, m = particles.capacity, params.max_particles
    dev = particles.log_weight.device
    prev_pose = state.control_prev if state.control_seeded else odom_pose

    # -- propagate | reweight | normalize -----------------------------------
    if draws is None:
        z = torch.randn((3, n), generator=gen, dtype=torch.float32, device=dev)
    else:
        z = draws.motion_normals
    new_states = models.propagate(ctx, z, particles.state, odom_pose, prev_pose)
    log_lik = models.log_weight(ctx, new_states, points, beam_mask)
    log_w = torch.where(particles.mask, particles.log_weight + log_lik, DEAD_LOG_WEIGHT)
    particles = normalize(ParticleSet(new_states, log_w, particles.active))

    # -- Thrun recovery probability (post-normalize, amcl_core.hpp:179) -----
    avg_weight = 1.0 / torch.clamp_min(particles.active.float(), 1.0)
    thrun, p_random = thrun_update(state.thrun, params.alpha_slow, params.alpha_fast, avg_weight)

    # -- resample policy: every_n [&& ESS drop] -----------------------------
    resample_count = (state.resample_count + 1) % params.resample_interval
    do_resample = resample_count == 0
    if do_resample and params.selective_resampling:
        ess = effective_sample_size(particles)
        do_resample = bool(ess < 0.5 * particles.active.float())  # one readback

    if do_resample:
        # reset the estimator after injecting randomness (amcl_core.hpp:184-186)
        fresh = ThrunState.init(dev)
        thrun = tree_map(lambda a, b: torch.where(p_random > 0.0, a, b), fresh, thrun)
        adaptive = params.min_particles < params.max_particles
        weights = particles.weight
        if params.resampling == "multinomial":
            # sorted order statistics, interleaved slot order: the exact
            # multinomial donor multiset (pallas_resample.py:548-574)
            positions = (sorted_multinomial_positions(gen, m) if draws is None
                         else draws.positions)
            donors = resample_take_tree_multinomial(
                gen, weights, particles.state, m, positions=positions
            )
        else:
            positions = (POSITIONERS[params.resampling](gen, m) if draws is None
                         else draws.positions)
            donors = resample_take_tree(weights, positions, particles.state)
            if adaptive:
                # CDF-ordered donors: spread them so any slot prefix (the
                # KLD active prefix) covers the whole CDF
                donors = tree_map(interleave_slots, donors)
        if draws is None:
            inject_u = torch.rand((m,), generator=gen, dtype=torch.float32, device=dev)
            randoms = models.random_state(ctx, gen, m, particles)
        else:
            inject_u, randoms = draws.inject_uniform, draws.random_states
        candidates = tree_where(inject_u < p_random, randoms, donors)
        if adaptive:
            active = kld_active_count(
                models.hash_state(params, candidates), params.min_particles, m,
                params.kld_epsilon, params.kld_z,
            )
        else:
            # take_while_kld's `count <= min` clause keeps all of them
            active = m
        particles = make_from_states(candidates, active=active)

    mean, cov = models.estimate(params, particles)
    new_state = state._replace(
        particles=particles,
        thrun=thrun,
        resample_count=resample_count,
        control_prev=odom_pose,
        control_seeded=True,
        force_update=False,
    )
    return new_state, Estimate(mean, cov, True)

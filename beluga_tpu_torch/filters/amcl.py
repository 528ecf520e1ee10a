"""Adaptive Monte Carlo Localization, one update (port of
``beluga_tpu/filters/amcl.py``; ``beluga::Amcl``, amcl_core.hpp:81-233).

The update order, gates and parity quirks are the reference's: the
on-motion policy updates its pose memory before the force-update check;
the control window advances only on updates that pass the gate; the Thrun
estimator sees the post-normalize average weight; it resets when a
resample fires while the random-state probability is > 0; resampled
particles restart with weight 1; ``every_n`` counts gated-in updates.

One update body serves one filter and a fleet (port of
``parallel/fleet.py:make_fleet_update``, which ``vmap``s this update): every
stage takes leading filter axes and reduces over the particle axis only.
:func:`step` runs that body with the particle-axis steps of a
:class:`ParticleOps` table: :data:`DENSE` here, collectives over ranks in
``parallel/mega.py`` for a particle axis split across them.
Where the JAX package branches with ``lax.cond``, the port decides on the
host without reading the particles back:

* the motion gate uses only the odometry, which the caller holds on the
  host (SE2, or SE3 for the 3D filters, whose model table names
  :func:`se3_motion_delta`); the delta is computed in float32 in the
  reference's operation order, so a move right at ``update_min_d`` gates
  the same way;
* ``force_update``, the ``every_n`` counter and the theta-sort schedule are
  host values (numpy ``[B]`` in a fleet);
* the ESS gate of ``selective_resampling`` (off at nav2 defaults) reads
  one value back per gated-in update of one filter; in a fleet it is a
  device ``bool[B]`` select with no readback;
* the KLD active count stays a device tensor.

Under ``vmap`` JAX's gates become selects; so in a fleet the port skips a
stage when no filter is due, runs it for every filter otherwise, and
``torch.where``-selects per filter: a gated-out filter keeps its
particles, Thrun state, counters and control window bit for bit.

Resampling always takes the accelerator branch of the reference
(amcl.py:369-423): positions, then kernel B2 (ops/cuda_resample.py), on
the CPU through its plain version; residual resampling is two passes of
B2, the floor copies and then the residual draws.  Random draws come from
the state's ``torch.Generator`` (one for a whole fleet, drawing ``[B, ...]``), which
the update advances in place, or from ``draws`` (:class:`UpdateDraws`),
which lets a test feed the reference's own draws.  With
``recovery_pool`` the injection draws a binomial count and ``pool`` target
slots instead of one uniform per slot (amcl.py:436-458).  A model table
with ``fused_propagate_reweight`` (the windowed mega filter's kernel B5)
replaces the separate propagate and reweight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.algorithms.estimation import estimate_se2_log
from beluga_tpu_torch.algorithms.kld import kld_active_count
from beluga_tpu_torch.algorithms.thrun import ThrunState, thrun_update
from beluga_tpu_torch.core.particles import (
    DEAD_LOG_WEIGHT,
    ParticleSet,
    make_from_states,
    tree_map,
    tree_scatter,
    tree_sort_by,
    tree_where,
)
from beluga_tpu_torch.core.random import sample_normal_se2
from beluga_tpu_torch.core.weights import effective_sample_size, normalize
from beluga_tpu_torch.lie import SE2, SE3
from beluga_tpu_torch.ops import cuda_sort
from beluga_tpu_torch.ops.cuda_resample import (
    resample_take_tree,
    resample_take_tree_multinomial,
    resample_take_tree_residual,
)
from beluga_tpu_torch.ops.resample import (
    POSITIONERS,
    interleave_slots,
    sorted_multinomial_positions,
)
from beluga_tpu_torch.ops.spatial_hash import spatial_hash_se2
from beluga_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

RESAMPLING = (*POSITIONERS, "residual")


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
    # reference default (views/sample.hpp); also systematic, stratified,
    # residual
    resampling: str = "multinomial"
    # recovery-injection pool: 0 draws max_particles random states per
    # resample; K > 0 draws K and scatters the first n_inj ~ Binomial(m, p),
    # clamped to K, onto uniform slots (amcl.py:80-87, 436-458)
    recovery_pool: int = 0
    # keep slots in theta order (strays last, se2_sort_key); with a fixed
    # count the multinomial resampler then keeps donors in CDF order
    sorted_slots: bool = False
    # re-sort on every sort_interval-th resample (fixed counts only)
    sort_interval: int = 1

    def __post_init__(self):
        if self.resampling not in RESAMPLING:
            raise ValueError(
                f"unknown resampling {self.resampling!r}; expected one of {RESAMPLING}"
            )
        if self.sort_interval > 1 and self.min_particles < self.max_particles:
            raise ValueError(
                "sort_interval > 1 requires a fixed particle count "
                "(min_particles == max_particles): adaptive KLD relies on "
                "the per-resample sort for the kept-first live prefix"
            )


class AmclModels(NamedTuple):
    """Model functions; each takes the opaque ``ctx`` dict.

    Each takes and returns leading filter axes ``[...]`` where it is given
    them.

    propagate:    (ctx, z f32[..., 3, N], states, pose, prev_pose) -> states,
                  with ``z`` the standard normals of the motion sample
    log_weight:   (ctx, states, points, beam_mask) -> f32[..., N]
    random_state: (ctx, generator, n, particles) -> ``[..., n]`` states
                  (recovery), with the filter axes of ``particles``
    hash_state:   (params, states) -> int64[..., N] spatial hashes (KLD buckets)
    estimate:     (params, particles) -> (mean pose, covariance)
    fused_propagate_reweight: (ctx, z, states, pose, prev_pose, points,
                  beam_mask) -> (states, log_lik) in place of propagate +
                  log_weight (the windowed mega filter's kernel B5); ``None``
                  keeps them separate
    sort_key:     (states) -> f32[..., N] slot-sort key of ``sorted_slots``
                  filters; ``None`` selects :func:`se2_sort_key`
    motion_delta: (prev_pose, pose) -> (distance, angle) of the on-motion
                  gate, on the host; ``None`` selects :func:`se2_motion_delta`
                  (on_motion.hpp:63-76; the SE3 filters take
                  :func:`se3_motion_delta`, :115-134)
    """

    propagate: Callable
    log_weight: Callable
    random_state: Callable
    hash_state: Callable
    estimate: Callable
    fused_propagate_reweight: Callable | None = None
    sort_key: Callable | None = None
    motion_delta: Callable | None = None


class AmclState(NamedTuple):
    """Filter state.  Particles and the Thrun filters live on the device;
    the odometry memory and the gates live on the host: Python scalars and
    0-d poses for one filter, numpy arrays and poses ``[B]`` for a fleet."""

    particles: ParticleSet
    generator: torch.Generator
    thrun: ThrunState
    resample_count: Any  # every_n internal counter
    motion_latest: Any  # on-motion policy memory (host SE2 or SE3)
    motion_seeded: Any
    control_prev: Any  # previous odometry of the control window (host)
    control_seeded: Any
    force_update: Any


class Estimate(NamedTuple):
    pose: Any  # SE2, or SE3 for the 3D filters
    covariance: Tensor  # f32[..., 3, 3], or f32[..., 6, 6] for SE3
    valid: Any  # False when the update was gated out (numpy bool[B] in a fleet)


class UpdateDraws(NamedTuple):
    """Every random draw of one update, in place of the generator's, with
    the state's filter axes ``[...]`` first: ``motion_normals``
    f32[..., 3, N]; ``positions`` f32[..., M] for the resampler (residual
    resampling reads ``residual_uniforms`` f32[..., M + 1] instead, the
    spacings of its residual draws);
    ``inject_uniform`` f32[..., M] (slot m is replaced by a recovery state
    when it is below the random-state probability); ``random_states`` the
    ``[..., M]`` recovery states.  With a ``recovery_pool`` P instead:
    ``random_states`` the ``[..., P]`` pool, ``inject_count`` f32[...] the
    binomial count before the clamp to P, ``inject_slots`` int[..., P] the
    target slots; ``inject_uniform`` is not read."""

    motion_normals: Tensor
    positions: Tensor
    inject_uniform: Tensor | None
    random_states: Any
    inject_count: Tensor | None = None
    inject_slots: Tensor | None = None
    residual_uniforms: Tensor | None = None


def draw_update(params: AmclParams, models: AmclModels, ctx: Any, particles: ParticleSet,
                generator: torch.Generator, p_random=0.01) -> UpdateDraws:
    """Every draw of one update of ``particles`` (one filter or a fleet)
    from ``generator``, in the update's own order, as :class:`UpdateDraws`:
    for feeding two updates (the dense one and the sharded one of
    ``parallel/mega.py``) the same draws.  A pooled injection's binomial
    count is drawn with ``p_random`` (a float, or ``f32[...]``), which the
    update itself would take from its Thrun filters."""
    lead = tuple(particles.log_weight.shape[:-1])
    m, dev = params.max_particles, particles.log_weight.device
    z = torch.randn((*lead, 3, particles.capacity), generator=generator, dtype=torch.float32,
                    device=dev)
    drawn = _draw_positions(params, generator, lead, dev)
    p = torch.as_tensor(p_random, dtype=torch.float32, device=dev).expand(lead).contiguous()
    randoms, count, slots, inject_u = _draw_injection(models, ctx, generator, particles, p, m,
                                                      params.recovery_pool)
    residual = params.resampling == "residual"
    return UpdateDraws(z, None if residual else drawn, inject_u, randoms, count, slots,
                       drawn if residual else None)


def _draw_positions(params: AmclParams, gen: torch.Generator, lead: tuple, dev) -> Tensor:
    """The resampler's draws for ``max_particles`` slots: the positions, or
    residual resampling's ``m + 1`` uniforms."""
    m = params.max_particles
    if params.resampling == "multinomial":
        return sorted_multinomial_positions(gen, m, lead)
    if params.resampling == "residual":
        return torch.rand((*lead, m + 1), generator=gen, dtype=torch.float32, device=dev)
    return POSITIONERS[params.resampling](gen, m, lead)


def _draw_injection(models: AmclModels, ctx: Any, gen: torch.Generator,
                    particles: ParticleSet, p_random: Tensor, n: int, pool: int):
    """The injection's draws for ``n`` slots, as ``(random_states,
    inject_count, inject_slots, inject_uniform)`` of :class:`UpdateDraws`:
    with a ``pool`` below ``n`` the pool, the binomial count and the target
    slots, else a recovery state and a uniform for every slot."""
    lead, dev = tuple(particles.log_weight.shape[:-1]), particles.log_weight.device
    if pool and pool < n:
        randoms = models.random_state(ctx, gen, pool, particles)
        count = torch.binomial(torch.full_like(p_random, float(n)), p_random, generator=gen)
        slots = torch.randint(0, n, (*lead, pool), generator=gen, device=dev)
        return randoms, count, slots, None
    inject_u = torch.rand((*lead, n), generator=gen, dtype=torch.float32, device=dev)
    return models.random_state(ctx, gen, n, particles), None, None, inject_u


def se2_sort_key(states: SE2) -> Tensor:
    """Slot-sort key of ``sorted_slots`` SE2 filters (amcl.py:179-201):
    theta, plus 100 for stray particles beyond 3.5 sigma of their filter's
    cloud in x, y or heading-chord distance, so that strays pool at the
    end.  The deviations are population ones (``jnp.std``'s ddof 0)."""

    def mean(v):
        return torch.mean(v, dim=-1, keepdim=True)

    def std(v):
        return torch.std(v, dim=-1, correction=0, keepdim=True)

    x, y, c, s = states.x, states.y, states.rot.cos, states.rot.sin
    zx = torch.abs(x - mean(x)) / (std(x) + 1e-6)
    zy = torch.abs(y - mean(y)) / (std(y) + 1e-6)
    rc = torch.hypot(c - mean(c), s - mean(s))
    zt = (rc - mean(rc)) / (std(rc) + 1e-6)
    stray = (zx > 3.5) | (zy > 3.5) | (zt > 3.5)
    return states.theta + 100.0 * stray.to(torch.float32)


def default_hash_state(params: AmclParams, states: SE2) -> Tensor:
    return spatial_hash_se2(
        states.xy, states.theta, params.spatial_resolution_x,
        params.spatial_resolution_theta, res_y=params.spatial_resolution_y,
    )


def default_estimate(params: AmclParams, particles: ParticleSet):
    del params
    return estimate_se2_log(particles.state, particles.log_weight, particles.active)


def host_pose(x: float, y: float, theta: float) -> SE2:
    """A 0-d SE2 on the host from float components (float32)."""
    return SE2.from_xytheta(float(x), float(y), float(theta), device="cpu")


def _host(a):
    """A host gate value: a Python scalar for one filter, else the array."""
    return a.item() if np.ndim(a) == 0 else a


def _generator(generator: torch.Generator | int, device) -> torch.Generator:
    if isinstance(generator, int):
        seed, generator = generator, torch.Generator(device=device)
        generator.manual_seed(seed)
    return generator


def init_state(generator: torch.Generator | int, states, params: AmclParams,
               device=None, odom_identity=None) -> AmclState:
    """Filter state from ``max_particles`` initial states (amcl_core.hpp:
    131-137): unit weights and a forced first update.  ``states`` shaped
    ``[N]`` make one filter, ``[B, N]`` a fleet of B.  ``generator`` is a
    ``torch.Generator`` on ``device`` or a seed for a new one; ``device``
    defaults to ``"cuda"``.  ``odom_identity`` sets the odometry pose type
    (default SE2; ``SE3.identity()`` for the 3D filters): the odometry
    memory starts at that type's identity, one per filter."""
    device = resolve_device(device)
    generator = _generator(generator, device)
    states = tree_map(lambda t: t.to(device), states)
    lead = tuple(states.shape[:-1])
    particles = make_from_states(states, batch_dims=len(lead))
    if particles.capacity != params.max_particles:
        raise ValueError(
            f"need exactly max_particles={params.max_particles} initial states, "
            f"got {particles.capacity}"
        )
    pose_type = SE2 if odom_identity is None else type(odom_identity)
    identity = pose_type.identity(lead, device="cpu")
    return AmclState(
        particles=particles,
        generator=generator,
        thrun=ThrunState.init(device, lead),
        resample_count=_host(np.zeros(lead, np.int64)),
        motion_latest=identity,
        motion_seeded=_host(np.zeros(lead, bool)),
        control_prev=identity,
        control_seeded=_host(np.zeros(lead, bool)),
        force_update=_host(np.ones(lead, bool)),
    )


def init_fleet_state(generator: torch.Generator | int, batch: int, mean: SE2, cov,
                     params: AmclParams, device=None) -> AmclState:
    """A fleet of ``batch`` filters, each from its own normal cloud of
    ``max_particles`` states about ``mean`` (3x3 ``cov`` over x, y, theta),
    taken in theta order when ``sorted_slots`` (bench.py:193-210)."""
    device = resolve_device(device)
    generator = _generator(generator, device)
    states = sample_normal_se2(generator, params.max_particles, mean, cov, lead=(batch,))
    if params.sorted_slots:
        states = tree_sort_by(states.theta, states)
    return init_state(generator, states, params, device)


def reinit_particles(state: AmclState, states: SE2) -> AmclState:
    """Replace the particle set of one filter (re-initialization, global
    relocation), keep the odometry memory, and schedule a forced update."""
    device = state.particles.log_weight.device
    states = tree_map(lambda t: t.to(device), states)
    return state._replace(particles=make_from_states(states), force_update=True)


def se2_motion_delta(prev: SE2, pose: SE2):
    """(translation, |rotation|) of the relative motion (on_motion.hpp:
    63-76), in float32 in the reference's operation order."""
    delta = prev.inverse() @ pose
    dist = torch.sqrt(delta.x * delta.x + delta.y * delta.y)
    return dist, torch.abs(delta.theta)


def se3_motion_delta(prev: SE3, pose: SE3):
    """(translation, rotation angle) of the relative SE3 motion
    (on_motion.hpp:115-134), in float32."""
    delta = prev.inverse() @ pose
    w = delta.rot.log()
    angle = torch.sqrt(torch.sum(w * w, dim=-1))
    return torch.sqrt(torch.sum(delta.xyz * delta.xyz, dim=-1)), angle


def _on_motion(params: AmclParams, models: AmclModels, latest, seeded, pose):
    """``(moved, new pose memory)``; ``moved`` a numpy bool per filter."""
    dist, angle = (models.motion_delta or se2_motion_delta)(latest, pose)
    moved = ~np.asarray(seeded) | (
        (dist > params.update_min_d) | (angle > params.update_min_a)
    ).numpy()
    return moved, tree_where(torch.as_tensor(moved), pose, latest)


def _select(mask: Tensor, a: ParticleSet, b: ParticleSet) -> ParticleSet:
    """``a`` for the filters where ``mask`` (device ``bool[B]``), else ``b``."""
    return ParticleSet(
        tree_where(mask, a.state, b.state),
        torch.where(mask[..., None], a.log_weight, b.log_weight),
        torch.where(mask, a.active, b.active),
    )


def update(
    params: AmclParams,
    models: AmclModels,
    ctx: Any,
    state: AmclState,
    odom_pose: SE2,
    points: Tensor,
    beam_mask: Tensor,
    draws: UpdateDraws | None = None,
    sort_now: bool | None = None,
) -> tuple[AmclState, Estimate]:
    """One update of one filter, or of a fleet of B filters.

    Args:
      ctx: map and model context forwarded to the model functions.
      state: from :func:`init_state`; its particles' filter axes ``[...]``
        (none, or ``[B]``) shape every other argument.
      odom_pose: base pose in the odom frame, an SE2 (SE3 for the 3D
        filters) ``[...]`` on the host.
      points: ``f32[..., nb, 2]`` measurement points in the base frame, on
        the particles' device; beam_mask: ``bool[..., nb]``.
      draws: the update's random draws; ``None`` draws them from
        ``state.generator``.
      sort_now: override of the ``sorted_slots`` sort schedule: ``True``
        sorts, ``False`` does not, ``None`` follows ``sort_interval``.
    """
    return step(DENSE, params, models, ctx, state, odom_pose, points, beam_mask, draws,
                sort_now)


def step(ops: "ParticleOps", params: AmclParams, models: AmclModels, ctx: Any,
         state: AmclState, odom_pose, points: Tensor, beam_mask: Tensor,
         draws: UpdateDraws | None = None,
         sort_now: bool | None = None) -> tuple[AmclState, Estimate]:
    """:func:`update` with the particle-axis steps of ``ops``: :data:`DENSE`,
    or the sharded update's (``parallel/mega.py``).

    While a ``torch.profiler`` records, the update marks its stages as
    ranges ``amcl.<stage>`` inside ``amcl.update``, and each call that
    makes the host wait for the card as ``sync.<site>``
    (:func:`~beluga_tpu_torch.utils.profiling.span`)."""
    with span("amcl.update"):
        with span("amcl.gate"):
            moved, motion_latest = _on_motion(
                params, models, state.motion_latest, state.motion_seeded, odom_pose
            )
            due = moved | np.asarray(state.force_update)
        state = state._replace(motion_latest=motion_latest,
                               motion_seeded=_host(np.ones_like(due)))
        if due.all():
            state = _gated_in(ops, params, models, ctx, state, odom_pose, points, beam_mask,
                              draws, sort_now)
        elif due.any():
            # filters that gate apart: step them all, keep the gated-out ones
            new = _gated_in(ops, params, models, ctx, state, odom_pose, points, beam_mask,
                            draws, sort_now)
            with span("amcl.select"):
                with span("sync.gate_keep"):
                    keep = torch.as_tensor(due, device=state.particles.log_weight.device)
                state = new._replace(
                    particles=_select(keep, new.particles, state.particles),
                    thrun=tree_where(keep, new.thrun, state.thrun),
                    resample_count=np.where(due, new.resample_count, state.resample_count),
                    control_prev=tree_where(torch.as_tensor(due), odom_pose, state.control_prev),
                    control_seeded=state.control_seeded | due,
                    force_update=state.force_update & ~due,
                )
        with span("amcl.estimate"):
            mean, cov = ops.estimate(params, models, state.particles)
    return state, Estimate(mean, cov, _host(due))


def _gated_in(ops: "ParticleOps", params: AmclParams, models: AmclModels, ctx: Any,
              state: AmclState,
              odom_pose: SE2, points: Tensor, beam_mask: Tensor,
              draws: UpdateDraws | None, sort_now: bool | None) -> AmclState:
    """The update of every filter of ``state`` (amcl.py:314-536)."""
    gen = state.generator
    particles = state.particles
    lead = tuple(particles.log_weight.shape[:-1])
    n = particles.capacity
    dev = particles.log_weight.device
    fused = models.fused_propagate_reweight

    # -- propagate | reweight | normalize -----------------------------------
    with span("amcl.propagate_reweight" if fused else "amcl.propagate"):
        prev_pose = tree_where(torch.as_tensor(np.asarray(state.control_seeded)),
                               state.control_prev, odom_pose)
        if draws is None:
            z = torch.randn((*lead, 3, n), generator=ops.slot_generator(gen),
                            dtype=torch.float32, device=dev)
        else:
            z = draws.motion_normals
        if fused is not None:
            new_states, log_lik = fused(ctx, z, particles.state, odom_pose, prev_pose, points,
                                        beam_mask)
        else:
            new_states = models.propagate(ctx, z, particles.state, odom_pose, prev_pose)
    with span("amcl.reweight"):
        if fused is None:
            log_lik = models.log_weight(ctx, new_states, points, beam_mask)
        log_w = torch.where(ops.mask(particles), particles.log_weight + log_lik, DEAD_LOG_WEIGHT)
    with span("amcl.normalize"):
        particles = ops.normalize(ParticleSet(new_states, log_w, particles.active))

        # -- Thrun recovery probability (post-normalize, amcl_core.hpp:179) -
        avg_weight = 1.0 / torch.clamp_min(particles.active.float(), 1.0)
        thrun, p_random = thrun_update(state.thrun, params.alpha_slow, params.alpha_fast,
                                       avg_weight)

        # -- resample policy: every_n [&& ESS drop] -------------------------
        # the counter cycles over resample_interval * sort_interval so that it
        # drives both the resample and the theta-sort schedule (amcl.py:344-349)
        modulus = params.resample_interval * max(params.sort_interval, 1)
        resample_count = (np.asarray(state.resample_count) + 1) % modulus
        do_resample = resample_count % params.resample_interval == 0
        select = None  # device bool[B] of the filters that resample; None: all
        if do_resample.any() and params.selective_resampling:
            ess_low = ops.ess(particles) < 0.5 * particles.active.float()
            if lead:
                with span("sync.resample_select"):
                    select = torch.as_tensor(do_resample, device=dev) & ess_low
            else:
                with span("sync.ess_gate"):
                    do_resample = np.asarray(bool(ess_low))  # one readback
        elif not do_resample.all():
            with span("sync.resample_select"):
                select = torch.as_tensor(do_resample, device=dev)

    if do_resample.any():
        with span("amcl.resample"):
            resampled = ops.resample(params, models, ctx, gen, particles, p_random, draws)
            # reset the estimator after injecting randomness (amcl_core.hpp:184-186)
            fresh = ThrunState.init(dev, lead)
            thrun_r = tree_map(lambda a, b: torch.where(p_random > 0.0, a, b), fresh, thrun)
        if select is None:
            particles, thrun = resampled, thrun_r
        else:
            with span("amcl.select"):
                particles = _select(select, resampled, particles)
                thrun = tree_where(select, thrun_r, thrun)

    if params.sorted_slots and sort_now is not False:
        # keep the theta-sorted slot invariant on the sort schedule, outside
        # the resample branch (amcl.py:486-524); the schedule is a host
        # value per filter, as vmap makes the reference's cond a select
        if sort_now is None and (params.sort_interval > 1 or params.selective_resampling
                                 or params.resample_interval > 1):
            sort_due = resample_count == 0
        else:
            sort_due = np.ones(lead, bool)
        if sort_due.all():
            with span("amcl.sort"):
                particles = ops.sort_slots(models, particles)
        elif sort_due.any():
            with span("sync.sort_select"):
                keep = torch.as_tensor(sort_due, device=dev)
            with span("amcl.sort"):
                sorted_particles = ops.sort_slots(models, particles)
            with span("amcl.select"):
                particles = _select(keep, sorted_particles, particles)

    return state._replace(
        particles=particles,
        thrun=thrun,
        resample_count=_host(resample_count),
        control_prev=odom_pose,
        control_seeded=_host(np.ones(lead, bool)),
        force_update=_host(np.zeros(lead, bool)),
    )


def _resample(params: AmclParams, models: AmclModels, ctx: Any, gen: torch.Generator,
              particles: ParticleSet, p_random: Tensor,
              draws: UpdateDraws | None) -> ParticleSet:
    """The resample branch for every filter (amcl.py:354-477)."""
    lead = tuple(particles.log_weight.shape[:-1])
    m = params.max_particles
    dev = particles.log_weight.device
    adaptive = params.min_particles < params.max_particles
    weights = particles.weight
    if draws is None:
        positions = _draw_positions(params, gen, lead, dev)
    else:
        positions = (draws.residual_uniforms if params.resampling == "residual"
                     else draws.positions)
    if params.resampling == "multinomial":
        # sorted order statistics: the exact multinomial donor multiset
        # (pallas_resample.py:548-574), interleaved unless the slots keep
        # theta order with a fixed count; adaptive KLD needs the unbiased
        # prefix the interleave gives (amcl.py:414-417)
        donors = resample_take_tree_multinomial(
            gen, weights, particles.state, m, positions=positions,
            interleave=adaptive or not params.sorted_slots,
        )
    else:
        if params.resampling == "residual":
            # floor copies, then the residual draws: two passes of B2
            # (amcl.py:369-397)
            donors = resample_take_tree_residual(weights, particles.state, positions)
        else:
            donors = resample_take_tree(weights, positions, particles.state)
        if adaptive:
            # CDF-ordered donors: spread them so any slot prefix (the KLD
            # active prefix) covers the whole CDF
            donors = tree_map(lambda leaf: interleave_slots(leaf, axis=len(lead)), donors)
    candidates, active = inject_and_count(params, models, ctx, gen, particles, donors,
                                          p_random, draws, m, params.recovery_pool)
    return make_from_states(candidates, active=active, batch_dims=len(lead))


def inject_and_count(params: AmclParams, models: AmclModels, ctx: Any, gen: torch.Generator,
                     particles: ParticleSet, donors: Any, p_random: Tensor,
                     draws: UpdateDraws | None, n: int, pool: int,
                     gather: Callable | None = None) -> tuple[Any, Tensor]:
    """The resample's tail over the ``n`` slots of ``donors`` (the whole
    filter, or one rank's slice of it): the recovery injection, then the
    KLD count; ``(candidates, active)``.  ``gather`` (identity by default)
    puts the slices of every rank together along the particle axis, so
    that every rank counts the same hashes."""
    lead = tuple(particles.log_weight.shape[:-1])
    dev = particles.log_weight.device
    with span("amcl.recovery"):
        if draws is None:
            randoms, count, slots, inject_u = _draw_injection(models, ctx, gen, particles,
                                                              p_random, n, pool)
        else:
            randoms, count, slots, inject_u = (draws.random_states, draws.inject_count,
                                               draws.inject_slots, draws.inject_uniform)
        if pool and pool < n:
            # bounded pool: n_inj ~ Binomial(n, p), clamped to the pool, entries
            # at iid uniform slots; colliding targets keep the last of their entries
            n_inj = torch.clamp_max(count.to(dev), float(pool))
            target = torch.where(torch.arange(pool, device=dev) < n_inj[..., None],
                                 slots.to(dev), n)  # n: dropped
            candidates = tree_scatter(donors, target, randoms)
        else:
            candidates = tree_where(inject_u < p_random[..., None], randoms, donors)
    m = params.max_particles
    if params.min_particles < m:
        # KLD on the candidates in draw/CDF order, before any theta sort
        # (take_while_kld.hpp:72-88)
        with span("amcl.kld"):
            hashes = models.hash_state(params, candidates)
            active = kld_active_count(hashes if gather is None else gather(hashes),
                                      params.min_particles, m, params.kld_epsilon,
                                      params.kld_z)
    else:
        # take_while_kld's `count <= min` clause keeps all of them
        active = torch.full(lead, m, dtype=torch.int32, device=dev)
    return candidates, active


def sort_slots(models: AmclModels, particles: ParticleSet) -> ParticleSet:
    """Theta-sort the slots: log-weights travel with their states, slots
    past the live prefix sort last (``inf`` keys) so the prefix holds.  On
    the card, the default key on float32 SE2 filters of at most 4096 slots
    is kernel S1's one launch (``ops/cuda_sort.py``); every other call is
    :func:`plain_sort_slots`."""
    if models.sort_key is None and cuda_sort.takes(particles.state):
        state, log_w = cuda_sort.sort_slots_se2(particles.state, particles.log_weight,
                                                particles.active)
        return ParticleSet(state, log_w, particles.active)
    return plain_sort_slots(models, particles, particles.mask)


def plain_sort_slots(models: AmclModels, particles: ParticleSet, mask: Tensor) -> ParticleSet:
    """Theta-sort the slots by the model's key (``se2_sort_key`` by
    default), dead slots (``~mask``) last with ``inf`` keys, in one stable
    sort of the states and log-weights."""
    key_fn = models.sort_key or se2_sort_key
    keys = torch.where(mask, key_fn(particles.state), torch.inf)
    state, log_w = tree_sort_by(keys, (particles.state, particles.log_weight))
    return ParticleSet(state, log_w, particles.active)


class ParticleOps(NamedTuple):
    """The steps of :func:`step` that see the whole particle axis, or draw
    per slot: :data:`DENSE` reduces over the particle tensor, the sharded
    update (``parallel/mega.py``) over the ranks that hold its slices."""

    mask: Callable  # (particles) -> bool[..., N] of the live slots
    normalize: Callable  # (particles) -> particles
    ess: Callable  # (particles) -> f32[...]
    resample: Callable  # as _resample; ``gen`` is the state's generator
    sort_slots: Callable  # (models, particles) -> particles
    estimate: Callable  # (params, models, particles) -> (mean, covariance)
    slot_generator: Callable  # (state.generator) -> the motion normals' generator


DENSE = ParticleOps(
    mask=lambda particles: particles.mask,
    normalize=normalize,
    ess=effective_sample_size,
    resample=_resample,
    sort_slots=sort_slots,
    estimate=lambda params, models, particles: models.estimate(params, particles),
    slot_generator=lambda gen: gen,
)

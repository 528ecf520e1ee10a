"""One AMCL filter whose particle axis is split across ranks (port of
``beluga_tpu/parallel/mega.py``).

Each rank of the ``axis`` group of a ``torch.distributed`` device mesh
holds ``N_local = N / S`` slots of the filter (rank ``s`` the global slots
``[s·N_local, (s+1)·N_local)``) and runs the dense update's flow
(``filters/amcl.py:step``) with its particle-axis steps replaced:

  propagate   local: the model's ``propagate`` and ``log_weight`` (B1 or
              B4), or ``fused_propagate_reweight`` (B5) over the rank's slots
  normalize   logsumexp by ``all_reduce(MAX)`` and ``all_reduce(SUM)``
  ESS         ``all_reduce(SUM)`` of the squared weights; the selective gate
              reads that one value back, the same bits on every rank, so
              every rank takes the same branch
  resample    the weights ``f32[..., N]`` and the packed states are
              all-gathered, and kernel B2 (``ops/cuda_resample.py``) searches
              the positions of this rank's slots in the global CDF and copies
              their donors, the JAX package's TPU branch (``:269-296``);
              positions that are not ascending (the interleaved ranks of
              adaptive KLD) are sorted for B2 and the rows put back
  injection   the recovery pool split into ``max(pool // S, 8)`` entries a
              rank (B3's draw entry), a binomial count a rank, local slots
  KLD         the hashes all-gathered; ``algorithms/kld.py`` on ``[..., N]``
              on every rank gives every rank the same count
  sort        ``sorted_slots`` sorts each rank's slots alone (``:361-396``)
  estimate    the weighted SE2 moments by ``all_reduce(SUM)``

Draws come from two generators (:class:`ShardGenerators`): the rank's own,
seeded from ``(seed, rank)``, for the motion normals, the injection and
the per-rank positions (stratified, multinomial), and a shared one, the
same on every rank and advanced the same way, for what the JAX package
draws once for all shards (systematic's ``u0``, residual's uniforms).
Given the same :class:`UpdateDraws` (see :func:`shard_draws`), the update
at world size 1 is bit-equal to the dense one; at S > 1 its sums are
associated by rank, so its weights may differ in the last bits and a
position within a few ulp of a CDF edge may take the neighbouring donor.
Multinomial resampling draws each rank's own sorted order statistics and
interleaves them within the rank, so that any prefix of the global slots
is unbiased.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from beluga_tpu_torch.algorithms.estimation import se2_from_moments
from beluga_tpu_torch.core.particles import DEAD_LOG_WEIGHT, ParticleSet, tree_map
from beluga_tpu_torch.filters.amcl import (
    AmclModels,
    AmclParams,
    AmclState,
    ParticleOps,
    UpdateDraws,
    inject_and_count,
    sort_slots,
    step,
)
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.ops.cuda_resample import (
    pack_state,
    residual_positions,
    resample_take,
    unpack_state,
)
from beluga_tpu_torch.ops.resample import (
    interleave_ranks,
    interleave_slots,
    sorted_multinomial_positions,
)
from beluga_tpu_torch.parallel.collectives import (
    all_gather_last,
    all_reduce,
    sharded_effective_sample_size,
    sharded_normalize,
)
from beluga_tpu_torch.parallel.placement import (
    ShardGenerators,
    axis_size,
    place,
    shard_generators,
    state_sharding,
)

Tensor = torch.Tensor

_BELOW_ONE = 1.0 - 2.0**-24


def all_gather_states(states: Any, group, batch_dims: int = 0) -> Any:
    """Every leaf of a state tree all-gathered along its particle axis (the
    axis after ``batch_dims`` filter axes), in rank order, contiguous."""

    def gather(leaf: Tensor) -> Tensor:
        whole = all_gather_last(leaf.movedim(batch_dims, -1), group)
        return whole.movedim(-1, batch_dims).contiguous()

    return tree_map(gather, states)


def sharded_estimate_se2(states: SE2, weights: Tensor, group):
    """Weighted SE2 mean and covariance (estimation.hpp:436-475, as
    ``algorithms/estimation.py:estimate_se2``) of the slices of every rank:
    ``weights`` ``[..., N_local]`` zero on dead slots; three
    ``all_reduce(SUM)``s (the total weight, the first moments with Σw², the
    translation covariance)."""
    w = weights.float()
    w = w / torch.clamp_min(all_reduce(torch.sum(w, dim=-1), group), 1e-38)[..., None]
    moments = all_reduce(torch.cat([
        torch.sum(w * w, dim=-1)[..., None],
        torch.sum(w[..., None] * states.xy, dim=-2),
        torch.sum(w[..., None] * states.rot.z, dim=-2),
    ], dim=-1), group)
    corr = torch.clamp_min(1.0 - moments[..., 0], 1e-9)
    mean_xy = moments[..., 1:3]
    centered = states.xy - mean_xy[..., None, :]
    cov_t = all_reduce((centered.transpose(-1, -2) * w[..., None, :]) @ centered, group)
    return se2_from_moments(mean_xy, moments[..., 3:5], cov_t / corr[..., None, None])


class _Slots:
    """This rank's global slots and the ranks its slots draw at, on one
    device: ``ranks`` are the global slots, or their interleave when an
    adaptive count resamples by CDF order; ``order`` sorts them (``None``
    when they ascend) and ``inverse`` undoes that sort."""

    def __init__(self, device, shard: int, n_local: int, m: int, interleave: bool):
        self.global_slots = torch.arange(shard * n_local, (shard + 1) * n_local, device=device)
        self.ranks = (interleave_ranks(self.global_slots, m) if interleave
                      else self.global_slots)
        self.ranks_f = self.ranks.to(torch.float32)
        self.order = self.inverse = None
        if interleave:
            self.order = torch.argsort(self.ranks)
            self.inverse = torch.argsort(self.order)

    def take(self, weights: Tensor, positions: Tensor, planes: Tensor) -> Tensor:
        """Kernel B2's donor rows ``[..., N_local, D]`` of the positions of
        this rank's slots, searched in ``weights`` ``[..., N]``."""
        if self.order is None:
            return resample_take(weights, positions.contiguous(), planes)
        rows = resample_take(weights, positions.index_select(-1, self.order).contiguous(),
                             planes)
        return rows.index_select(-2, self.inverse)


def _mega_ops(params: AmclParams, group, shard: int, shards: int, estimate_fn) -> ParticleOps:
    m = params.max_particles
    n_local = m // shards
    adaptive = params.min_particles < params.max_particles
    pool = params.recovery_pool
    pool_local = max(pool // shards, 8) if pool else 0
    interleave = adaptive and params.resampling != "multinomial"

    @functools.lru_cache(maxsize=None)
    def slots(device) -> _Slots:
        return _Slots(device, shard, n_local, m, interleave)

    def mask(particles: ParticleSet) -> Tensor:
        return slots(particles.log_weight.device).global_slots < particles.active[..., None]

    def normalize(particles: ParticleSet) -> ParticleSet:
        return particles.replace(
            log_weight=sharded_normalize(particles.log_weight, mask(particles), group))

    def ess(particles: ParticleSet) -> Tensor:
        return sharded_effective_sample_size(particles.log_weight, mask(particles), group)

    def weights(particles: ParticleSet) -> Tensor:
        return torch.where(mask(particles), torch.exp(particles.log_weight), 0.0)

    def gather(t: Tensor) -> Tensor:
        return all_gather_last(t, group)

    def resample(params, models, ctx, gens: ShardGenerators, particles: ParticleSet,
                 p_random: Tensor, draws: UpdateDraws | None):
        lead = tuple(particles.log_weight.shape[:-1])
        dev = particles.log_weight.device
        at = slots(dev)
        w = weights(particles)
        packed, like = pack_state(particles.state, len(lead))
        all_w = gather(w)  # [..., N]
        planes = gather(packed)  # [..., D, N]
        if params.resampling == "multinomial":
            positions = (sorted_multinomial_positions(gens.rank, n_local, lead)
                         if draws is None else draws.positions)
            rows = resample_take(all_w, positions.contiguous(), planes)
            if adaptive or not params.sorted_slots:
                rows = interleave_slots(rows, axis=len(lead))
        elif params.resampling == "residual":
            # floor copies at the global ranks below the all-reduced r0, then
            # the residual draws (amcl.py:369-397)
            u = (torch.rand((*lead, m + 1), generator=gens.shared, dtype=torch.float32,
                            device=dev) if draws is None else draws.residual_uniforms)
            counts, u_det, residual, u_res, det = residual_positions(
                w, u, at.ranks, lambda t: all_reduce(t, group))
            rows = torch.where(det[..., None], at.take(gather(counts), u_det, planes),
                               at.take(gather(residual), u_res, planes))
        else:
            if draws is not None:  # the positions of every global slot
                positions = draws.positions.index_select(-1, at.ranks)
            elif params.resampling == "systematic":
                u0 = torch.rand(lead, generator=gens.shared, dtype=torch.float32, device=dev)
                positions = torch.clamp_max((at.ranks_f + u0[..., None]) / m, _BELOW_ONE)
            else:  # stratified
                u = torch.rand((*lead, n_local), generator=gens.rank, dtype=torch.float32,
                               device=dev)
                positions = torch.clamp_max((at.ranks_f + u) / m, _BELOW_ONE)
            rows = at.take(all_w, positions, planes)
        candidates, active = inject_and_count(params, models, ctx, gens.rank, particles,
                                              unpack_state(rows, like), p_random, draws,
                                              n_local, pool_local, gather)
        log_w = torch.where(at.global_slots < active[..., None], 0.0, DEAD_LOG_WEIGHT)
        return ParticleSet(candidates, log_w.to(torch.float32), active)

    return ParticleOps(
        mask=mask,
        normalize=normalize,
        ess=ess,
        resample=resample,
        sort_slots=lambda models, particles: sort_slots(models, particles, mask(particles)),
        estimate=lambda params, models, particles: estimate_fn(
            particles.state, weights(particles), group),
        slot_generator=lambda gens: gens.rank,
    )


def make_mega_update(params: AmclParams, models: AmclModels, mesh, axis: str = "tp",
                     estimate_fn=None):
    """The AMCL update of one filter (or a fleet ``[B_local, ...]``) whose
    particle axis is split over the ``axis`` dimension of ``mesh`` (a
    ``torch.distributed`` ``DeviceMesh``).

    Returns ``update(ctx, state, odom_pose, points, beam_mask, draws=None,
    sort_now=None) -> (state, Estimate)``, to be called by every rank of the
    group with the same host arguments; ``state`` from
    :func:`shard_mega_state`, its particle leaves this rank's
    ``[..., N_local]`` slice, its ``active`` count global.  Every strategy of
    ``AmclParams.resampling`` is supported, and ``sorted_slots`` with its
    ``sort_interval`` / ``sort_now`` schedule (a rank-local sort).

    ``estimate_fn(states, weights, group) -> (pose, covariance)`` must
    reduce with collectives over the group; the default is
    :func:`sharded_estimate_se2`.
    """
    shards = axis_size(mesh, axis)
    if params.max_particles % shards:
        raise ValueError(f"max_particles={params.max_particles} must divide into the "
                         f"{shards} ranks of axis {axis!r}")
    ops = _mega_ops(params, mesh.get_group(axis), mesh.get_local_rank(axis), shards,
                    estimate_fn or sharded_estimate_se2)

    def update(ctx, state: AmclState, odom_pose, points: Tensor, beam_mask: Tensor,
               draws: UpdateDraws | None = None, sort_now: bool | None = None):
        if not isinstance(state.generator, ShardGenerators):
            raise TypeError("the state's generator is not a ShardGenerators: "
                            "place the state with shard_mega_state or shard_fleet")
        return step(ops, params, models, ctx, state, odom_pose, points, beam_mask, draws,
                    sort_now)

    return update


def shard_mega_state(mesh, state: AmclState, axis: str = "tp") -> AmclState:
    """Each rank's part of a filter's state (``init_state`` of the whole
    filter, the same on every rank or at least on mesh coordinate ``(0,
    ...)``, whose bits every rank takes): its ``[..., N_local]`` slice of the
    particles, the rest whole, and its :class:`ShardGenerators`."""
    if axis != "tp":
        raise ValueError("the particle axis is the mesh dimension 'tp'")
    if len(mesh.mesh_dim_names) != 1:
        raise ValueError("a mega filter's mesh has the one dimension 'tp'; "
                         "shard a fleet with parallel.fleet.shard_fleet")
    placed = place(state, state_sharding(mesh, state), mesh)
    return placed._replace(generator=shard_generators(mesh, state.generator, True, axis))


def shard_draws(draws: UpdateDraws, params: AmclParams, mesh) -> UpdateDraws:
    """This rank's part of the draws of the dense update of the whole
    filter (or fleet): the motion normals, the injection uniforms and the
    recovery states of its slots (and of its filters, where the mesh has a
    ``"dp"`` dimension); the systematic or stratified positions of every
    global slot and residual's uniforms whole (each rank reads those of its
    ranks); multinomial's sorted positions cut into this rank's run, which
    the sharded update takes as the rank's own order statistics.  A pooled
    injection's draws are the rank's own: they are passed whole at one rank
    along ``"tp"`` and refused past it."""
    names = mesh.mesh_dim_names
    tp = axis_size(mesh, "tp") if "tp" in names else 1
    at = mesh.get_local_rank("tp") if "tp" in names else 0
    lead = draws.motion_normals.dim() - 2
    n_local = params.max_particles // tp

    def slots(x, axis):
        if x is None:
            return None
        return x.narrow(axis, at * n_local, n_local).contiguous()

    def filters(x):
        if x is None or "dp" not in names or not lead:
            return x
        size, i = axis_size(mesh, "dp"), mesh.get_local_rank("dp")
        b = x.shape[0] // size
        return x[i * b:(i + 1) * b].contiguous()

    pooled = bool(params.recovery_pool) and max(params.recovery_pool // tp, 8) < n_local
    if pooled and tp > 1:
        raise ValueError("a pooled injection draws its count and slots on each rank; "
                         "the dense draws cannot be split")
    positions = draws.positions
    if positions is not None and params.resampling == "multinomial":
        positions = slots(positions, -1)
    random_states = draws.random_states
    if not pooled:
        random_states = tree_map(lambda leaf: slots(leaf, lead), random_states)
    out = UpdateDraws(
        motion_normals=slots(draws.motion_normals, -1),
        positions=positions,
        inject_uniform=slots(draws.inject_uniform, -1),
        random_states=random_states,
        inject_count=draws.inject_count,
        inject_slots=draws.inject_slots,
        residual_uniforms=draws.residual_uniforms,
    )
    return UpdateDraws(*(tree_map(filters, x) if x is not None else None for x in out))

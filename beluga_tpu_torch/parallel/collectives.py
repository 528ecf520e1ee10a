"""Collectives over a particle axis split across ranks (port of
``beluga_tpu/parallel/collectives.py``).

The JAX package writes these inside ``shard_map`` with a named axis; here
each rank is a process of a ``torch.distributed`` group (``nccl`` on the
card, ``gloo`` on CPU ranks) and holds the ``[..., N_local]`` slice of the
particle arrays, any leading filter axes first.  Every function takes the
group, and every rank of it must call the function, in the same order: a
collective that one rank skips hangs the others.  Nothing is skipped at
world size 1, where the collectives are no-ops of the backend.

Rank ``s`` of the group owns the global slots ``[s·N_local, (s+1)·N_local)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from beluga_tpu_torch.core.particles import DEAD_LOG_WEIGHT
from beluga_tpu_torch.ops.cuda_resample import running_sum

Tensor = torch.Tensor

# ``all_gather_into_tensor`` is deprecated in favour of ``all_gather_single``
# where the installed torch has it
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_last(x: Tensor, group) -> Tensor:
    """``x`` ``[..., L]`` of every rank, concatenated along the last axis in
    rank order: ``[..., S·L]``."""
    world = dist.get_world_size(group)
    out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
    _gather_into(out, x.contiguous().reshape(-1), group=group)
    out = out.view(world, *x.shape)
    return out.movedim(0, -2).reshape(*x.shape[:-1], world * x.shape[-1])


def all_reduce(x: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    """``op`` over the group's ranks of ``x`` (a new tensor; ``x`` is left
    as it was)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def sharded_logsumexp(log_w: Tensor, mask: Tensor, group) -> Tensor:
    """Global logsumexp of the masked log-weights ``[..., N_local]``: the
    local maximum, ``all_reduce(MAX)``, the local masked sum of
    ``exp(log_w - max)``, ``all_reduce(SUM)``, in
    ``core/weights.py:masked_logsumexp``'s order; ``[...]``, the same on
    every rank."""
    masked = torch.where(mask, log_w, DEAD_LOG_WEIGHT)
    m = all_reduce(torch.amax(masked, dim=-1), group, dist.ReduceOp.MAX)
    m = torch.clamp_min(m, DEAD_LOG_WEIGHT)[..., None]
    s = all_reduce(torch.sum(torch.where(mask, torch.exp(masked - m), 0.0), dim=-1), group)
    return m.squeeze(-1) + torch.log(torch.clamp_min(s, 1e-38))


def sharded_normalize(log_w: Tensor, mask: Tensor, group) -> Tensor:
    """Log-weights shifted by the global total; dead slots keep
    ``DEAD_LOG_WEIGHT``."""
    total = sharded_logsumexp(log_w, mask, group)
    return torch.where(mask, log_w - total[..., None], DEAD_LOG_WEIGHT)


def sharded_effective_sample_size(log_w: Tensor, mask: Tensor, group) -> Tensor:
    """Global ESS ``1 / Σ ŵ²`` over the normalized weights of every rank."""
    w = torch.where(mask, torch.exp(sharded_normalize(log_w, mask, group)), 0.0)
    sq = all_reduce(torch.sum(w * w, dim=-1), group)
    return 1.0 / torch.clamp_min(sq, 1e-38)


def sharded_cdf(weights: Tensor, group) -> tuple[Tensor, Tensor]:
    """``(local_cdf, offset)`` of the global CDF of ``weights``
    ``[..., N_local]``: the local cumulative sum and the exclusive sum of
    the totals of the ranks before this one (from an all-gather of the
    totals), both divided by the global total, so that ``local_cdf +
    offset[..., None]`` is this rank's part of the normalized global CDF.
    The local sums are B2's CDF kernel without its division on the card
    (the same bits every call), ``cumsum`` on CPU ranks."""
    local = running_sum(weights.float().contiguous())
    totals = all_gather_last(local[..., -1:], group)  # [..., S]
    rank = dist.get_rank(group)
    offset = torch.sum(totals[..., :rank], dim=-1)
    grand = torch.clamp_min(torch.sum(totals, dim=-1), 1e-38)
    return local / grand[..., None], offset / grand


def sharded_systematic_resample(u0: Tensor, weights: Tensor, group) -> tuple[Tensor, Tensor]:
    """Systematic resampling of a particle vector split across the group:
    this rank's output slots ``j`` take the positions ``(j + u0) / N`` of
    their global slots, searched in the all-gathered global CDF.

    ``u0`` (f32 ``[...]``) must be bitwise the same on every rank: draw it
    from a generator that every rank holds in the same state.  Returns
    ``(global donor index, donor's rank)``, int64 ``[..., N_local]``.
    """
    n_local = weights.shape[-1]
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    total = n_local * world
    local_cdf, offset = sharded_cdf(weights, group)
    all_cdf = all_gather_last(local_cdf + offset[..., None], group)
    slots = torch.arange(rank * n_local, (rank + 1) * n_local, dtype=torch.float32,
                         device=weights.device)
    u = (slots + u0[..., None]) / total
    u = u.expand(*all_cdf.shape[:-1], n_local).contiguous()
    gidx = torch.clamp(torch.searchsorted(all_cdf.contiguous(), u, right=True), 0, total - 1)
    return gidx, gidx // n_local


def sharded_mean(values: Tensor, weights: Tensor, group) -> Tensor:
    """Globally weighted mean ``[..., D]`` of per-particle vectors
    ``[..., N_local, D]``."""
    w = weights.float()
    num = all_reduce(torch.sum(w[..., None] * values, dim=-2), group)
    den = all_reduce(torch.sum(w, dim=-1), group)
    return num / torch.clamp_min(den, 1e-38)[..., None]

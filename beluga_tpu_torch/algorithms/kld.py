"""KLD-sampling adaptive particle count with static shapes (port of
``beluga_tpu/algorithms/kld.py``).

``take_while_kld`` (views/take_while_kld.hpp:72-137) keeps candidates while
``count <= min`` or ``count <= target(distinct buckets so far)`` and caps
at ``max``.  Here all candidates exist up front: the distinct-bucket prefix
count comes from a stable sort of the hashes, and the active count is the
index of the first candidate that breaks the condition.  It stays a device
tensor.  Hashes may carry leading filter axes ``[..., M]``: each filter
gets its own count.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def distinct_prefix_count(hashes: Tensor) -> Tensor:
    """``K[..., i]`` = number of distinct values among ``hashes[..., : i + 1]``;
    the sort form (kld.py:36-42), which works at any M."""
    order = torch.argsort(hashes, dim=-1, stable=True)
    sorted_h = torch.take_along_dim(hashes, order, dim=-1)
    is_leader = torch.ones(hashes.shape, dtype=torch.bool, device=hashes.device)
    is_leader[..., 1:] = sorted_h[..., 1:] != sorted_h[..., :-1]
    first_occurrence = torch.zeros_like(is_leader).scatter_(-1, order, is_leader)
    return torch.cumsum(first_occurrence.to(torch.int32), dim=-1, dtype=torch.int32)


def kld_target_size(k: Tensor, epsilon: float, z: float) -> Tensor:
    """Chi-squared target count for ``k`` occupied buckets; f32, inf for
    ``k <= 2`` (take_while_kld.hpp:73-81)."""
    kf = k.to(torch.float32)
    km1 = torch.clamp_min(kf - 1.0, 1.0)
    common = 2.0 / (9.0 * km1)
    base = 1.0 - common + torch.sqrt(common) * z
    result = torch.ceil((km1 / (2.0 * epsilon)) * (base * base * base))
    return torch.where(k <= 2, float("inf"), result)


def kld_active_count(
    hashes: Tensor, min_particles: int, max_particles: int, epsilon: float, z: float
) -> Tensor:
    """Number of candidates the sequential take-while keeps; int32 ``[...]``
    (0-d for one filter)."""
    m = hashes.shape[-1]
    k = distinct_prefix_count(hashes)
    count = torch.arange(1, m + 1, dtype=torch.float32, device=hashes.device)
    keep = (count <= min_particles) | (count <= kld_target_size(k, epsilon, z))
    stop = ~keep
    first_stop = torch.argmax(stop.to(torch.uint8), dim=-1)
    n = torch.where(stop.any(dim=-1), first_stop, m)
    return torch.clamp_max(n, max_particles).to(torch.int32)

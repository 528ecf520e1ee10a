"""Log-space weight bookkeeping (port of ``beluga_tpu/core/weights.py``).

``normalize`` is ``beluga::actions::normalize`` (normalize.hpp:54-84) as a
log-space shift; ``effective_sample_size`` is 1 / Σ ŵ²
(effective_sample_size.hpp:46).
"""

from __future__ import annotations

import torch

from beluga_tpu_torch.core.particles import DEAD_LOG_WEIGHT, ParticleSet

Tensor = torch.Tensor


def masked_logsumexp(log_w: Tensor, mask: Tensor, dim: int = -1) -> Tensor:
    """logsumexp over alive slots only; safe when everything is masked."""
    neg = torch.tensor(DEAD_LOG_WEIGHT, dtype=log_w.dtype, device=log_w.device)
    masked = torch.where(mask, log_w, neg)
    m = torch.amax(masked, dim=dim, keepdim=True)
    m = torch.maximum(m, neg)
    s = torch.sum(torch.where(mask, torch.exp(masked - m), 0.0), dim=dim)
    return m.squeeze(dim) + torch.log(torch.clamp_min(s, 1e-38))


def normalize(particles: ParticleSet) -> ParticleSet:
    """Divide weights by their sum (log-space shift); dead slots keep
    ``DEAD_LOG_WEIGHT``."""
    mask = particles.mask
    total = masked_logsumexp(particles.log_weight, mask)
    new_log_w = torch.where(mask, particles.log_weight - total, DEAD_LOG_WEIGHT)
    return particles.replace(log_weight=new_log_w)


def normalized_weights(particles: ParticleSet) -> Tensor:
    """Linear weights summing to one over alive slots."""
    mask = particles.mask
    total = masked_logsumexp(particles.log_weight, mask)
    return torch.where(mask, torch.exp(particles.log_weight - total), 0.0)


def effective_sample_size(particles: ParticleSet) -> Tensor:
    """ESS = 1 / Σ ŵ² (algorithm/effective_sample_size.hpp:46)."""
    w = normalized_weights(particles)
    return 1.0 / torch.clamp_min(torch.sum(w * w), 1e-38)

"""Weighted SE2 mean and covariance (port of the SE2 part of
``beluga_tpu/algorithms/estimation.py``, estimation.hpp:436-475).

Coefficient average of (cos, sin, x, y); translation covariance with the
``1 / (1 - Σw²)`` correction; yaw variance ``-2 log |mean complex|``; the
all-cancelled case gives yaw 0 with infinite variance.  Weights are
normalized here, as ``beluga::estimate`` does.
"""

from __future__ import annotations

import torch

from beluga_tpu_torch.lie import SE2, SO2

Tensor = torch.Tensor


def _normalize_weights(weights: Tensor, mask: Tensor | None) -> Tensor:
    w = weights.float()
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    return w / torch.clamp_min(torch.sum(w), 1e-38)


def estimate_se2(states: SE2, weights: Tensor, mask: Tensor | None = None):
    """``(SE2 mean, f32[3, 3] covariance)`` over (x, y, yaw)."""
    w = _normalize_weights(weights, mask)
    corr = torch.clamp_min(1.0 - torch.sum(w * w), 1e-9)

    mean_xy = torch.sum(w[:, None] * states.xy, dim=0)
    mean_z = torch.sum(w[:, None] * states.rot.z, dim=0)  # unnormalized complex

    centered = states.xy - mean_xy
    cov_t = (centered.T * w) @ centered / corr

    norm = torch.sqrt(mean_z[0] * mean_z[0] + mean_z[1] * mean_z[1])
    degenerate = norm < 1e-7
    yaw_var = torch.where(
        degenerate, float("inf"), -2.0 * torch.log(torch.clamp_min(norm, 1e-38))
    )
    # built from ops: a tensor literal on the card would be a blocking copy
    identity_z = torch.stack([torch.ones_like(norm), torch.zeros_like(norm)])
    mean_rot = SO2(torch.where(degenerate, identity_z, mean_z / torch.clamp_min(norm, 1e-38)))

    cov = torch.zeros((3, 3), dtype=torch.float32, device=w.device)
    cov[:2, :2] = cov_t
    cov[2, 2] = yaw_var
    return SE2(mean_xy, mean_rot), cov

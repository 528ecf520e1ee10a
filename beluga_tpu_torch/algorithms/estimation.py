"""Weighted means and covariances of scalars, vectors, SE2 and SE3 states
(port of ``beluga_tpu/algorithms/estimation.py``).

Scalars and vectors (estimation.hpp:230-307): the weighted mean and the
covariance with the ``1 / (1 - Σw²)`` correction.

SE2 (estimation.hpp:436-475): coefficient average of (cos, sin, x, y);
translation covariance with the ``1 / (1 - Σw²)`` correction; yaw variance
``-2 log |mean complex|``; the all-cancelled case gives yaw 0 with
infinite variance.  SE3 (estimation.hpp:319-358): the translation
average, the chordal quaternion mean (the eigenvector of the largest
eigenvalue of ``Σ w q qᵀ``, signed to w >= 0) and the covariance of
``log(mean⁻¹ · state)`` in the tangent space, with the same correction.
Weights are normalized here, as ``beluga::estimate`` does.  States and
weights may carry leading filter axes; each filter gets its own estimate.
"""

from __future__ import annotations

import torch

from beluga_tpu_torch.lie import SE2, SE3, SO2, SO3

Tensor = torch.Tensor


def _normalize_weights(weights: Tensor, mask: Tensor | None) -> Tensor:
    w = weights.float()
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    return w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-38)


def estimate_scalar(values: Tensor, weights: Tensor, mask: Tensor | None = None):
    """Weighted mean and bias-corrected variance of ``f32[..., N]`` values."""
    w = _normalize_weights(weights, mask)
    mean = torch.sum(w * values, dim=-1)
    sq_sum = torch.sum(w * w, dim=-1)
    d = values - mean[..., None]
    var = torch.sum(w * (d * d), dim=-1) / torch.clamp_min(1.0 - sq_sum, 1e-9)
    return mean, var


def estimate_vector(values: Tensor, weights: Tensor, mask: Tensor | None = None):
    """Weighted mean ``[..., D]`` and covariance ``[..., D, D]`` of
    ``f32[..., N, D]`` vectors."""
    w = _normalize_weights(weights, mask)
    mean = torch.sum(w[..., None] * values, dim=-2)
    centered = values - mean[..., None, :]
    sq_sum = torch.sum(w * w, dim=-1)
    cov = (centered.transpose(-1, -2) * w[..., None, :]) @ centered
    return mean, cov / torch.clamp_min(1.0 - sq_sum, 1e-9)[..., None, None]


def estimate_se2(states: SE2, weights: Tensor, mask: Tensor | None = None):
    """``(SE2 mean [...], f32[..., 3, 3] covariance)`` over (x, y, yaw)."""
    w = _normalize_weights(weights, mask)
    corr = torch.clamp_min(1.0 - torch.sum(w * w, dim=-1), 1e-9)

    mean_xy = torch.sum(w[..., None] * states.xy, dim=-2)
    mean_z = torch.sum(w[..., None] * states.rot.z, dim=-2)  # unnormalized complex

    centered = states.xy - mean_xy[..., None, :]
    cov_t = (centered.transpose(-1, -2) * w[..., None, :]) @ centered / corr[..., None, None]
    return se2_from_moments(mean_xy, mean_z, cov_t)


def se2_from_moments(mean_xy: Tensor, mean_z: Tensor, cov_t: Tensor):
    """The SE2 estimate from its weighted moments: the mean translation
    ``[..., 2]``, the unnormalized mean complex ``[..., 2]`` and the
    corrected translation covariance ``[..., 2, 2]``."""
    norm = torch.sqrt(mean_z[..., 0] * mean_z[..., 0] + mean_z[..., 1] * mean_z[..., 1])
    degenerate = norm < 1e-7
    yaw_var = torch.where(
        degenerate, float("inf"), -2.0 * torch.log(torch.clamp_min(norm, 1e-38))
    )
    # built from ops: a tensor literal on the card would be a blocking copy
    identity_z = torch.stack([torch.ones_like(norm), torch.zeros_like(norm)], dim=-1)
    mean_rot = SO2(torch.where(degenerate[..., None], identity_z,
                               mean_z / torch.clamp_min(norm, 1e-38)[..., None]))

    cov = torch.zeros((*norm.shape, 3, 3), dtype=torch.float32, device=norm.device)
    cov[..., :2, :2] = cov_t
    cov[..., 2, 2] = yaw_var
    return SE2(mean_xy, mean_rot), cov


def estimate_se3(states: SE3, weights: Tensor, mask: Tensor | None = None):
    """``(SE3 mean [...], f32[..., 6, 6] covariance)``, the covariance over
    the tangent (vx, vy, vz, wx, wy, wz).

    ``eigh`` returns an eigenvector of either sign; the flip to w >= 0
    makes the mean unique unless the largest eigenvalue is degenerate
    (particles spread evenly between two rotations), where any unit vector
    of its eigenspace is a mean and the two packages may pick different
    ones."""
    w = _normalize_weights(weights, mask)
    corr = torch.clamp_min(1.0 - torch.sum(w * w, dim=-1), 1e-9)
    mean_xyz = torch.sum(w[..., None] * states.xyz, dim=-2)
    q = states.rot.q
    m = (q * w[..., None]).transpose(-1, -2) @ q  # Σ w q qᵀ, [..., 4, 4]
    _, vecs = torch.linalg.eigh(m)
    mean_q = vecs[..., :, -1]
    mean_q = mean_q * torch.where(mean_q[..., :1] < 0, -1.0, 1.0)
    mean = SE3(mean_xyz, SO3.from_quat_wxyz(mean_q))
    lead = mean_xyz.shape[:-1]
    inv = mean.inverse()
    inv = SE3(inv.xyz[..., None, :], SO3(inv.rot.q[..., None, :]))
    delta = (inv @ states).log()  # [..., N, 6]
    cov = (delta * w[..., None]).transpose(-1, -2) @ delta / corr.reshape(*lead, 1, 1)
    return mean, cov

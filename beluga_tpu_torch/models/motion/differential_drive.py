"""Sampled differential-drive odometry model, Thrun table 5.6 (port of
``beluga_tpu/models/motion/differential_drive.py``).

The rot1 - translate - rot2 decomposition and its noise scales come from
the odometry delta once per update (differential_drive_model.hpp:129-155),
on whatever device the poses are on (the host, in the filter).  The
sampler takes its standard normals ``z[3, N]`` as an input and perturbs
every particle (differential_drive_model.hpp:156-163).  SE3 states take
the flattened-3D variant: states and controls are projected on the plane,
sampled in 2D and embedded again at z = 0 (differential_drive_model.hpp:
122-127).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from beluga_tpu_torch.lie import SE2, SE3, SO2, to_2d, to_3d
from beluga_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DifferentialDriveParams:
    """alpha1..alpha4 noise parameters (differential_drive_model.hpp:40-68)."""

    rotation_noise_from_rotation: float = 0.2  # alpha1
    rotation_noise_from_translation: float = 0.2  # alpha2
    translation_noise_from_translation: float = 0.2  # alpha3
    translation_noise_from_rotation: float = 0.2  # alpha4
    distance_threshold: float = 0.01


def _wrap(theta: Tensor) -> Tensor:
    return SO2.exp(theta).log()


def _rotation_variance(theta: Tensor) -> Tensor:
    """Symmetric forward/backward rotation noise ``min(|θ|, |θ ± π|)²``
    (differential_drive_model.hpp:167-173)."""
    delta = torch.minimum(torch.abs(theta), torch.abs(_wrap(theta + math.pi)))
    return delta * delta


def diff_drive_decompose(params: DifferentialDriveParams, pose: SE2, previous_pose: SE2):
    """The three ``(mean, stddev)`` pairs of rot1 / translation / rot2 as
    0-d float32 tensors on the poses' device."""
    translation = pose.xy - previous_pose.xy
    distance = torch.sqrt(translation[..., 0] * translation[..., 0]
                          + translation[..., 1] * translation[..., 1])
    distance_variance = distance * distance

    heading = torch.atan2(translation[..., 1], translation[..., 0])
    first_rotation = torch.where(
        distance > params.distance_threshold,
        _wrap(heading - previous_pose.theta),
        0.0,
    )
    second_rotation = _wrap(pose.theta - previous_pose.theta - first_rotation)

    rv1 = _rotation_variance(first_rotation)
    rv2 = _rotation_variance(second_rotation)

    first_std = torch.sqrt(
        params.rotation_noise_from_rotation * rv1
        + params.rotation_noise_from_translation * distance_variance
    )
    trans_std = torch.sqrt(
        params.translation_noise_from_translation * distance_variance
        + params.translation_noise_from_rotation * (rv1 + rv2)
    )
    second_std = torch.sqrt(
        params.rotation_noise_from_rotation * rv2
        + params.rotation_noise_from_translation * distance_variance
    )
    return (first_rotation, first_std), (distance, trans_std), (second_rotation, second_std)


def diff_drive_propagate(
    params: DifferentialDriveParams, z: Tensor, states: SE2, pose: SE2, previous_pose: SE2
) -> SE2:
    """New states ``state * SE2(rot1, 0) * SE2(rot2, (trans, 0))`` for every
    particle, from the standard normals ``z`` f32[..., 3, N].  The poses may
    live on the host: 0-d poses enter the particle arithmetic as scalars,
    and the six coefficients of batched poses ``[B]`` cross to the
    particles' device in one copy."""
    (r1_mu, r1_sd), (t_mu, t_sd), (r2_mu, r2_sd) = diff_drive_decompose(
        params, pose, previous_pose
    )
    if r1_mu.dim() > 0:
        coef = torch.stack([r1_mu, r1_sd, t_mu, t_sd, r2_mu, r2_sd])
        with span("sync.motion_coefficients"):  # a pageable copy: the stream drains
            coef = coef.to(z.device)[..., None]
        r1_mu, r1_sd, t_mu, t_sd, r2_mu, r2_sd = coef.unbind(0)
    rot1 = r1_mu + r1_sd * z[..., 0, :]
    trans = t_mu + t_sd * z[..., 1, :]
    rot2 = r2_mu + r2_sd * z[..., 2, :]

    theta1 = states.theta + rot1
    new_xy = states.xy + torch.stack([torch.cos(theta1) * trans, torch.sin(theta1) * trans], -1)
    return SE2(new_xy, SO2.exp(theta1 + rot2))


def diff_drive_propagate_3d(
    params: DifferentialDriveParams, z: Tensor, states: SE3, pose: SE3, previous_pose: SE3
) -> SE3:
    """The flattened-3D sample: project states and controls on the plane,
    run :func:`diff_drive_propagate` with the normals ``z`` f32[..., 3, N],
    and embed the result at z = 0 with zero roll and pitch."""
    return to_3d(diff_drive_propagate(params, z, to_2d(states), to_2d(pose),
                                      to_2d(previous_pose)))

"""Sampled omnidirectional-drive odometry model, nav2's omni model (port of
``beluga_tpu/models/motion/omnidirectional.py``).

The differential-drive decomposition plus a strafe noise term (alpha5):
each particle moves by ``state * SE2(rot1, 0) * SE2(rot_draw - rot1,
(trans_draw, -strafe_draw))`` (omnidirectional_drive_model.hpp:101-147).
The means and noise scales come from the odometry delta once per update,
on the poses' device (the host, in the filter); the sampler takes its
standard normals ``z[..., 3, N]`` as an input, the same draws as
diff-drive (``UpdateDraws.motion_normals``).  The formulas are the
reference's as they are, ``strafe_std``'s use of alpha4 and the sign of
``strafe_draw`` included.
"""

from __future__ import annotations

import dataclasses

import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.models.motion.differential_drive import _rotation_variance, _wrap
from beluga_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OmnidirectionalDriveParams:
    """alpha1..alpha5 noise parameters (omnidirectional_drive_model.hpp:40-72)."""

    rotation_noise_from_rotation: float = 0.2  # alpha1
    rotation_noise_from_translation: float = 0.2  # alpha2
    translation_noise_from_translation: float = 0.2  # alpha3
    translation_noise_from_rotation: float = 0.2  # alpha4
    strafe_noise_from_translation: float = 0.2  # alpha5
    distance_threshold: float = 0.01


def omni_drive_decompose(params: OmnidirectionalDriveParams, pose: SE2, previous_pose: SE2):
    """``(first_rotation, rotation, rot_std, distance, trans_std,
    strafe_std)`` of the odometry delta, tensors on the poses' device."""
    translation = pose.xy - previous_pose.xy
    distance = torch.sqrt(translation[..., 0] * translation[..., 0]
                          + translation[..., 1] * translation[..., 1])
    distance_variance = distance * distance

    rotation = _wrap(pose.theta - previous_pose.theta)
    heading = torch.atan2(translation[..., 1], translation[..., 0])
    first_rotation = torch.where(
        distance > params.distance_threshold,
        _wrap(heading - previous_pose.theta),
        0.0,
    )
    rv = _rotation_variance(rotation)

    rot_std = torch.sqrt(
        params.rotation_noise_from_rotation * rv
        + params.rotation_noise_from_translation * distance_variance
    )
    trans_std = torch.sqrt(
        params.translation_noise_from_translation * distance_variance
        + params.translation_noise_from_rotation * rv
    )
    strafe_std = torch.sqrt(
        params.strafe_noise_from_translation * distance_variance
        + params.translation_noise_from_rotation * rv
    )
    return first_rotation, rotation, rot_std, distance, trans_std, strafe_std


def omni_drive_propagate(
    params: OmnidirectionalDriveParams, z: Tensor, states: SE2, pose: SE2, previous_pose: SE2
) -> SE2:
    """New states for every particle from the standard normals ``z``
    f32[..., 3, N] (omnidirectional_drive_model.hpp:133-147).  The poses
    may live on the host: 0-d poses enter the particle arithmetic as
    scalars, and the six coefficients of batched poses ``[B]`` cross to the
    particles' device in one copy."""
    coef = omni_drive_decompose(params, pose, previous_pose)
    if coef[0].dim() > 0:
        with span("sync.motion_coefficients"):  # a pageable copy: the stream drains
            coef = torch.stack(coef).to(z.device)[..., None].unbind(0)
    first_rotation, rotation, rot_std, distance, trans_std, strafe_std = coef
    rot_draw = rotation + rot_std * z[..., 0, :]
    trans_draw = distance + trans_std * z[..., 1, :]
    strafe_draw = -(strafe_std * z[..., 2, :])

    theta1 = states.theta + first_rotation
    c, s = torch.cos(theta1), torch.sin(theta1)
    dx = c * trans_draw - s * strafe_draw
    dy = s * trans_draw + c * strafe_draw
    new_xy = states.xy + torch.stack([dx, dy], dim=-1)
    # second_rotation = rot_draw - first_rotation: the final heading is
    # theta + rot_draw
    return SE2(new_xy, SO2.exp(states.theta + rot_draw))

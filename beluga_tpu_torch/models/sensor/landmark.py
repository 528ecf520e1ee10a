"""Landmark (range and bearing) and bearing-only sensor models over a
brute-force landmark map (port of ``beluga_tpu/models/sensor/landmark.py``;
landmark_sensor_model.hpp, bearing_sensor_model.hpp, data/landmark_map.hpp).

The map is a dense array of (position, category); the nearest landmark of a
detection's category is a masked ``argmin`` (the best-aligned one a masked
``argmax``) over every landmark, for every (particle, detection) pair at
once: the reference's linear scan, broadcast to ``[N, D, L]`` as the JAX
package writes it.  ``torch.argmin`` and ``torch.argmax`` return the first
extremum, as ``jnp``'s do: a detection whose category has no landmark (an
all-``inf`` row) picks index 0 and is ``found = False``.

SE2 states enter on the z = 0 plane (landmark_sensor_model.hpp:96-107),
SE3 states as they are.  The Gaussian terms divide by a device scalar, not
by a host number, so that the card divides as the CPU does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.lie import SE2, SE3, SO3, _cross, to_3d

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LandmarkModelParams:
    """(landmark_sensor_model.hpp:44-48)."""

    sigma_range: float = 1.0
    sigma_bearing: float = 1.0
    random_prob: float = 1e-4


@dataclasses.dataclass(frozen=True)
class BearingModelParams:
    """(bearing_sensor_model.hpp:42-45); the sensor pose is an argument of
    :func:`bearing_weights`."""

    sigma_bearing: float = 1.0


@dataclasses.dataclass(frozen=True)
class LandmarkMap:
    """Landmarks: world positions ``f32[L, 3]``, integer categories
    ``i32[L]``, validity ``bool[L]``."""

    positions: Tensor
    categories: Tensor
    valid: Tensor


def make_landmark_map(positions, categories, device=None) -> LandmarkMap:
    """A map of ``positions`` ``[L, 3]`` and ``categories`` ``[L]`` on
    ``device`` (default ``"cuda"``), every landmark valid."""
    dev = resolve_device(device)
    pos = torch.as_tensor(np.asarray(positions, np.float32), device=dev)
    cats = torch.as_tensor(np.asarray(categories, np.int32), device=dev)
    return LandmarkMap(pos, cats, torch.ones(pos.shape[0], dtype=torch.bool, device=dev))


def _states_to_se3(states) -> SE3:
    return to_3d(states) if isinstance(states, SE2) else states


def _rot_expand(rot: SO3, v: Tensor) -> Tensor:
    """Rotations ``[N]`` applied to vectors ``[1 or N, D, 3]``: ``[N, D, 3]``."""
    return SO3(rot.q[:, None, :]).act(v)


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _gaussian(err: Tensor, sigma: float) -> Tensor:
    """``exp(-err² / (2σ²))``, the denominator a float32 device scalar."""
    den = torch.full((), 2.0 * sigma**2, dtype=torch.float32, device=err.device)
    return torch.exp(-(err * err) / den)


def _category_ok(lmap: LandmarkMap, detection_categories: Tensor) -> Tensor:
    """``bool[1, D, L]``: landmark l is valid and of detection d's category."""
    return lmap.valid[None, None, :] & (
        lmap.categories[None, None, :] == detection_categories.to(lmap.categories.dtype)[None, :, None])


def _pick(ok: Tensor, idx: Tensor) -> Tensor:
    """``ok[..., idx]`` along the landmark axis, ``ok`` broadcast to ``idx``'s
    ``[N, D]``."""
    return torch.gather(ok.expand(*idx.shape, ok.shape[-1]), -1, idx[..., None])[..., 0]


def landmark_weights(
    params: LandmarkModelParams,
    lmap: LandmarkMap,
    states,
    detections: Tensor,
    detection_categories: Tensor,
    detection_mask: Tensor,
) -> Tensor:
    """Per-particle weights ``Π_d (p_range · p_bearing + random_prob)``
    (landmark_sensor_model.hpp:109-156), ``f32[N]``; ``detections``
    ``f32[D, 3]`` in the robot frame, each matched to the nearest landmark
    of its category (``random_prob`` alone where there is none); masked
    detections weigh 1."""
    pose = _states_to_se3(states)  # [N]
    det_range = _norm(detections)  # [D]
    det_bearing = detections / torch.clamp_min(det_range, 1e-12)[:, None]

    det_world = _rot_expand(pose.rot, detections[None, :, :]) + pose.xyz[:, None, :]
    diff = det_world[:, :, None, :] - lmap.positions[None, None, :, :]  # [N, D, L, 3]
    d2 = torch.sum(diff * diff, dim=-1)
    cat_ok = _category_ok(lmap, detection_categories)
    d2 = torch.where(cat_ok, d2, float("inf"))
    nearest = torch.argmin(d2, dim=-1)  # [N, D]
    found = _pick(cat_ok, nearest)

    lm_world = lmap.positions[nearest]  # [N, D, 3]
    inv = pose.inverse()
    lm_robot = _rot_expand(inv.rot, lm_world) + inv.xyz[:, None, :]
    lm_range = _norm(lm_robot)
    lm_bearing = lm_robot / torch.clamp_min(lm_range, 1e-12)[..., None]

    cos_ap = torch.sum(lm_bearing * det_bearing[None], dim=-1)
    sin_ap = _norm(_cross(lm_bearing, det_bearing[None].expand_as(lm_bearing)))
    bearing_error = torch.atan2(sin_ap, cos_ap)
    range_error = det_range[None] - lm_range

    p = _gaussian(range_error, params.sigma_range) * _gaussian(bearing_error,
                                                               params.sigma_bearing)
    pz = torch.where(found, p + params.random_prob,
                     torch.full_like(p, params.random_prob))
    pz = torch.where(detection_mask[None, :], pz, 1.0)
    return torch.prod(pz, dim=-1)


def bearing_weights(
    params: BearingModelParams,
    lmap: LandmarkMap,
    states,
    bearings: Tensor,
    detection_categories: Tensor,
    detection_mask: Tensor,
    sensor_pose_in_robot: SE3 | None = None,
) -> Tensor:
    """Per-particle weights ``Π_d p_bearing`` with the best-aligned landmark
    of each detection's category (bearing_sensor_model.hpp:89-141),
    ``f32[N]``; ``bearings`` ``f32[D, 3]`` in the sensor frame, the sensor
    at ``sensor_pose_in_robot`` (default the robot's frame); an unmatched
    detection weighs 0, a masked one 1."""
    pose = _states_to_se3(states)
    if sensor_pose_in_robot is not None:
        pose = pose @ sensor_pose_in_robot

    det_bearing = bearings / _norm(bearings)[:, None]

    inv = pose.inverse()
    lm_sensor = _rot_expand(inv.rot, lmap.positions[None, :, :]) + inv.xyz[:, None, :]
    lm_bearing = lm_sensor / torch.clamp_min(_norm(lm_sensor), 1e-12)[..., None]  # [N, L, 3]

    dots = torch.einsum("nlk,dk->ndl", lm_bearing, det_bearing)
    cat_ok = _category_ok(lmap, detection_categories)
    dots = torch.where(cat_ok, dots, float("-inf"))
    best = torch.argmax(dots, dim=-1)  # [N, D]
    found = _pick(cat_ok, best)

    chosen = torch.gather(lm_bearing, 1, best[..., None].expand(*best.shape, 3))  # [N, D, 3]
    cos_ap = torch.sum(chosen * det_bearing[None], dim=-1)
    sin_ap = _norm(_cross(det_bearing[None].expand_as(chosen), chosen))
    bearing_error = torch.atan2(sin_ap, cos_ap)
    # unmatched detections weigh 0 (bearing_sensor_model.hpp:116-119)
    pz = torch.where(found, _gaussian(bearing_error, params.sigma_bearing), 0.0)
    pz = torch.where(detection_mask[None, :], pz, 1.0)
    return torch.prod(pz, dim=-1)

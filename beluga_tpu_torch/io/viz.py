"""Introspection and visualization data (port of ``beluga_tpu/io/viz.py``).

The beluga_ros visualization helpers without middleware: each function
returns plain arrays for any frontend (matplotlib, an rviz bridge, web).

  * :func:`likelihood_field_as_occupancy`: a likelihood field scaled to
    0..100 int8 occupancy values (beluga_ros/likelihood_field.hpp:26-58);
  * :func:`particle_markers`: weight-scaled arrow markers, one per pose
    bucket (particle_cloud.hpp:100-314's MarkerArray, as arrays);
  * :func:`resampled_pose_array`: a fixed-size pose array drawn by weight
    (the PoseArray publisher), through kernel B2 on the card;
  * :func:`ndt_ellipsoids`: NDT cells as ellipsoids
    (beluga_ros/src/ndt_ellipsoid.cpp).
"""

from __future__ import annotations

import numpy as np
import torch

from beluga_tpu_torch.ops.cuda_resample import resample_take
from beluga_tpu_torch.ops.resample import multinomial_positions


def likelihood_field_as_occupancy(field) -> np.ndarray:
    """``int8[H, W]`` 0..100 view of a ``LikelihoodField``."""
    vals = field.values.cpu().numpy().astype(np.float64)
    vmax = vals.max() if vals.size else 1.0
    return np.clip(vals / max(vmax, 1e-12) * 100.0, 0, 100).astype(np.int8)


def particle_markers(xyt: np.ndarray, weights: np.ndarray, resolution=0.1):
    """Bucket the particles by pose; one arrow marker a bucket.

    Returns ``(poses [k, 3], scales [k])``: a scale is its bucket's total
    normalized weight (the arrow length and disc radius in the reference),
    a pose its bucket's weighted mean."""
    xyt = np.asarray(xyt, np.float64)
    w = np.asarray(weights, np.float64)
    w = w / max(w.sum(), 1e-12)
    keys = np.round(xyt / resolution).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    k = counts.shape[0]
    poses = np.zeros((k, 3))
    scales = np.zeros(k)
    np.add.at(scales, inverse, w)
    for d in range(3):
        sums = np.zeros(k)
        np.add.at(sums, inverse, xyt[:, d] * w)
        poses[:, d] = sums / np.maximum(scales, 1e-12)
    return poses, scales


def resampled_pose_array(generator: torch.Generator, xyt: torch.Tensor,
                         weights: torch.Tensor, size: int) -> torch.Tensor:
    """``size`` poses ``f32[size, 3]`` drawn with replacement by weight
    (the PoseArray publisher): iid positions from ``generator`` (on the
    poses' device), then kernel B2's donor take on the card."""
    positions = multinomial_positions(generator, size)
    return resample_take(weights.float(), positions, xyt.float().T.contiguous())


def ndt_ellipsoids(ndt_map):
    """NDT cells as ellipsoid marker data (beluga_ros/src/ndt_ellipsoid.cpp).

    Returns ``(centers [C, D], radii [C, D], rotations [C, D, D], valid
    [C])``: the eigendecomposition of each cell's covariance gives the
    principal half-axes (square roots of the eigenvalues) and a
    right-handed orientation; a cell whose covariance does not decompose
    into positive eigenvalues is invalid (the reference draws it as a
    cube)."""
    n = ndt_map.num_cells
    means = ndt_map.means.cpu().numpy().astype(np.float64)[:n]
    covs = ndt_map.covs.cpu().numpy().astype(np.float64)[:n]
    d = means.shape[1]
    radii = np.zeros((n, d))
    rots = np.zeros((n, d, d))
    valid = np.zeros(n, bool)
    for i in range(n):
        try:
            w, v = np.linalg.eigh(covs[i])
        except np.linalg.LinAlgError:
            continue
        if np.all(w > 0):
            if np.linalg.det(v) < 0:  # keep rotations right-handed
                v[:, 0] = -v[:, 0]
            radii[i] = np.sqrt(w)
            rots[i] = v
            valid[i] = True
    return means, radii, rots, valid

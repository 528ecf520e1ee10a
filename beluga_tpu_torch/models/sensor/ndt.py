"""NDT (Normal Distributions Transform) sensor model, 2D and 3D (port of
``beluga_tpu/models/sensor/ndt.py``; ``sensor/ndt_sensor_model.hpp``).

The measurement points are clustered into per-voxel Gaussians on the
device (``to_cells``, hpp:86-111: at least 5 points a cell, a minimum
variance of 1e-5, voxels by truncation ``(p / resolution).cast<int>()``).
Each particle's weight is ``1 + Σ_cells max(Σ_stencil d1·exp(-d2/2 ·
eᵀ(Σa + Σb)⁻¹e), min_likelihood)`` against the map, over a 3x3 stencil in
2D and a 7-cell one in 3D (hpp:112-147, 218-239).

Maps of more than 256 rows, and any stencil of its own, take the stencil
probe: on the card, the fused kernel of ``ops/cuda_ndt.py:ndt_weights``
computes every particle's weight in one launch, finding each probe's map
row through the map's cell index where it has one; on the CPU, its plain
version probes through B10's plain version.  Smaller maps take the dense
cross-evaluation of every (query, map cell) pair, which has no kernel.
The plain versions cut the particle axis into chunks of ``particle_chunk``
with every filter of a fleet at once, as the reference's ``lax.map`` inside
``vmap`` does, so that a 64 x 4096 fleet never holds its whole ``[B, N, C,
K]`` probe.  ``ndt_likelihood_at`` probes through kernel B10
(``ops/cuda_ndt.py:ndt_probe``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from beluga_tpu_torch.lie import SE2, SE3
from beluga_tpu_torch.maps.ndt import NdtMap, decode_keys, encode_cells
from beluga_tpu_torch.ops.cuda_ndt import (
    ndt_probe,
    ndt_weights,
    particle_chunks,
    probe_likelihood,
    world_gaussians,
)

Tensor = torch.Tensor

MIN_VARIANCE = 1e-5  # fit_points kMinVariance (ndt_sensor_model.hpp:67)
MIN_POINTS_PER_CELL = 5  # to_cells kMinPointsPerCell (hpp:90)

KERNEL_2D = np.array(
    [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 0], [0, 1], [1, -1], [1, 0], [1, 1]],
    np.int32,
)  # hpp:113-123
KERNEL_3D = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 0, -1], [0, 1, 0], [0, -1, 0], [-1, 0, 0], [1, 0, 0]],
    np.int32,
)  # hpp:126-136

# maps of at most this many rows take the dense cross-evaluation
# (models/sensor/ndt.py:106-109)
DENSE_MAX_CELLS = 256
_NO_CELL = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NdtModelParams:
    """(ndt_sensor_model.hpp:152-164)."""

    minimum_likelihood: float = 0.0
    d1: float = 1.0
    d2: float = 1.0


def _segment_sum(values: Tensor, order: Tensor, lengths: Tensor) -> Tensor:
    """Sums of ``values`` ``[..., n, ...]`` over the point axis of ``order``
    ``[..., n]`` (the points in segment order), segment ``s`` holding the
    ``lengths[..., s]`` points that come after those of the segments
    before it: ``n`` sums, one ordered pass a segment (empty ones 0), the
    same bits on every call."""
    axis = order.dim() - 1
    idx = order.reshape(order.shape + (1,) * (values.dim() - order.dim()))
    ordered = torch.take_along_dim(values, idx, dim=axis)
    return torch.segment_reduce(ordered, "sum", lengths=lengths, axis=axis, unsafe=True)


def fit_measurement_cells(points: Tensor, point_mask: Tensor, resolution: float):
    """Cluster measurement points ``f32[..., n, D]`` into per-voxel
    Gaussians (``to_cells`` + ``fit_points``, hpp:64-111).

    Returns ``(means f32[..., n, D], covs f32[..., n, D, D], cell_mask
    bool[..., n])``: n slots in ascending key order, as ``jnp.unique(size=n,
    fill_value=0xFFFFFFFF)`` gives them (masked points share the fill
    key's slot, the last live one; the slots past the distinct keys are
    padding); slots with fewer than 5 points are masked out.  The unique
    is a sort, so nothing is read back.  Voxels truncate toward zero, the
    covariance divides by count − 1 and its diagonal is floored at 1e-5.
    The segment sums add each cell's points in sort order, one pass a
    cell: another order than the reference's, but a fixed one, so equal
    clouds give equal bits on every call (the counts are exact).
    """
    n, d = points.shape[-2:]
    res = torch.full((), resolution, dtype=torch.float32, device=points.device)
    voxel = torch.trunc(points / res).to(torch.int32)
    key = torch.where(point_mask, encode_cells(voxel), _NO_CELL)
    sorted_key, order = torch.sort(key, dim=-1)
    new = torch.ones_like(sorted_key, dtype=torch.int64)
    new[..., 1:] = (sorted_key[..., 1:] != sorted_key[..., :-1]).to(torch.int64)
    seg = torch.cumsum(new, dim=-1) - 1  # each sorted point's slot
    inv = torch.empty_like(seg).scatter_(-1, order, seg)
    uniq = torch.full_like(sorted_key, _NO_CELL).scatter_(-1, seg, sorted_key)
    valid_cell = uniq != _NO_CELL
    # slot s holds the sorted points [start_s, start_{s+1}): its length
    # from the slot boundaries
    slots = torch.arange(n + 1, device=points.device).expand(*seg.shape[:-1], n + 1)
    bounds = torch.searchsorted(seg, slots.contiguous())
    lengths = bounds[..., 1:] - bounds[..., :-1]

    w = point_mask.to(torch.float32)
    count = _segment_sum(w, order, lengths)
    safe = torch.clamp_min(count, 1.0)
    mean = _segment_sum(w[..., None] * points, order, lengths) / safe[..., None]
    centered = points - torch.take_along_dim(mean, inv[..., None], dim=-2)
    outer = centered[..., :, None] * centered[..., None, :] * w[..., None, None]
    cov = (_segment_sum(outer, order, lengths)
           / torch.clamp_min(count - 1.0, 1.0)[..., None, None])
    eye = torch.eye(d, dtype=torch.float32, device=points.device)
    diag_clamped = torch.clamp_min(torch.diagonal(cov, dim1=-2, dim2=-1), MIN_VARIANCE)
    cov = cov * (1.0 - eye) + diag_clamped[..., None] * eye
    return mean, cov, valid_cell & (count >= MIN_POINTS_PER_CELL)


def _dense(ndt_map: NdtMap, kernel, d: int) -> bool:
    """Whether the dense cross-evaluation serves this map and stencil."""
    standard = np.array_equal(np.asarray(kernel), KERNEL_2D if d == 2 else KERNEL_3D)
    return standard and ndt_map.keys.shape[0] <= DENSE_MAX_CELLS


def _kernel_likelihood(ndt_map: NdtMap, params: NdtModelParams, meas_mean: Tensor,
                       meas_cov: Tensor, kernel) -> Tensor:
    """Σ over the stencil of ``d1·exp(-d2/2 · eᵀ(Σa + Σb)⁻¹e)`` per query
    Gaussian (``meas_mean`` ``f32[..., D]``, ``meas_cov`` ``f32[..., D,
    D]``); the dense form for a standard stencil on a map of at most
    :data:`DENSE_MAX_CELLS` rows (models/sensor/ndt.py:115-137)."""
    if _dense(ndt_map, kernel, meas_mean.shape[-1]):
        return _kernel_likelihood_dense(ndt_map, params, meas_mean, meas_cov)
    return probe_likelihood(ndt_map.keys, ndt_map.values, ndt_map.num_cells, ndt_map.resolution,
                            meas_mean, meas_cov, kernel, params.d1, params.d2, probe=ndt_probe)[0]


def _kernel_likelihood_dense(ndt_map: NdtMap, params: NdtModelParams, meas_mean: Tensor,
                             meas_cov: Tensor) -> Tensor:
    """Small-map form (models/sensor/ndt.py:140-212): every (query, map
    cell) pair, masked to the stencil (2D: |Δ|∞ <= 1; 3D: |Δ|₁ <= 1), with
    the closed-form 2x2 inverse and the 3x3 adjugate under the same
    1e-12 diagonal jitter as the probe path."""
    d = meas_mean.shape[-1]
    mp = ndt_map.keys.shape[0]
    live = torch.arange(mp, device=meas_mean.device) < ndt_map.num_cells
    cells = decode_keys(ndt_map.keys, d)  # [M, D]
    qcell = ndt_map.cell_near(meas_mean)  # [..., D]
    delta = torch.abs(qcell[..., None, :] - cells)  # [..., M, D]
    if d == 2:
        within = torch.amax(delta, dim=-1) <= 1
    else:
        within = torch.sum(delta, dim=-1) <= 1
    within = within & live
    mm, mc = ndt_map.means, ndt_map.covs

    if d == 2:
        ex = meas_mean[..., 0, None] - mm[:, 0]  # [..., M]
        ey = meas_mean[..., 1, None] - mm[:, 1]
        txx = meas_cov[..., 0, 0, None] + mc[:, 0, 0]
        txy = meas_cov[..., 0, 1, None] + mc[:, 0, 1]
        tyy = meas_cov[..., 1, 1, None] + mc[:, 1, 1]
        det = txx * tyy - txy * txy
        det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
        quad = (ex * ex * tyy - 2.0 * ex * ey * txy + ey * ey * txx) / det
    else:
        ex = meas_mean[..., 0, None] - mm[:, 0]
        ey = meas_mean[..., 1, None] - mm[:, 1]
        ez = meas_mean[..., 2, None] - mm[:, 2]
        xx = meas_cov[..., 0, 0, None] + mc[:, 0, 0] + 1e-12
        xy = meas_cov[..., 0, 1, None] + mc[:, 0, 1]
        xz = meas_cov[..., 0, 2, None] + mc[:, 0, 2]
        yy = meas_cov[..., 1, 1, None] + mc[:, 1, 1] + 1e-12
        yz = meas_cov[..., 1, 2, None] + mc[:, 1, 2]
        zz = meas_cov[..., 2, 2, None] + mc[:, 2, 2] + 1e-12
        c00 = yy * zz - yz * yz
        c01 = xz * yz - xy * zz
        c02 = xy * yz - xz * yy
        c11 = xx * zz - xz * xz
        c12 = xy * xz - xx * yz
        c22 = xx * yy - xy * xy
        det = torch.clamp_min(xx * c00 + xy * c01 + xz * c02, 1e-30)
        quad = (ex * ex * c00 + ey * ey * c11 + ez * ez * c22
                + 2.0 * (ex * ey * c01 + ex * ez * c02 + ey * ez * c12)) / det
        quad = torch.clamp_min(quad, 0.0)
    lik = params.d1 * torch.exp((-params.d2 / 2.0) * quad)
    return torch.sum(torch.where(within, lik, 0.0), dim=-1)


def pose_matrices(states) -> tuple[Tensor, Tensor]:
    """``(R f32[..., n, D, D], t f32[..., n, D])`` of SE2 or SE3 states."""
    if isinstance(states, SE2):
        c, s = states.rot.cos, states.rot.sin
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
        return rot, states.xy
    return states.rot.as_matrix(), states.xyz


def measurements_in_world(states, meas_means: Tensor, meas_covs: Tensor):
    """The measurement Gaussians ``[..., C]`` as each particle of ``states``
    ``[..., n]`` (SE2 or SE3) sees them in the world (ndt_cell.hpp:63-68):
    means ``f32[..., n, C, D]`` and covariances ``R Σ Rᵀ`` ``f32[..., n, C,
    D, D]``."""
    return world_gaussians(*pose_matrices(states), meas_means, meas_covs)


def _ndt_weights(params, ndt_map, states, meas_means, meas_covs, cell_mask, particle_chunk,
                 kernel) -> Tensor:
    rot, trans = pose_matrices(states)
    if not _dense(ndt_map, kernel, meas_means.shape[-1]):  # the fused kernel on the card
        return ndt_weights(ndt_map.keys, ndt_map.values, ndt_map.num_cells, ndt_map.resolution,
                           rot, trans, meas_means, meas_covs, cell_mask, kernel,
                           params.minimum_likelihood, params.d1, params.d2, particle_chunk,
                           index=ndt_map.index)

    def body(r: Tensor, t: Tensor) -> Tensor:
        mean_w, cov_w = world_gaussians(r, t, meas_means, meas_covs)
        lik = _kernel_likelihood_dense(ndt_map, params, mean_w, cov_w)
        lik = torch.clamp_min(lik, params.minimum_likelihood)
        return 1.0 + torch.sum(torch.where(cell_mask[..., None, :], lik, 0.0), dim=-1)

    return particle_chunks(rot, trans, particle_chunk, body)


def ndt_weights_2d(params: NdtModelParams, ndt_map: NdtMap, states: SE2, meas_means: Tensor,
                   meas_covs: Tensor, cell_mask: Tensor, particle_chunk: int = 512) -> Tensor:
    """Per-particle weights ``1 + Σ_cells max(stencil likelihood, min)``
    (hpp:218-239), ``f32[..., N]``, for states ``[..., N]`` and measurement
    cells ``[..., C]``."""
    return _ndt_weights(params, ndt_map, states, meas_means, meas_covs, cell_mask,
                        particle_chunk, KERNEL_2D)


def ndt_weights_3d(params: NdtModelParams, ndt_map: NdtMap, states: SE3, meas_means: Tensor,
                   meas_covs: Tensor, cell_mask: Tensor, particle_chunk: int = 512) -> Tensor:
    """The 3D variant over SE3 states ``[..., N]``; ``f32[..., N]``."""
    return _ndt_weights(params, ndt_map, states, meas_means, meas_covs, cell_mask,
                        particle_chunk, KERNEL_3D)


def ndt_likelihood_at(params: NdtModelParams, ndt_map: NdtMap, mean: Tensor,
                      cov: Tensor) -> Tensor:
    """``likelihood_at`` of one measurement Gaussian (hpp:229-239)."""
    kernel = KERNEL_2D if mean.shape[-1] == 2 else KERNEL_3D
    lik = _kernel_likelihood(ndt_map, params, mean[None], cov[None], kernel)[0]
    return torch.clamp_min(lik, params.minimum_likelihood)

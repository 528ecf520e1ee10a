"""State-sampling distributions (port of ``beluga_tpu/core/random.py``).

Each sampler is a core that takes its random draws as inputs, plus a thin
wrapper that draws them from an explicit ``torch.Generator``.  JAX's
threefry streams cannot be reproduced in torch, so parity tests feed the
reference's own draws to the cores and compare exactly; only the draws
themselves differ between the two packages.  Every wrapper takes leading
filter axes ``lead``: a fleet draws ``[B, n]`` states from one generator,
each filter independently.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from beluga_tpu_torch.lie import SE2, SE3, SO2, SO3
from beluga_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def _sqrt_psd(cov) -> Tensor:
    """``V·diag(sqrt(max(w, 0)))`` from the eigendecomposition of the
    covariance (multivariate_normal_distribution.hpp:76-90; negative
    eigenvalues clamp to zero): on the host for a host array, on the
    tensor's device for a tensor ``[..., D, D]`` (one per filter)."""
    if isinstance(cov, torch.Tensor):
        with span("sync.recovery_sqrt_cov"):  # eigh's error check reads back
            w, v = torch.linalg.eigh(cov.float())
    else:
        w, v = torch.linalg.eigh(torch.as_tensor(np.asarray(cov, np.float32)))
    return v * torch.sqrt(torch.clamp_min(w, 0.0))[..., None, :]


def _deltas(z: Tensor, cov) -> Tensor:
    """``z @ T^T`` for the draws ``z`` ``f32[..., n, D]``, with ``T`` the
    square root of ``cov`` (one ``[D, D]``, or ``[..., D, D]`` per filter)."""
    return z @ _sqrt_psd(cov).to(z.device).transpose(-1, -2)


def normal_se2_from_draws(z: Tensor, mean: SE2, cov) -> SE2:
    """SE2 poses ``mean + z @ T^T`` with ``z`` the f32[..., n, 3] standard
    normals; additive in (x, y) and in yaw, as the reference samples SE2
    (multivariate_distribution_traits.hpp).  ``mean`` is one pose or one
    per filter ``[...]``."""
    delta = _deltas(z, cov)
    xy = mean.xy.to(z.device)[..., None, :] + delta[..., :2]
    theta = mean.theta.to(z.device)[..., None] + delta[..., 2]
    return SE2(xy, SO2.exp(theta))


def sample_normal_se2(
    generator: torch.Generator, n: int, mean: SE2, cov, lead=()
) -> SE2:
    """Draw ``[*lead, n]`` SE2 poses ~ N(mean, cov) on the generator's
    device; ``cov`` is the 3x3 covariance over (x, y, theta)."""
    z = torch.randn(
        (*lead, n, 3), generator=generator, dtype=torch.float32, device=generator.device
    )
    return normal_se2_from_draws(z, mean, cov)


def normal_se3_from_draws(z: Tensor, mean: SE3, cov) -> SE3:
    """SE3 poses from the f32[..., n, 6] standard normals ``z``: ``delta =
    z @ T^T`` over (x, y, z, roll, pitch, yaw) with ``T`` the square root of
    the 6x6 ``cov`` (random.py:54-61); the translation adds, the rotation
    composes ``mean.rot @ exp(delta[3:])``.  ``mean`` is one pose or one
    per filter ``[...]``."""
    delta = _deltas(z, cov)
    xyz = mean.xyz.to(z.device)[..., None, :] + delta[..., :3]
    rot = SO3(mean.rot.q.to(z.device)[..., None, :]) @ SO3.exp(delta[..., 3:])
    return SE3(xyz, rot)


def sample_normal_se3(
    generator: torch.Generator, n: int, mean: SE3, cov, lead=()
) -> SE3:
    """Draw ``[*lead, n]`` SE3 poses ~ N(mean, cov) on the generator's
    device; ``cov`` is 6x6 over (x, y, z, roll, pitch, yaw), or one per
    filter ``[*lead, 6, 6]``."""
    z = torch.randn(
        (*lead, n, 6), generator=generator, dtype=torch.float32, device=generator.device
    )
    return normal_se3_from_draws(z, mean, cov)


def uniform_box_se2_from_draws(u: Tensor, u_theta: Tensor, lo, hi) -> SE2:
    """SE2 states uniform in the box ``[lo, hi)`` with a uniform heading
    (random.py:64-69): ``u`` f32[..., n, 2] uniforms in [0, 1) place the
    translation as ``jax.random.uniform`` does (``lo + u·(hi − lo)``, then
    at least ``lo``), ``u_theta`` f32[..., n] the heading in [-π, π) the
    same way."""
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=u.device)
    hi = torch.as_tensor(np.asarray(hi, np.float32), device=u.device)
    xy = torch.maximum(lo, u * (hi - lo) + lo)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=u.device)
    theta = torch.maximum(-pi, u_theta * (pi - -pi) + -pi)
    return SE2(xy, SO2.exp(theta))


def sample_uniform_box_se2(generator: torch.Generator, n: int, lo, hi, lead=()) -> SE2:
    """Draw ``[*lead, n]`` SE2 states uniform in the axis-aligned box
    ``[lo, hi)`` with a uniform heading
    (multivariate_uniform_distribution.hpp:44-79)."""
    dev = generator.device
    u = torch.rand((*lead, n, 2), generator=generator, dtype=torch.float32, device=dev)
    u_theta = torch.rand((*lead, n), generator=generator, dtype=torch.float32, device=dev)
    return uniform_box_se2_from_draws(u, u_theta, lo, hi)


def uniform_box_se3_from_draws(u: Tensor, q: Tensor, lo, hi) -> SE3:
    """SE3 states uniform in the box ``[lo, hi)`` with uniform orientation
    (random.py:71-79): ``u`` f32[..., n, 3] uniforms in [0, 1) place the
    translation as ``jax.random.uniform`` does (``lo + u·(hi − lo)``, then
    at least ``lo``); ``q`` f32[..., n, 4] standard normals, normalized,
    give the rotation."""
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=u.device)
    hi = torch.as_tensor(np.asarray(hi, np.float32), device=u.device)
    xyz = torch.maximum(lo, u * (hi - lo) + lo)
    return SE3(xyz, SO3.from_quat_wxyz(q))


def sample_uniform_box_se3(generator: torch.Generator, n: int, lo, hi, lead=()) -> SE3:
    """Draw ``[*lead, n]`` SE3 states uniform in the axis-aligned box
    ``[lo, hi)`` with uniform random orientation
    (multivariate_uniform_distribution.hpp:81-120)."""
    dev = generator.device
    u = torch.rand((*lead, n, 3), generator=generator, dtype=torch.float32, device=dev)
    q = torch.randn((*lead, n, 4), generator=generator, dtype=torch.float32, device=dev)
    return uniform_box_se3_from_draws(u, q, lo, hi)


def uniform_free_cells_from_draws(
    cells: Tensor, theta: Tensor, free_xy: Tensor
) -> SE2:
    """SE2 states at the free-cell centroids ``free_xy[cells]`` with headings
    ``theta`` (multivariate_uniform_distribution.hpp:127-150)."""
    return SE2(free_xy[cells], SO2.exp(theta))


def _headings(generator: torch.Generator, shape, device) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u * (2.0 * math.pi) - math.pi


def sample_uniform_free_cells(
    generator: torch.Generator, n: int, free_xy: Tensor, num_free: int, lead=()
) -> SE2:
    """Uniform SE2 over the free cells: the translation snaps to a free-cell
    centroid (``free_xy`` prefix of length ``num_free``), the heading is
    uniform in [-pi, pi)."""
    cells = torch.randint(0, max(int(num_free), 1), (*lead, n), generator=generator,
                          device=free_xy.device)
    theta = _headings(generator, (*lead, n), free_xy.device)
    return uniform_free_cells_from_draws(cells, theta, free_xy)


def uniform_free_cells_pooled_from_draws(
    cand: Tensor, idx: Tensor, theta: Tensor, free_xy: Tensor
) -> SE2:
    """Free-cell states through a candidate pool (random.py:97-134): the
    pool ``free_xy[cand]`` (``cand`` ``[..., P]``), then slot ``i`` takes
    pool row ``idx[..., i]``, headings ``theta``: the whole draw in one
    launch of kernel B3's draw entry (ops/cuda_pool_take.py)."""
    from beluga_tpu_torch.ops.cuda_pool_take import pooled_free_cells

    return pooled_free_cells(free_xy, cand, idx, theta)


def sample_uniform_free_cells_pooled(
    generator: torch.Generator, n: int, free_xy: Tensor, num_free: int,
    pool: int = 256, lead=(),
) -> SE2:
    """Free-cell-uniform SE2 states from a fresh pool of ``pool`` iid
    candidate cells per call and filter: every slot picks a pool entry
    uniformly.  The marginal of every state is exactly uniform over the
    free cells; two slots of one call may share a cell (the bootstrap
    deviation the reference documents).  Headings stay iid uniform."""
    dev = free_xy.device
    cand = torch.randint(0, max(int(num_free), 1), (*lead, pool), generator=generator,
                         device=dev)
    idx = torch.randint(0, pool, (*lead, n), generator=generator, device=dev,
                        dtype=torch.int32)
    return uniform_free_cells_pooled_from_draws(cand, idx, _headings(generator, (*lead, n), dev),
                                                free_xy)

"""State-sampling distributions (port of ``beluga_tpu/core/random.py``).

Each sampler is a core that takes its random draws as inputs, plus a thin
wrapper that draws them from an explicit ``torch.Generator``.  JAX's
threefry streams cannot be reproduced in torch, so parity tests feed the
reference's own draws to the cores and compare exactly; only the draws
themselves differ between the two packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from beluga_tpu_torch.lie import SE2, SO2

Tensor = torch.Tensor


def _sqrt_psd(cov) -> Tensor:
    """``V·diag(sqrt(max(w, 0)))`` from the eigendecomposition of the 3x3
    covariance, on the host (multivariate_normal_distribution.hpp:76-90;
    negative eigenvalues clamp to zero)."""
    c = torch.as_tensor(np.asarray(cov, np.float32))
    w, v = torch.linalg.eigh(c)
    return v * torch.sqrt(torch.clamp_min(w, 0.0))[..., None, :]


def normal_se2_from_draws(z: Tensor, mean: SE2, cov) -> SE2:
    """SE2 poses ``mean + z @ T^T`` with ``z`` the f32[n, 3] standard
    normals; additive in (x, y) and in yaw, as the reference samples SE2
    (multivariate_distribution_traits.hpp)."""
    t = _sqrt_psd(cov).to(z.device)
    delta = z @ t.T
    xy = mean.xy.to(z.device) + delta[..., :2]
    theta = mean.theta.to(z.device) + delta[..., 2]
    return SE2(xy, SO2.exp(theta))


def sample_normal_se2(
    generator: torch.Generator, n: int, mean: SE2, cov
) -> SE2:
    """Draw n SE2 poses ~ N(mean, cov) on the generator's device; ``cov`` is
    the 3x3 covariance over (x, y, theta)."""
    z = torch.randn(
        (n, 3), generator=generator, dtype=torch.float32, device=generator.device
    )
    return normal_se2_from_draws(z, mean, cov)


def uniform_free_cells_from_draws(
    cells: Tensor, theta: Tensor, free_xy: Tensor
) -> SE2:
    """SE2 states at the free-cell centroids ``free_xy[cells]`` with headings
    ``theta`` (multivariate_uniform_distribution.hpp:127-150)."""
    return SE2(free_xy.index_select(0, cells), SO2.exp(theta))


def sample_uniform_free_cells(
    generator: torch.Generator, n: int, free_xy: Tensor, num_free: int
) -> SE2:
    """Uniform SE2 over the free cells: the translation snaps to a free-cell
    centroid (``free_xy`` prefix of length ``num_free``), the heading is
    uniform in [-pi, pi)."""
    cells = torch.randint(0, max(int(num_free), 1), (n,), generator=generator,
                          device=free_xy.device)
    u = torch.rand((n,), generator=generator, dtype=torch.float32, device=free_xy.device)
    return uniform_free_cells_from_draws(cells, u * (2.0 * math.pi) - math.pi, free_xy)

"""Unscented transform: sigma-point propagation of a mean and covariance
(port of ``beluga_tpu/algorithms/unscented.py``; unscented_transform.hpp:
86-148).

``2n + 1`` sigma points with weights ``w0 = k / (n + k)`` and ``wi = 1 /
(2 (n + k))``, ``k = max(n - 3, 0)`` unless given, offset by the columns
of ``sqrt(n + k)·L`` (``L`` the Cholesky factor), through a vectorized
``transfer_fn``; optional mean and residual callables for manifold outputs
such as angles.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def unscented_transform(
    mean: Tensor,
    covariance: Tensor,
    transfer_fn: Callable[[Tensor], Tensor],
    kappa: float | None = None,
    mean_fn: Callable | None = None,
    residual_fn: Callable | None = None,
):
    """Propagate ``(mean [n], covariance [n, n])`` through ``transfer_fn``,
    which maps the sigma points ``[2n + 1, n]`` to ``[2n + 1, m]`` in one
    call.  ``mean_fn(transformed, weights)`` and ``residual_fn(transformed,
    mean [1, m])`` replace the weighted sum and the difference.  Returns
    ``(out_mean [m], out_cov [m, m])``."""
    n = mean.shape[-1]
    k = float(max(n - 3, 0)) if kappa is None else float(kappa)
    w0 = k / (n + k) if (n + k) > 0 else 0.0
    wn = 1.0 / (2.0 * (n + k))
    weights = torch.cat([torch.tensor([w0], dtype=mean.dtype, device=mean.device),
                         torch.full((2 * n,), wn, dtype=mean.dtype, device=mean.device)])

    l_matrix = torch.linalg.cholesky(covariance)
    scaled = torch.sqrt(torch.tensor(n + k, dtype=mean.dtype, device=mean.device)) * l_matrix
    offsets = torch.cat([scaled.T, -scaled.T], dim=0)  # [2n, n]
    sigma_points = torch.cat([mean[None, :], mean[None, :] + offsets], dim=0)

    transformed = transfer_fn(sigma_points)  # [2n + 1, m]
    if mean_fn is None:
        out_mean = torch.einsum("s,sm->m", weights, transformed)
    else:
        out_mean = mean_fn(transformed, weights)
    if residual_fn is None:
        err = transformed - out_mean[None, :]
    else:
        err = residual_fn(transformed, out_mean[None, :])
    out_cov = torch.einsum("s,sm,sk->mk", weights, err, err)
    return out_mean, out_cov

"""Kernel B8: the sphere-traced beam model, and the beam mixture.

Port of ``beluga_tpu/ops/pallas_beam.py`` (``csrc/beam.cu``):
:func:`sphere_trace_beam_weights` launches the kernel on CUDA tensors and
runs :func:`sphere_trace_reference`, the plain PyTorch version, on CPU
tensors.  Every particle and beam input may carry leading filter axes (a
fleet passes ``f32[B, N]`` poses and ``[B, nb, ...]`` beams); the distance
table is shared.

The ray starts at the centre of the particle's cell and jumps ``max(D - 1,
1)`` cells over the distance table ``D`` (a certified free radius), at most
``march_steps`` times; a beam that exhausts the budget scores the max
range.  The approximation contract is the reference's: the continuous ray,
not Bresenham's line, and the marched arc length, within about one cell of
the exact model's centroid distance.

Contract: the mixture takes the reference's Abramowitz & Stegun ``_erf``;
kernel and plain version run the same float32 operations in the same
order, so they agree bit for bit on the card.  One departure from the
reference: a masked beam adds nothing (a select, as kernel B7 and the
exact path do), where the reference adds ``mask * pz³`` and turns the
weight NaN when a masked beam carries a NaN point (pallas_beam.py:177).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from beluga_tpu_torch.ops.distance_transform import squared_distance_transform

Tensor = torch.Tensor

STEPS = 20  # the reference's default march budget (pallas_beam.py:48)
MAX_FILTERS = 65535  # grid.y
MAX_BEAMS = 14000  # shared memory: 16 B a beam

# kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from beluga_tpu_torch.ops._build import load_library

        fn = load_library("beam").beluga_sphere_trace
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, p, p, p, p, i, p, p, p, i, i, f, f, i, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


# -- the beam mixture (beam_model.hpp:125-147) ---------------------------------


class Mixture(NamedTuple):
    """The mixture's scalars as float32, in the order of
    ``csrc/beam_mixture.cuh``: the beam max range, z_hit, z_max,
    ``sqrt2 * sigma``, sigma, ``n_const = 1 / (sqrt(2π) sigma)``,
    ``-lambda``, ``z_short * lambda`` and ``z_rand / bmr``."""

    bmr: float
    z_hit: float
    z_max: float
    s2sig: float
    sigma: float
    n_const: float
    neg_lam: float
    short_coef: float
    rand_coef: float


def mixture(z_hit, z_short, z_max, z_rand, sigma_hit, lambda_short, beam_max_range,
            host_products: bool = False) -> Mixture:
    """The scalars, each product of scalars taken as the reference takes it:
    in float32 in the kernels (B7, B8), or in Python floats and then
    rounded where the exact model multiplies Python parameters
    (``host_products=True``, beam.py:86, :94)."""
    f32 = np.float32
    sigma, bmr, lam = f32(sigma_hit), f32(beam_max_range), f32(lambda_short)
    if host_products:
        short_coef = f32(z_short * lambda_short)
        rand_coef = f32(z_rand / beam_max_range)
    else:
        short_coef = f32(z_short) * lam
        rand_coef = f32(z_rand) / bmr
    n_const = f32(1.0) / (np.sqrt(f32(2.0 * math.pi)) * sigma)
    return Mixture(float(bmr), float(f32(z_hit)), float(f32(z_max)),
                   float(np.sqrt(f32(2.0)) * sigma), float(sigma), float(n_const),
                   float(-lam), float(short_coef), float(rand_coef))


def poly_erf(x: Tensor) -> Tensor:
    """Abramowitz & Stegun 7.1.26 erf, max abs error 1.5e-7
    (pallas_beam.py:51-62): the kernels' erf."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    y = 1.0 - poly * torch.exp(-ax * ax)
    sign = torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))  # jnp.sign
    return sign * y


def mixture_pz3(z: Tensor, z_mean: Tensor, m: Mixture, erf=poly_erf) -> Tensor:
    """``pz³`` of each beam from measured ranges ``z`` and expected ranges
    ``z_mean`` (broadcast), in the reference's operation order.  Every
    scalar is a 0-d tensor on the rays' device, so that no division goes
    through a reciprocal on the card."""
    s = Mixture(*(torch.tensor(v, dtype=torch.float32, device=z_mean.device) for v in m))
    eta_hit = 2.0 / (erf((s.bmr - z_mean) / s.s2sig) - erf(-z_mean / s.s2sig))
    d = (z - z_mean) / s.sigma
    pz = s.z_hit * eta_hit * s.n_const * torch.exp(-0.5 * d * d)
    eta_short = 1.0 / (1.0 - torch.exp(s.neg_lam * z_mean))
    pz = pz + torch.where(z < z_mean, s.short_coef * eta_short * torch.exp(s.neg_lam * z), 0.0)
    pz = pz + torch.where(z < s.bmr, s.rand_coef, s.z_max)
    return pz * pz * pz


def masked_beam_sum(pz3: Tensor, beam_mask: Tensor) -> Tensor:
    """``Σ_b where(mask_b, pz3_b, 0)`` over the last axis, beam by beam in
    order, as the kernels add (``beam_mask`` broadcasts against ``pz3``)."""
    mask = torch.broadcast_to(beam_mask, pz3.shape)
    acc = torch.zeros(pz3.shape[:-1], dtype=torch.float32, device=pz3.device)
    for b in range(pz3.shape[-1]):
        acc = acc + torch.where(mask[..., b], pz3[..., b], 0.0)
    return acc


# -- the distance table -----------------------------------------------------------


def make_distance_cells(free_mask: Tensor) -> Tensor:
    """``uint8[H, W]``: ``clip(floor(EDT), 0, 255)`` in cells to the nearest
    non-free cell, 0 on obstacle and unknown cells (pallas_beam.py:65-77).
    The reference stores it minus 128 in int8 for its matrix unit."""
    h, w = free_mask.shape
    d2 = squared_distance_transform(~free_mask, 1.0, float(h + w))
    d = torch.floor(torch.sqrt(d2))
    return torch.clamp(d, 0, 255).to(torch.uint8)


# -- kernel B8 ----------------------------------------------------------------------


def _params(resolution: float, params_vec) -> tuple[float, Mixture]:
    bmr, z_hit, z_short, z_max, z_rand, sigma, lam = (float(v) for v in params_vec)
    m = mixture(z_hit, z_short, z_max, z_rand, sigma, lam, bmr)
    max_cells = float(np.float32(m.bmr) / np.float32(resolution))
    return max_cells, m


def _trace(dist_cells: Tensor, tx: Tensor, ty: Tensor, cos: Tensor, sin: Tensor,
           bearings: Tensor, resolution: float, max_cells: float, bmr: float,
           march_steps: int) -> tuple[Tensor, Tensor]:
    """Every (particle, beam) ray traced in lock-step, stopped early once
    all are done: ``(z_mean f32[..., N, nb], steps int[..., N, nb])``, the
    expected ranges and the table reads each ray took."""
    dev = tx.device
    h, w = dist_cells.shape
    table = dist_cells.reshape(-1)
    res = torch.tensor(resolution, dtype=torch.float32, device=dev)
    px = (torch.floor(tx / res) + 0.5)[..., :, None]
    py = (torch.floor(ty / res) + 0.5)[..., :, None]
    c, s = cos[..., :, None], sin[..., :, None]
    bx, by = bearings[..., None, :, 0], bearings[..., None, :, 1]
    dx = bx * c - by * s  # [..., N, nb]
    dy = bx * s + by * c
    dist = torch.zeros(dx.shape, dtype=torch.float32, device=dev)
    z_cells = torch.zeros_like(dist)
    hit = torch.zeros(dx.shape, dtype=torch.bool, device=dev)
    done = torch.zeros_like(hit)
    steps = torch.zeros(dx.shape, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for step in range(march_steps):
        steps += ~done
        fx = torch.floor(px + dist * dx)
        fy = torch.floor(py + dist * dy)
        inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
        idx = (torch.where(inside, fy, zero).long() * w + torch.where(inside, fx, zero).long())
        d = torch.where(inside, table[idx].to(torch.float32), zero)
        hit_now = inside & (d == 0) & ~done
        z_cells = torch.where(hit_now, dist, z_cells)
        hit = hit | hit_now
        done = done | hit_now | ~inside | (dist > max_cells)
        dist = dist + torch.where(done, zero, torch.clamp_min(d - 1.0, 1.0))
        if step % 8 == 7 and bool(done.all()):
            break
    bmr_t = torch.tensor(bmr, dtype=torch.float32, device=dev)
    return torch.minimum(torch.where(hit, z_cells * res, bmr_t), bmr_t), steps


def sphere_trace_reference(dist_cells: Tensor, tx: Tensor, ty: Tensor, cos: Tensor,
                           sin: Tensor, bearings: Tensor, ranges: Tensor, beam_mask: Tensor,
                           resolution: float, params_vec, march_steps: int = STEPS) -> Tensor:
    """Plain PyTorch version of kernel B8."""
    max_cells, m = _params(resolution, params_vec)
    z_mean, _ = _trace(dist_cells, tx, ty, cos, sin, bearings, resolution, max_cells, m.bmr,
                       march_steps)
    return masked_beam_sum(mixture_pz3(ranges[..., None, :], z_mean, m), beam_mask[..., None, :])


def trace_steps(dist_cells: Tensor, tx: Tensor, ty: Tensor, cos: Tensor, sin: Tensor,
                bearings: Tensor, beam_mask: Tensor, resolution: float, params_vec,
                march_steps: int = STEPS) -> int:
    """The table reads that kernel B8 takes on these inputs: the steps of
    every unmasked (particle, beam) ray, for its work count."""
    max_cells, m = _params(resolution, params_vec)
    _, steps = _trace(dist_cells, tx, ty, cos, sin, bearings, resolution, max_cells, m.bmr,
                      march_steps)
    return int(torch.where(beam_mask[..., None, :], steps, 0).sum())


def _check(dist_cells, tx, ty, cos, sin, bearings, ranges, beam_mask):
    device = dist_cells.device
    if dist_cells.dtype != torch.uint8 or dist_cells.dim() != 2:
        raise ValueError(f"dist_cells must be uint8[H, W], got "
                         f"{dist_cells.dtype}{list(dist_cells.shape)}")
    shape = tx.shape
    if tx.dim() < 1:
        raise ValueError("tx must be float32[..., N]")
    lead = tuple(shape[:-1])
    nb = ranges.shape[-1] if ranges.dim() >= 1 else 0
    want = {"tx": (shape, torch.float32), "ty": (shape, torch.float32),
            "cos": (shape, torch.float32), "sin": (shape, torch.float32),
            "bearings": ((*lead, nb, 2), torch.float32), "ranges": ((*lead, nb), torch.float32),
            "beam_mask": ((*lead, nb), torch.bool)}
    for (name, (shp, dtype)), t in zip(want.items(), (tx, ty, cos, sin, bearings, ranges,
                                                      beam_mask)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, dist_cells on {device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name} must be {dtype}{list(shp)}, got {t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams; the kernel takes at most {MAX_BEAMS}")
    if math.prod(lead) > MAX_FILTERS:
        raise ValueError(f"{math.prod(lead)} filters; the kernel takes at most {MAX_FILTERS}")


def sphere_trace_beam_weights(dist_cells: Tensor, tx: Tensor, ty: Tensor, cos: Tensor,
                              sin: Tensor, bearings: Tensor, ranges: Tensor, beam_mask: Tensor,
                              resolution: float, params_vec, march_steps: int = STEPS) -> Tensor:
    """``Σ_b pz_b³`` per particle through sphere-traced expected ranges,
    ``f32[..., N]``.

    Args:
      dist_cells: ``uint8[H, W]`` from :func:`make_distance_cells`.
      tx/ty/cos/sin: ``f32[..., N]`` particle poses in the grid-local frame.
      bearings: ``f32[..., nb, 2]`` unit bearings (base frame); ranges:
        ``f32[..., nb]`` measured ranges; beam_mask: ``bool[..., nb]``.
      resolution: meters per cell (a float32 value as a Python float).
      params_vec: ``(beam_max_range, z_hit, z_short, z_max, z_rand,
        sigma_hit, lambda_short)`` (pallas_beam.py:209-210).
      march_steps: the trace budget.
    """
    global launches
    _check(dist_cells, tx, ty, cos, sin, bearings, ranges, beam_mask)
    if dist_cells.device.type == "cpu":
        return sphere_trace_reference(dist_cells, tx, ty, cos, sin, bearings, ranges,
                                      beam_mask, resolution, params_vec, march_steps)
    if dist_cells.device.type != "cuda":
        raise ValueError(f"unsupported device {dist_cells.device}")
    max_cells, m = _params(resolution, params_vec)
    h, w = dist_cells.shape
    n, nb = tx.shape[-1], ranges.shape[-1]
    filters = math.prod(tx.shape[:-1])
    out = torch.empty(tx.shape, dtype=torch.float32, device=tx.device)
    host = (ctypes.c_float * len(m))(*m)
    stream = torch.cuda.current_stream(tx.device).cuda_stream
    err = _kernel()(dist_cells.data_ptr(), h, w, tx.data_ptr(), ty.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), n, bearings.data_ptr(), ranges.data_ptr(),
                    beam_mask.data_ptr(), nb, filters, float(resolution), max_cells,
                    int(march_steps), host, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sphere-trace kernel launch failed: cudaError {err}")
    launches += 1
    return out

"""Resampling positions and the slot interleave (port of
``beluga_tpu/ops/resample.py``).

Every strategy is inversion by CDF: positions in [0, 1) searched in the
normalized cumulative weights.  The strategies differ only in how the
positions are drawn, so each is a core that takes its uniforms as inputs
(``*_from_uniform``) plus a wrapper that draws them from a
``torch.Generator``.  The search and the donor copy are kernel B2
(ops/cuda_resample.py).

Every positioner clamps below 1.0 (``1 - 2^-24``): the interval search maps
a position at or above the last CDF entry to no donor.  Positions may carry
leading filter axes (``lead``), one independent draw per filter, and the
interleave works on any one axis (the particle axis).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_BELOW_ONE = 1.0 - 2.0**-24


def _uniform(generator: torch.Generator, shape) -> Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


def systematic_from_uniform(u0: Tensor, num: int) -> Tensor:
    """``(i + u0) / num`` for one uniform ``u0`` per filter (f32 ``[...]``)."""
    i = torch.arange(num, dtype=torch.float32, device=u0.device)
    return torch.clamp_max((i + u0[..., None]) / num, _BELOW_ONE)


def stratified_from_uniform(u: Tensor) -> Tensor:
    """``(i + u_i) / num`` for ``num`` iid uniforms ``u`` (last axis)."""
    num = u.shape[-1]
    i = torch.arange(num, dtype=torch.float32, device=u.device)
    return torch.clamp_max((i + u) / num, _BELOW_ONE)


def sorted_multinomial_from_uniform(u: Tensor) -> Tensor:
    """Sorted uniform order statistics from ``num + 1`` iid uniforms by the
    spacings construction: ``E_i = -log1p(-u_i)``,
    ``U_(i) = (E_1 + ... + E_i) / (E_1 + ... + E_{num+1})``.  The donor
    interval counts are exactly multinomial; only the draw order is
    sorted.  ``cummax`` keeps the sequence monotone where a parallel
    cumsum dips by an ulp."""
    e = -torch.log1p(-u)
    s = torch.cummax(torch.cumsum(e, dim=-1), dim=-1).values
    out = s[..., :-1] / torch.clamp_min(s[..., -1:], 1e-38)
    return torch.clamp_max(out, _BELOW_ONE)


def multinomial_positions(generator: torch.Generator, num: int, lead=()) -> Tensor:
    """iid positions (views/sample.hpp's discrete_distribution)."""
    return _uniform(generator, (*lead, num))


def systematic_positions(generator: torch.Generator, num: int, lead=()) -> Tensor:
    return systematic_from_uniform(_uniform(generator, tuple(lead)), num)


def stratified_positions(generator: torch.Generator, num: int, lead=()) -> Tensor:
    return stratified_from_uniform(_uniform(generator, (*lead, num)))


def sorted_multinomial_positions(generator: torch.Generator, num: int, lead=()) -> Tensor:
    return sorted_multinomial_from_uniform(_uniform(generator, (*lead, num + 1)))


POSITIONERS = {
    "multinomial": multinomial_positions,
    "systematic": systematic_positions,
    "stratified": stratified_positions,
}


def interleave_stride(m: int, rows: int = 512) -> tuple[int, int]:
    """Stride/group pair of the slot interleave, ``out[k] = in[(k % g)·r +
    k // g]``, with ``r`` the largest divisor of ``m`` at most
    ``min(rows, sqrt(m))``."""
    r = min(rows, max(math.isqrt(m), 1))
    while m % r:
        r -= 1
    return r, m // r


def interleave_ranks(k: Tensor, m: int, rows: int = 512) -> Tensor:
    """Index form of :func:`interleave_slots`: ``out[k] = in[ranks(k)]``.
    For a prime ``m`` the transpose is the identity, so the coprime stride
    permutation ``(k·s) % m`` takes its place."""
    r, g = interleave_stride(m, rows)
    if r == 1 and m > 4:
        s = max(math.isqrt(m), 2)
        return (k * s) % m
    return (k % g) * r + k // g


def interleave_slots(x: Tensor, rows: int = 512, axis: int = 0) -> Tensor:
    """Reorder the slot axis ``axis`` by a ``[m / r, r]`` transpose, so that
    any slot prefix (the KLD active prefix) spans the whole sorted CDF."""
    m = x.shape[axis]
    r, _ = interleave_stride(m, rows)
    if r == 1 and m > 4:
        ranks = interleave_ranks(torch.arange(m, device=x.device), m, rows)
        return x.index_select(axis, ranks)
    split = x.shape[:axis] + (m // r, r) + x.shape[axis + 1:]
    return x.reshape(split).transpose(axis, axis + 1).reshape(x.shape)

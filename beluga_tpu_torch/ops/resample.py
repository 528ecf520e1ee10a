"""Resampling positions, the index-form resamplers and the slot
interleave (port of ``beluga_tpu/ops/resample.py``).

Every strategy is inversion by CDF: positions in [0, 1) searched in the
normalized cumulative weights.  The strategies differ only in how the
positions are drawn, so each is a core that takes its uniforms as inputs
(``*_from_uniform``) plus a wrapper that draws them from a
``torch.Generator``.  The search and the donor copy are kernel B2
(ops/cuda_resample.py).  Every float running sum here (the spacings of the
sorted positions, the index-form CDFs) is B2's CDF kernel on the card,
which sums in a fixed order, so equal inputs give equal bits on every run;
on the CPU it is ``torch.cumsum``'s plain order.

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


def _running_sum(values: Tensor) -> Tensor:
    # ops/cuda_resample.py imports this module, so its wrapper is imported
    # where it is called
    from beluga_tpu_torch.ops.cuda_resample import running_sum

    return running_sum(values.contiguous())


def _cdf(weights: Tensor) -> Tensor:
    """The normalized CDF of ``weights`` f32[..., N] (zero-weight
    intervals empty): B2's CDF kernel on the card."""
    from beluga_tpu_torch.ops.cuda_resample import monotone_cdf

    return monotone_cdf(weights.float().contiguous())


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
    sorted.  The running sum is B2's CDF kernel on the card (monotone by
    construction, the same bits every call), ``cumsum`` on the CPU."""
    e = -torch.log1p(-u)
    s = _running_sum(e)
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


def sorted_residual_from_uniform(u: Tensor, r0: Tensor) -> Tensor:
    """Positions for the residual slots of residual resampling
    (resample.py:108-133), from ``num + 1`` iid uniforms ``u`` f32[..., num
    + 1] and the floor-copy count ``r0`` (f32[...], a device tensor).

    Slot ``j >= r0`` takes the ``(j - r0 + 1)``-th order statistic of ``num
    - r0`` uniforms (the spacings construction with the denominator at
    ``num - r0``), slots ``j < r0`` take 0.0: searched in the residual CDF,
    the slots from ``r0`` on get exactly ``num - r0`` multinomial draws of
    the residual distribution, in ascending order.  The reference shifts
    with ``jnp.roll(s, r0)``; ``torch.roll`` takes a host int, so each
    filter reads ``s[max(j - r0, 0)]`` by a gather and nothing is read
    back.  The running sum is the one of
    :func:`sorted_multinomial_from_uniform`."""
    num = u.shape[-1] - 1
    e = -torch.log1p(-u)
    s = _running_sum(e)
    r0i = torch.clamp(r0.to(torch.int64), 0, num)[..., None]
    denom = torch.clamp_min(torch.gather(s, -1, num - r0i), 1e-38)
    j = torch.arange(num, device=u.device)
    shifted = torch.gather(s, -1, torch.clamp_min(j - r0i, 0))
    out = torch.clamp_max(shifted / denom, _BELOW_ONE)
    return torch.where(j.to(torch.float32) < r0[..., None], 0.0, out)


def sorted_residual_multinomial_positions(generator: torch.Generator, r0: Tensor, num: int,
                                          lead=()) -> Tensor:
    """:func:`sorted_residual_from_uniform` of ``num + 1`` uniforms drawn
    from ``generator``."""
    return sorted_residual_from_uniform(_uniform(generator, (*lead, num + 1)), r0)


POSITIONERS = {
    "multinomial": multinomial_positions,
    "systematic": systematic_positions,
    "stratified": stratified_positions,
}


# -- index-form resamplers (resample.py:192-241): the CDF + searchsorted; the
# filter resamples through kernel B2 (ops/cuda_resample.py)


def _search(sorted_seq: Tensor, values: Tensor) -> Tensor:
    """``searchsorted`` (side right) of ``values`` f32[..., M] in
    ``sorted_seq`` f32[..., N], clipped to ``[0, N - 1]``, int32."""
    values = values.expand(*sorted_seq.shape[:-1], values.shape[-1]).contiguous()
    idx = torch.searchsorted(sorted_seq.contiguous(), values, right=True)
    return torch.clamp(idx, 0, sorted_seq.shape[-1] - 1).to(torch.int32)


def search_indices(weights: Tensor, positions: Tensor) -> Tensor:
    """Donor indices of ``positions`` f32[..., M] in the normalized CDF of
    ``weights`` f32[..., N]: what each strategy below searches."""
    return _search(_cdf(weights), positions)


def multinomial_indices(generator: torch.Generator, weights: Tensor, num: int) -> Tensor:
    return search_indices(weights, multinomial_positions(generator, num, weights.shape[:-1]))


def systematic_indices(generator: torch.Generator, weights: Tensor, num: int) -> Tensor:
    return search_indices(weights, systematic_positions(generator, num, weights.shape[:-1]))


def stratified_indices(generator: torch.Generator, weights: Tensor, num: int) -> Tensor:
    return search_indices(weights, stratified_positions(generator, num, weights.shape[:-1]))


def residual_indices_from_uniform(weights: Tensor, u: Tensor) -> Tensor:
    """Residual resampling's donors from ``num`` iid uniforms ``u``
    f32[..., num] (resample.py:208-234): slots below the floor-copy count
    ``r0`` repeat particle i ``floor(num·w_i)`` times (a search of the
    integer count prefix sums), the rest are multinomial draws of the
    residual weights."""
    num = u.shape[-1]
    w = weights.float()
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-38)
    counts = torch.floor(w * num)
    residual = w * num - counts
    cum_counts = torch.cumsum(counts, dim=-1)  # integers below 2^24: exact in any order
    slots = torch.arange(num, dtype=torch.float32, device=w.device)
    det_idx = _search(cum_counts, slots)
    res_cdf = _cdf(residual)
    return torch.where(slots < cum_counts[..., -1:], det_idx, _search(res_cdf, u))


def residual_indices(generator: torch.Generator, weights: Tensor, num: int) -> Tensor:
    return residual_indices_from_uniform(weights,
                                         _uniform(generator, (*weights.shape[:-1], num)))


RESAMPLERS = {
    "multinomial": multinomial_indices,
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "residual": residual_indices,
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

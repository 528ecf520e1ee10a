"""Closed-form value codebook for likelihood fields (port of
``beluga_tpu/maps/codebook.py``, host numpy).

The exact EDT gives squared distances ``j * res²`` with integer ``j`` a sum
of two squares, and the Gaussian underflows to ``offset`` a few hundred
cell² out, so a production field has fewer than 256 distinct float32
values.  The field is stored as 8-bit codes plus this codebook without
reconstruction error.  The analytic proposal here is only the fallback
when a field has more than 256 distinct values (ops/gather2d.py).
"""

from __future__ import annotations

import numpy as np

MAX_CODES = 256


def _f32(x):
    return np.float32(x)


def likelihood_field_codebook(
    params, resolution: float, max_codes: int = MAX_CODES
) -> np.ndarray:
    """Sorted f32 codebook of the possible likelihood-field values; merges
    nearest neighbours when the analytic set exceeds ``max_codes``."""
    res2 = _f32(resolution) * _f32(resolution)
    tss = _f32(2.0) * _f32(params.sigma_hit) * _f32(params.sigma_hit)
    amplitude = _f32(params.z_hit / (params.sigma_hit * np.sqrt(2.0 * np.pi)))
    offset = _f32(params.z_random / params.max_laser_distance)

    def value(d2):
        return _f32(amplitude * np.exp(-(_f32(d2) / tss), dtype=np.float32) + offset)

    max_d2_cells = _f32(params.max_obstacle_distance / resolution) ** 2

    values = {value(_f32(0.0)), offset, value(max_d2_cells * res2)}
    jmax = int(min(max_d2_cells, 4 * max_codes * max_codes)) + 1
    amax = int(np.sqrt(jmax)) + 1
    sums = np.unique(
        (np.arange(amax)[:, None] ** 2 + np.arange(amax)[None, :] ** 2).ravel()
    )
    sums = sums[sums <= jmax].astype(np.float64)
    d2s = np.minimum(sums, max_d2_cells) * res2
    vals = (amplitude * np.exp(-(d2s.astype(np.float32) / tss)) + offset).astype(
        np.float32
    )
    values.update(vals.tolist())

    if params.model_unknown_space:
        inv_max = _f32(1.0 / params.max_laser_distance)
        bgd2 = _f32(-tss * np.log((inv_max - offset) / amplitude))
        bgd2 = min(_f32(max_d2_cells * res2), bgd2)
        values.add(value(bgd2))

    book = np.array(sorted(values), np.float32)
    while book.size > max_codes:
        gaps = np.diff(book)
        k = int(np.argmin(gaps))
        merged = np.float32(0.5 * (float(book[k]) + float(book[k + 1])))
        book = np.concatenate([book[:k], [merged], book[k + 2:]])
    if book.size < max_codes:
        book = np.concatenate(
            [book, np.full(max_codes - book.size, book[-1], np.float32)]
        )
    return book

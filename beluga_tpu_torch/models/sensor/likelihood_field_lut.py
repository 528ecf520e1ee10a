"""Shared-scan likelihood-field LUT helpers (port of part of
``beluga_tpu/models/sensor/likelihood_field_lut.py``).

Only :func:`_pad_field_cubed` is ported so far: the windowed scan LUT
(``likelihood_field_winlut.py``) builds on it.  The shared-scan filter
itself (``build_scan_lut*``, ``scan_lut_weights``) waits for slice 5
(ROADMAP A11).
"""

from __future__ import annotations

import math

import torch

from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodField

Tensor = torch.Tensor


def _pad_field_cubed(
    field: LikelihoodField,
    max_point_radius: float,
    resolution_hint: float,
    align: tuple[int, int] = (1, 1),
) -> tuple[Tensor, int]:
    """``(padded pz³ image, pad_cells)`` (likelihood_field_lut.py:60-82): the
    field cubed, surrounded by an ``unknown³`` band ``ceil(r / res) + 2``
    cells wide; dims rounded up to ``align`` multiples (the extra fill
    extends the band on the high side).  Both cubes are ``v * v * v`` in
    float32, as XLA lowers ``** 3``."""
    v = field.values
    lf3 = v * v * v
    u = torch.tensor(field.unknown_prob, dtype=torch.float32, device=v.device)
    unknown3 = u * u * u
    pad = int(math.ceil(max_point_radius / resolution_hint)) + 2
    h, w = lf3.shape
    ha, wa = align
    hp = -(-(h + 2 * pad) // ha) * ha
    wp = -(-(w + 2 * pad) // wa) * wa
    padded = unknown3.expand(hp, wp).clone()
    padded[pad:pad + h, pad:pad + w] = lf3
    return padded, pad

"""Shared-scan likelihood LUT: the reweight as a per-θ correlation map
(port of ``beluga_tpu/models/sensor/likelihood_field_lut.py``).

For a fixed scan the likelihood-field weight is a function of the pose
only, ``w(t, θ) = 1 + Σ_b LF³(t + R(θ) p_b)``.  For each of K heading bins
the beam sum is a correlation of ``LF³`` with the rotated scan footprint,
built once per scan; every particle then costs two table reads (θ
interpolated) instead of B beam lookups.  Three builds:

* :func:`build_scan_lut`, the reference's roll build in plain torch, in its
  operation order (bilinear samples);
* :func:`build_scan_lut_pallas`, kernel B9 (``ops/cuda_scan_lut.py``) on a
  field padded to ``(8, 128)`` multiples, with ``sampling`` (``"bilinear"``
  or ``"nearest"``) and ``downsample``; the alignment exists only for the
  TPU's Mosaic compiler, but the wrapped shifts read other cells of the pad
  band when the padded size changes, so the port keeps it and its tables
  match the reference's shape for shape;
* :func:`build_scan_lut_fft`, through ``torch.fft`` (the reference's XLA
  FFT; periodic-sinc sampling).

Approximations against the exact model are the reference's: heading
quantized to K bins with linear interpolation, endpoints sampled
bilinearly (or nearest), off-map beams read ``unknown³`` from the pad band.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodField
from beluga_tpu_torch.ops.cuda_scan_lut import beam_offsets, scan_lut_correlate
from beluga_tpu_torch.ops.cuda_winlut import floor_mod
from beluga_tpu_torch.ops.gather2d import table_lookup

Tensor = torch.Tensor
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ScanLut:
    """Per-scan correlation maps ``values f32[K, Hp, Wp]`` (pz³ sums);
    ``resolution`` the LUT's cell size (the field's float32 value, times
    ``downsample``) as a float."""

    values: Tensor
    resolution: float
    world_to_field: SE2
    pad_cells: int
    n_theta: int


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


def _radius_or_default(points: Tensor, max_point_radius: float | None) -> float:
    """The scan's footprint radius: ``max_point_radius``, or the largest
    endpoint norm plus half a meter, rounded up (one readback)."""
    if max_point_radius is None:
        norms = np.linalg.norm(points.detach().cpu().numpy(), axis=-1)
        return float(np.ceil(norms.max() + 0.5))
    return max_point_radius


def scan_lut_padded(field: LikelihoodField, max_point_radius: float, lut_build: str = "roll",
                    downsample: int = 1) -> tuple[Tensor, int]:
    """``(padded pz³ image, pad_cells)`` that ``lut_build`` correlates: the
    field padded by ``ceil(r / res) + 2`` cells of ``unknown³``; for the
    kernel build (``"pallas"``) the ``downsample``-strided field, its dims
    rounded up to ``(8, 128)`` multiples.  It depends on the map only, so
    the shared-scan filter keeps it in its ctx."""
    if lut_build == "pallas":
        field = _downsampled(field, downsample)
        return _pad_field_cubed(field, max_point_radius, field.resolution, align=(8, 128))
    return _pad_field_cubed(field, max_point_radius, field.resolution)


def _downsampled(field: LikelihoodField, downsample: int) -> LikelihoodField:
    """The d-strided field of cell size d·res; each cell keeps its world
    position (likelihood_field_lut.py:190-198)."""
    if downsample <= 1:
        return field
    return dataclasses.replace(field, values=field.values[::downsample, ::downsample],
                               resolution=field.resolution * downsample)


def build_scan_lut(field: LikelihoodField, points: Tensor, beam_mask: Tensor,
                   n_theta: int = 128, max_point_radius: float | None = None,
                   padded_cubed: tuple[Tensor, int] | None = None) -> ScanLut:
    """The K correlation maps of one scan by shifted accumulations
    (likelihood_field_lut.py:93-153), bilinear samples: per bin and beam,
    ``((1-ax)(1-ay))·s00 + (ax(1-ay))·s01 + ((1-ax)ay)·s10 + (ax·ay)·s11``
    summed in beam order, ``s`` the padded field shifted by the beam's
    floor offset (plus 0 or 1 cell).  All bins of a beam are gathered at
    once.  ``padded_cubed`` is :func:`scan_lut_padded` of the field, when
    the caller holds it."""
    if padded_cubed is None:
        padded_cubed = scan_lut_padded(field, _radius_or_default(points, max_point_radius))
    padded, pad = padded_cubed
    hp, wp = padded.shape
    dev = padded.device
    ox, oy = beam_offsets(points, field.resolution, n_theta)
    ix, iy = torch.floor(ox), torch.floor(oy)
    ax, ay = ox - ix, oy - iy
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    ys, xs = torch.arange(hp, device=dev), torch.arange(wp, device=dev)
    acc = torch.zeros((n_theta, hp, wp), dtype=F32, device=dev)

    def col(v):
        return v[:, None, None]

    for b in range(points.shape[0]):
        rows0 = torch.remainder(ys[None, :] + iy[:, b, None], hp)  # [K, Hp]
        cols0 = torch.remainder(xs[None, :] + ix[:, b, None], wp)  # [K, Wp]
        rows1, cols1 = torch.remainder(rows0 + 1, hp), torch.remainder(cols0 + 1, wp)

        def sh(rows, cols):
            return padded[rows[:, :, None], cols[:, None, :]]

        a, c = col(ax[:, b]), col(ay[:, b])
        sample = ((1 - a) * (1 - c) * sh(rows0, cols0) + a * (1 - c) * sh(rows0, cols1)
                  + (1 - a) * c * sh(rows1, cols0) + a * c * sh(rows1, cols1))
        acc = acc + torch.where(beam_mask[b], sample, 0.0)
    return ScanLut(acc, field.resolution, field.world_to_field, pad, n_theta)


def build_scan_lut_pallas(field: LikelihoodField, points: Tensor, beam_mask: Tensor,
                          n_theta: int = 128, max_point_radius: float | None = None,
                          sampling: str = "bilinear", downsample: int = 1,
                          padded_cubed: tuple[Tensor, int] | None = None) -> ScanLut:
    """:func:`build_scan_lut` through kernel B9 (likelihood_field_lut.py:
    156-213): the field padded to ``(8, 128)`` multiples, ``sampling``
    ``"bilinear"`` (the roll build's samples, beam sum reassociated) or
    ``"nearest"`` (at most half a cell off), and ``downsample=d`` builds on
    the d-strided field (cell size d·res; each cell keeps its world
    position).  ``padded_cubed`` is ``scan_lut_padded(field, r, "pallas",
    downsample)``, when the caller holds it."""
    if padded_cubed is None:
        padded_cubed = scan_lut_padded(field, _radius_or_default(points, max_point_radius),
                                       "pallas", downsample)
    field = _downsampled(field, downsample)
    padded, pad = padded_cubed
    values = scan_lut_correlate(padded, points, beam_mask, field.resolution, n_theta,
                                sampling=sampling, halo=pad)
    return ScanLut(values, field.resolution, field.world_to_field, pad, n_theta)


def build_scan_lut_fft(field: LikelihoodField, points: Tensor, beam_mask: Tensor,
                       n_theta: int = 128, max_point_radius: float = 4.0,
                       padded_cubed: tuple[Tensor, int] | None = None) -> ScanLut:
    """FFT build (likelihood_field_lut.py:216-272): one real FFT of the
    padded ``LF³``, per bin the footprint spectrum ``Σ_b exp(2πi f·o_b)``
    in closed form and one inverse FFT; periodic-sinc sampling.
    ``padded_cubed`` is :func:`scan_lut_padded` of the field, when the
    caller holds it."""
    if padded_cubed is None:
        padded_cubed = scan_lut_padded(field, max_point_radius)
    padded, pad = padded_cubed
    hp, wp = padded.shape
    dev = padded.device
    spectrum = torch.fft.rfft2(padded)  # [hp, wp // 2 + 1]
    fy = torch.fft.fftfreq(hp, device=dev)[:, None]
    fx = torch.fft.rfftfreq(wp, device=dev)[None, :]
    two_pi = torch.tensor(2.0 * math.pi, dtype=F32, device=dev)
    ox, oy = beam_offsets(points, field.resolution, n_theta)
    values = torch.empty((n_theta, hp, wp), dtype=F32, device=dev)
    for k in range(n_theta):
        phase = two_pi * (fy[None] * oy[k, :, None, None] + fx[None] * ox[k, :, None, None])
        wave = torch.polar(torch.ones_like(phase), phase)
        footprint = torch.sum(torch.where(beam_mask[:, None, None], wave, 0.0), dim=0)
        values[k] = torch.fft.irfft2(spectrum * footprint, s=(hp, wp))
    return ScanLut(values, field.resolution, field.world_to_field, pad, n_theta)


def scan_lut_weights(lut: ScanLut, states: SE2) -> Tensor:
    """AMCL-parity weights ``1 + Σ pz³`` from the LUT, ``f32[..., N]``
    (likelihood_field_lut.py:275-300): the floor cell, clipped into the
    padded table, and the two neighbouring θ bins lerped.  The divisions
    by the resolution and by 2π are by device tensors."""
    tf = lut.world_to_field @ states
    k, hp, wp = lut.values.shape
    dev = lut.values.device
    res = torch.tensor(lut.resolution, dtype=F32, device=dev)
    two_pi = torch.tensor(2.0 * math.pi, dtype=F32, device=dev)
    xi = torch.clamp(torch.floor(tf.x / res).to(torch.int64) + lut.pad_cells, 0, wp - 1)
    yi = torch.clamp(torch.floor(tf.y / res).to(torch.int64) + lut.pad_cells, 0, hp - 1)
    ft = floor_mod(tf.theta, two_pi) / two_pi * k
    k0 = torch.remainder(torch.floor(ft).to(torch.int64), k)
    k1 = torch.remainder(k0 + 1, k)
    a = ft - torch.floor(ft)
    flat = lut.values.reshape(k * hp, wp)
    v0 = table_lookup(flat, k0 * hp + yi, xi)
    v1 = table_lookup(flat, k1 * hp + yi, xi)
    return 1.0 + (1.0 - a) * v0 + a * v1

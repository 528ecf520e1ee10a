"""Windowed shared-scan pose-likelihood LUT, the mega-filter tracking path
(port of ``beluga_tpu/models/sensor/likelihood_field_winlut.py``).

For a converged cloud the per-beam reweight is replaced by one table read
per particle: per scan, the pose likelihood ``L_θ(q) = Σ_b pz³(q + R(θ)
p_b / res)`` is built over a ``win_x × win_y``-cell window of poses around
the cloud, for ``k_bins`` heading bins, and each particle reads it
trilinearly (kernel B6, ``ops/cuda_winlut.py``; kernel B5,
``ops/cuda_fused_step.py``, fuses the read with the motion sample).

**Build = windowed DFT correlation**, as the reference writes it:

    S = Fy · region · Fxᵀ                       (one DFT of the region)
    G[k] = Σ_b wy[k,b] ⊗ wx[k,b]                (footprint spectra)
    L[k] = Re( IFy · (S ⊙ G[k]) · IFxᵀ )        (windowed inverse DFT)

in ``complex64`` matrix products (``torch.matmul``; cuBLAS on the card,
which runs them in full float32 unless TF32 is switched on, and callers
must leave it off).  The DFT matrices depend only on the window and the
pad, so :func:`windowed_dft` builds them once per filter.  Their phases are
the reference's float32 values bit for bit: the angle ``(f32(±2π)·i·j) /
n`` in float32, then ``torch.polar``; a float64 build would not match
(the phase error at ``i·j`` up to 275² is part of the reference's table).

**Dynamic window origin.**  ``x0``, ``y0`` and ``theta0`` follow the
cloud's mean, a device value.  ``lax.dynamic_slice`` has no sync-free
counterpart in PyTorch, so the region is cut with device index arithmetic
(``index_select`` with ``y0 - pad + arange(hr)``, likewise for x): nothing
is read back, and the gate-free mega update reads no window value on the
host.

Approximations against the exact model are the reference's (pose xy and
heading quantized and interpolated, endpoints sinc-sampled, strays score
the all-beams-unknown ``miss``).  ``table_dtype="int8"`` stores
``round(L / scale)`` with the per-build ``scale = max(max L, 1e-6) / 127``
(at most ``scale / 2`` of quantization error) and reads it through kernel
B6-int8.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodField
from beluga_tpu_torch.models.sensor.likelihood_field_lut import _pad_field_cubed
from beluga_tpu_torch.ops.cuda_winlut import (
    WindowGeometry,
    tiled_coverage,
    window_coords,
    window_origin,
    winlut_coverage_states,
    winlut_lookup_states,
)

Tensor = torch.Tensor
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class WindowedScanLut:
    """Windowed per-scan pose-likelihood maps.

    ``values_t``: x-major ``bf16[k_bins, win_x, win_y]`` pz³ sums, or
    their int8 quantization (value = entry · ``scale``);
    ``x0``/``y0``: window origin in padded-field cells (int64 0-d device
    tensors); ``theta0``: heading of bin 0 (bin j covers theta0 + j·dth);
    ``miss``: the all-beams-unknown weight for out-of-window particles
    (f32 0-d).  ``resolution`` is the field's float32 value as a float.
    """

    values_t: Tensor
    x0: Tensor
    y0: Tensor
    theta0: Tensor
    miss: Tensor
    resolution: float
    world_to_field: SE2
    pad_cells: int
    k_bins: int
    win_x: int
    win_y: int
    dth: float
    # quantization step of an int8 table (f32 0-d device tensor); None for
    # a bf16 table
    scale: Tensor | None = None


def _win_xy(win) -> tuple[int, int]:
    """An int window is square; a pair is ``(win_x, win_y)``."""
    if isinstance(win, (tuple, list)):
        return int(win[0]), int(win[1])
    return int(win), int(win)


def _pad_cells(max_point_radius: float, resolution: float) -> int:
    return int(np.ceil(max_point_radius / resolution)) + 2


def _f32(v, device) -> Tensor:
    """``v`` as a float32 0-d tensor on ``device``, made by a fill on the
    card (``torch.tensor(v, device=cuda)`` would be a copy that waits on
    the stream)."""
    return torch.full((), v, dtype=F32, device=device)


def _grow_padded(padded: Tensor, pad: int, field: LikelihoodField,
                 win_x: int, win_y: int) -> Tensor:
    """Maps smaller than the window: grow the pad band (fill = unknown³)."""
    hr, wr = win_y + 2 * pad, win_x + 2 * pad
    hp, wp = padded.shape
    u = _f32(field.unknown_prob, padded.device)
    unknown3 = u * u * u
    if hp < hr:
        padded = torch.cat([padded, unknown3.expand(hr - hp, wp)], dim=0)
        hp = hr
    if wp < wr:
        padded = torch.cat([padded, unknown3.expand(hp, wr - wp)], dim=1)
    return padded


def precompute_padded_field(field: LikelihoodField, win,
                            max_point_radius: float = 4.0) -> Tensor:
    """Map-static padded pz³ image for :func:`build_windowed_scan_lut`
    (``ctx["field_pad3"]``), so the per-scan build skips the cube and pad.
    The pad band is ``ceil(r / res) + 2`` cells at the field's own float32
    resolution (the reference's ``resolution_hint``, which no caller set
    apart from the grid's resolution, is not taken)."""
    win_x, win_y = _win_xy(win)
    padded, pad = _pad_field_cubed(field, max_point_radius, field.resolution)
    return _grow_padded(padded, pad, field, win_x, win_y)


def field_window(field: LikelihoodField, k_bins: int, win, dth: float,
                 max_point_radius: float) -> WindowGeometry:
    """What placing a window reads of ``field``: the pad band and the padded
    image's extent (grown to the window for a small map)."""
    win_x, win_y = _win_xy(win)
    pad = _pad_cells(max_point_radius, field.resolution)
    h, w = field.values.shape
    return WindowGeometry(
        world_to_field=field.world_to_field, resolution=field.resolution, pad=pad,
        hp=max(h + 2 * pad, win_y + 2 * pad), wp=max(w + 2 * pad, win_x + 2 * pad),
        k_bins=k_bins, win_x=win_x, win_y=win_y, dth=dth)


def window_geometry(field: LikelihoodField, center_x, center_y, center_theta,
                    k_bins: int = 64, win=128, dth: float = 2.0 * np.pi / 128.0,
                    max_point_radius: float = 4.0):
    """Window origin ``(x0, y0, theta0, pad)`` for a cloud center (world
    frame, 0-d tensors on the field's device), without the correlation
    build, so that a gate can run first.  ``x0``/``y0`` are int64 and
    ``theta0`` float32 0-d device tensors (``ops/cuda_winlut.py:window_origin``)."""
    geo = field_window(field, k_bins, win, dth, max_point_radius)
    return (*window_origin(geo, center_x, center_y, center_theta), geo.pad)


def windowed_dft(win, pad: int, device=None) -> dict:
    """The DFT matrices of the windowed correlation for a ``win`` window
    and ``pad`` cells of band: forward ``fy [hr, hr]``, ``fx [wr, wr]``,
    windowed inverses ``ify [win_y, hr]``, ``ifx [win_x, wr]`` (complex64)
    and the signed frequencies ``fy_freq [hr]``, ``fx_freq [wr]``
    (float32), with ``hr = win_y + 2·pad``, ``wr = win_x + 2·pad``.  The
    phases are computed in float32 in the reference's operation order."""
    win_x, win_y = _win_xy(win)
    hr, wr = win_y + 2 * pad, win_x + 2 * pad
    dev = torch.device("cpu") if device is None else torch.device(device)
    two_pi = _f32(2.0 * math.pi, dev)
    ii = torch.arange(hr, dtype=F32, device=dev)
    jj = torch.arange(wr, dtype=F32, device=dev)
    hh_y = torch.arange(win_y, dtype=F32, device=dev) + pad
    hh_x = torch.arange(win_x, dtype=F32, device=dev) + pad

    def phasor(angle: Tensor) -> Tensor:
        return torch.polar(torch.ones_like(angle), angle)

    def freq(a: Tensor, n: int) -> Tensor:
        return torch.where(a < n // 2, a, a - n) / _f32(n, dev)

    return dict(
        hr=hr, wr=wr,
        fy=phasor((-two_pi * ii[:, None] * ii[None, :]) / _f32(hr, dev)),
        fx=phasor((-two_pi * jj[:, None] * jj[None, :]) / _f32(wr, dev)),
        ify=phasor((two_pi * hh_y[:, None] * ii[None, :]) / _f32(hr, dev)) / hr,
        ifx=phasor((two_pi * hh_x[:, None] * jj[None, :]) / _f32(wr, dev)) / wr,
        fy_freq=freq(ii, hr),
        fx_freq=freq(jj, wr),
    )


def build_windowed_scan_lut(
    field: LikelihoodField,
    points: Tensor,
    beam_mask: Tensor,
    center_x: Tensor,
    center_y: Tensor,
    center_theta: Tensor,
    k_bins: int = 64,
    win=128,
    dth: float = 2.0 * np.pi / 128.0,
    max_point_radius: float = 4.0,
    table_dtype: str = "bf16",
    padded_cubed: Tensor | None = None,
    dft: dict | None = None,
) -> WindowedScanLut:
    """The windowed LUT of one scan around a cloud center
    (likelihood_field_winlut.py:185-290).

    ``center_*`` are world-frame 0-d tensors on the field's device
    (typically the cloud's mean); ``points f32[nb, 2]``, ``beam_mask
    bool[nb]``.  ``padded_cubed`` is :func:`precompute_padded_field`'s
    image and ``dft`` :func:`windowed_dft`'s matrices, both built once per
    map and filter; each is computed here when absent.  ``table_dtype``
    ``"bf16"`` or ``"int8"`` (likelihood_field_winlut.py:267-275)."""
    if table_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown table_dtype {table_dtype!r}")
    win_x, win_y = _win_xy(win)
    dev = field.values.device
    pad = _pad_cells(max_point_radius, field.resolution)
    if padded_cubed is None:
        padded_cubed = precompute_padded_field(field, win, max_point_radius)
    if dft is None:
        dft = windowed_dft(win, pad, dev)
    hr, wr = dft["hr"], dft["wr"]
    res = _f32(field.resolution, dev)
    u = _f32(field.unknown_prob, dev)
    unknown3 = u * u * u

    x0, y0, theta0, _ = window_geometry(
        field, center_x, center_y, center_theta, k_bins=k_bins, win=win, dth=dth,
        max_point_radius=max_point_radius,
    )
    rows = (y0 - pad) + torch.arange(hr, device=dev)
    cols = (x0 - pad) + torch.arange(wr, device=dev)
    region = padded_cubed.index_select(0, rows).index_select(1, cols)

    # ---- explicit DFT correlation (likelihood_field_winlut.py:241-264) ----
    spectrum = dft["fy"] @ region.to(torch.complex64) @ dft["fx"].T  # [hr, wr]
    th = theta0 + torch.arange(k_bins, dtype=F32, device=dev) * _f32(dth, dev)
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    px, py = points[None, :, 0], points[None, :, 1]
    ox = (c * px - s * py) / res  # [K, B]
    oy = (s * px + c * py) / res
    two_pi = _f32(2.0 * math.pi, dev)
    # value at cell q is Σ_b region(q + off_b): multiplier exp(+2πi f·off)
    ay = two_pi * dft["fy_freq"][None, None, :] * oy[:, :, None]  # [K, B, hr]
    ax = two_pi * dft["fx_freq"][None, None, :] * ox[:, :, None]  # [K, B, wr]
    wy = torch.polar(torch.ones_like(ay), ay) * beam_mask[None, :, None]
    wx = torch.polar(torch.ones_like(ax), ax)
    footprint = wy.transpose(1, 2) @ wx  # [K, hr, wr]
    t1 = (spectrum[None] * footprint) @ dft["ifx"].T  # [K, hr, win_x]
    values = (dft["ify"] @ t1).real  # [K, win_y, win_x]

    miss = 1.0 + torch.sum(torch.where(beam_mask, unknown3, 0.0))
    values_t = values.transpose(1, 2).contiguous()
    scale = None
    if table_dtype == "int8":
        scale = torch.clamp_min(torch.amax(values_t), 1e-6) / _f32(127.0, dev)
        values_t = torch.clamp(torch.round(values_t / scale), -128, 127).to(torch.int8)
    else:
        values_t = values_t.to(torch.bfloat16)
    return WindowedScanLut(
        values_t=values_t, x0=x0, y0=y0, theta0=theta0, miss=miss,
        resolution=field.resolution, world_to_field=field.world_to_field,
        pad_cells=pad, k_bins=k_bins, win_x=win_x, win_y=win_y, dth=dth, scale=scale,
    )


# the fractional window coordinates of states (winlut.py:293-304), the
# plain chain of kernel B6's states entry
_coords = window_coords


def windowed_coords(lut: WindowedScanLut, states: SE2):
    """Per-particle fractional ``(xi, yi, t)`` f32 window coordinates
    (strays fall outside ``[0, win - 1]`` / ``[0, k_bins)``)."""
    return _coords(lut.world_to_field, lut.resolution, lut.pad_cells, lut.x0, lut.y0,
                   lut.theta0, lut.k_bins, lut.dth, states)


def _in_window(xi, yi, t, win_x: int, win_y: int, k_bins: int) -> Tensor:
    return ((xi >= 0) & (xi <= win_x - 1) & (yi >= 0) & (yi <= win_y - 1)
            & (t >= 0) & (torch.floor(t) <= k_bins - 2))


def windowed_coverage_from_center(field: LikelihoodField, states: SE2, center_x, center_y,
                                  center_theta, k_bins: int = 64, win=128,
                                  dth: float = 2.0 * np.pi / 128.0,
                                  max_point_radius: float = 4.0,
                                  stride: int = 8) -> Tensor:
    """Coverage fraction (every ``stride``-th particle) of the window that
    would be built around ``center_*``, without building it."""
    win_x, win_y = _win_xy(win)
    x0, y0, theta0, pad = window_geometry(
        field, center_x, center_y, center_theta, k_bins=k_bins, win=win, dth=dth,
        max_point_radius=max_point_radius)
    xi, yi, t = _coords(field.world_to_field, field.resolution, pad, x0, y0, theta0,
                        k_bins, dth, states)
    ok = _in_window(xi[::stride], yi[::stride], t[::stride], win_x, win_y, k_bins)
    return torch.mean(ok.to(F32))


def coverage_tiled_from_coords(xi: Tensor, yi: Tensor, t: Tensor, k_bins: int, win,
                               tile: int, tblk: int) -> Tensor:
    """Fraction of particles the winlut kernel scores, the per-tile θ slab
    included (winlut.py:350-385; ``ops/cuda_winlut.py:tiled_coverage``)."""
    win_x, win_y = _win_xy(win)
    return tiled_coverage(xi, yi, t, k_bins, win_x, win_y, tile, tblk)


def windowed_coverage_tiled_from_center(field: LikelihoodField, states: SE2, center_x,
                                        center_y, center_theta, tile: int = 512,
                                        tblk: int = 16, k_bins: int = 64, win=128,
                                        dth: float = 2.0 * np.pi / 128.0,
                                        max_point_radius: float = 4.0) -> Tensor:
    """Kernel-exact coverage (θ slab included) of the window that would be
    built around ``center_*``: the fast-path gate, one launch of kernel B6's
    coverage entry on the card (its plain version on the CPU); states
    ``[B, N]`` give each filter's coverage ``f32[B]`` in the same launch."""
    geo = field_window(field, k_bins, win, dth, max_point_radius)
    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))
    return winlut_coverage_states(geo, states, center_x, center_y, center_theta, tile, tblk)


def windowed_coverage(lut: WindowedScanLut, states: SE2, stride: int = 8) -> Tensor:
    """Fraction of (every ``stride``-th) particles the window covers."""
    xi, yi, t = windowed_coords(lut, states)
    ok = _in_window(xi[::stride], yi[::stride], t[::stride], lut.win_x, lut.win_y,
                    lut.k_bins)
    return torch.mean(ok.to(F32))


def windowed_scan_lut_weights(lut: WindowedScanLut, states: SE2, tile: int = 512,
                              tblk: int = 16) -> Tensor:
    """AMCL-parity weights ``1 + Σ_b pz³`` from the windowed LUT, ``f32[N]``:
    one trilinear lookup per particle, its window coordinates composed in
    the same launch (kernel B6's states entry, bf16 or int8 table, on a
    CUDA tensor; the plain version on a CPU tensor); strays score
    ``lut.miss``.  Slots should be θ-sorted so that each ``tile`` spans at
    most ``tblk - 1`` bins."""
    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))
    return winlut_lookup_states(lut, states, lut.miss, base=1.0, tile=tile, tblk=tblk)

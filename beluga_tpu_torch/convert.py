"""Carry state from the JAX package into the port's types.

Tests use these so that both packages compute on identical tables and
particles.  The inputs are the JAX package's objects with numpy leaves
(after ``jax.device_get``); they are read by attribute, so this module
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from beluga_tpu_torch.algorithms.thrun import ExpFilterState, ThrunState
from beluga_tpu_torch.core.particles import ParticleSet
from beluga_tpu_torch.filters.amcl import AmclState
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.models.sensor.beam_lut import RangeLut
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodField
from beluga_tpu_torch.models.sensor.likelihood_field_winlut import WindowedScanLut
from beluga_tpu_torch.ops.cuda_beam_lut import padded_dims


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype)).to(device)


def _f32(a) -> float:
    return float(np.float32(np.asarray(a)))


def se2(pose, device="cpu") -> SE2:
    """An ``SE2`` (``xy``, ``rot.z``) of numpy arrays."""
    return SE2(_t(pose.xy, device, np.float32), SO2(_t(pose.rot.z, device, np.float32)))


def grid(g, device="cpu") -> OccupancyGrid:
    """An ``OccupancyGrid`` with numpy leaves."""
    origin = se2(g.origin, device)
    z = np.asarray(g.origin.rot.z, np.float64)
    xy = np.asarray(g.origin.xy, np.float64)
    return OccupancyGrid(
        data=_t(g.data, device, np.int8),
        resolution=_f32(g.resolution),
        origin=origin,
        free_xy=_t(g.free_xy, device, np.float32),
        num_free=int(np.asarray(g.num_free)),
        origin_xytheta=(float(xy[0]), float(xy[1]), float(np.arctan2(z[1], z[0]))),
    )


def field(f, device="cpu") -> LikelihoodField:
    """A ``LikelihoodField`` with numpy leaves."""
    return LikelihoodField(
        values=_t(f.values, device, np.float32),
        resolution=_f32(f.resolution),
        world_to_field=se2(f.world_to_field, device),
        unknown_prob=_f32(f.unknown_prob),
    )


def field_codes(codes_book, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """``(codes int[H, W], codebook f32[K])`` → ``(uint8 codes, f32 book)``."""
    codes, book = codes_book
    codes = np.asarray(codes)
    if codes.min() < 0 or codes.max() > 255:
        raise ValueError("codes must lie in [0, 255] to fit uint8")
    return _t(codes, device, np.uint8), _t(book, device, np.float32)


def field_values3(values3, shape, device="cpu") -> torch.Tensor:
    """The reference's codebook16 table (``build_values3``: transposed,
    padded, four shifted copies along y) as the port's ``bf16[H, W]``:
    copy 0, transposed back.  ``shape`` is ``(H, W)``."""
    h, w = shape
    bits = np.ascontiguousarray(np.asarray(values3)[:w, :h].T).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def range_lut(lut, device="cpu") -> RangeLut:
    """A ``RangeLut`` with numpy leaves."""
    return RangeLut(ranges=_t(lut.ranges, device, np.float32), resolution=_f32(lut.resolution),
                    origin_inv=se2(lut.origin_inv, device), n_bearings=int(lut.n_bearings),
                    max_range=float(lut.max_range))


def beam_dist(dist_cells, device="cpu") -> torch.Tensor:
    """The reference's int8 distance table (``make_distance_cells``, cells
    minus 128) as the port's ``uint8`` cells."""
    return _t(np.asarray(dist_cells, np.int16) + 128, device, np.uint8)


def range_lut_bf16(twin, shape, device="cpu") -> torch.Tensor:
    """The reference's twin-table ``bf16[2·Wq, K, Hq]`` (x-major, the second
    copy y-shifted by 64) as the port's cell-major ``bf16[Hq, Wq, K]``: copy
    0, transposed.  ``shape`` is the map's ``(H, W)``; the padding past it
    is zero in both."""
    hq, wq = padded_dims(*shape)
    values = np.asarray(twin, np.float32)
    if values.shape[0] != 2 * wq or values.shape[2] != hq:
        raise ValueError(f"twin table {list(values.shape)} does not fit a map of {shape}")
    cells = np.ascontiguousarray(values[:wq].transpose(2, 0, 1))  # [Hq, Wq, K]
    return torch.as_tensor(cells).to(torch.bfloat16).to(device)


def ctx(c: dict, device="cpu") -> dict:
    """A model ctx dict: the likelihood-field one (``grid``, ``field``,
    ``field_codes``, in codebook16 mode ``field_values3``, and for the
    windowed filter ``field_pad3``) or the beam one (``grid`` and, by
    path, ``range_lut``, ``range_lut_bf16`` or ``beam_dist``)."""
    out = {"grid": grid(c["grid"], device)}
    if "field" in c:
        out["field"] = field(c["field"], device)
    if "range_lut" in c:
        out["range_lut"] = range_lut(c["range_lut"], device)
    if "range_lut_bf16" in c:
        out["range_lut_bf16"] = range_lut_bf16(c["range_lut_bf16"], out["grid"].data.shape,
                                               device)
    if "beam_dist" in c:
        out["beam_dist"] = beam_dist(c["beam_dist"], device)
    if "field_codes" in c:
        out["field_codes"] = field_codes(c["field_codes"], device)
    if "field_values3" in c:
        out["field_values3"] = field_values3(c["field_values3"], out["field_codes"][0].shape,
                                             device)
    if "field_pad3" in c:
        out["field_pad3"] = _t(c["field_pad3"], device, np.float32)
    return out


def windowed_scan_lut(lut, device="cpu") -> WindowedScanLut:
    """A bf16 ``WindowedScanLut`` with numpy leaves (``values_t`` as
    float32 or bfloat16 values)."""
    if getattr(lut, "scale", None) is not None:
        raise ValueError("int8 window tables are not ported (ROADMAP B6-int8)")
    values = torch.as_tensor(np.asarray(lut.values_t, np.float32)).to(torch.bfloat16)
    return WindowedScanLut(
        values_t=values.to(device),
        x0=_t(lut.x0, device, np.int64), y0=_t(lut.y0, device, np.int64),
        theta0=_t(lut.theta0, device, np.float32), miss=_t(lut.miss, device, np.float32),
        resolution=_f32(lut.resolution), world_to_field=se2(lut.world_to_field, device),
        pad_cells=int(lut.pad_cells), k_bins=int(lut.k_bins), win_x=int(lut.win_x),
        win_y=int(lut.win_y), dth=float(lut.dth),
    )


def particles(p, device="cpu") -> ParticleSet:
    """A ``ParticleSet`` whose state is an SE2."""
    return ParticleSet(
        state=se2(p.state, device),
        log_weight=_t(p.log_weight, device, np.float32),
        active=_t(p.active, device, np.int32),
    )


def amcl_state(s, generator: torch.Generator, device="cpu") -> AmclState:
    """An ``AmclState``, of one filter or (leaves with a leading ``B``
    axis, as ``vmap`` makes them) of a fleet.  The JAX key has no
    counterpart: the port's draws come from ``generator``.  Odometry memory
    and gates go to the host, as Python scalars for one filter and numpy
    arrays for a fleet."""
    def exp_filter(e):
        return ExpFilterState(_t(e.value, device, np.float32), _t(e.seeded, device, bool))

    def host(a, dtype):
        a = np.array(a, dtype=dtype)
        return a.item() if a.ndim == 0 else a

    return AmclState(
        particles=particles(s.particles, device),
        generator=generator,
        thrun=ThrunState(exp_filter(s.thrun.slow), exp_filter(s.thrun.fast)),
        resample_count=host(s.resample_count, np.int64),
        motion_latest=se2(s.motion_latest, "cpu"),
        motion_seeded=host(s.motion_seeded, bool),
        control_prev=se2(s.control_prev, "cpu"),
        control_seeded=host(s.control_seeded, bool),
        force_update=host(s.force_update, bool),
    )

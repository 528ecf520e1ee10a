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
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodField


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


def ctx(c: dict, device="cpu") -> dict:
    """The likelihood-field ctx dict (``grid``, ``field``, ``field_codes``)."""
    out = {"grid": grid(c["grid"], device), "field": field(c["field"], device)}
    if "field_codes" in c:
        out["field_codes"] = field_codes(c["field_codes"], device)
    return out


def particles(p, device="cpu") -> ParticleSet:
    """A ``ParticleSet`` whose state is an SE2."""
    return ParticleSet(
        state=se2(p.state, device),
        log_weight=_t(p.log_weight, device, np.float32),
        active=_t(p.active, device, np.int32),
    )


def amcl_state(s, generator: torch.Generator, device="cpu") -> AmclState:
    """An ``AmclState``.  The JAX key has no counterpart: the port's draws
    come from ``generator``.  Odometry memory goes to the host."""
    def exp_filter(e):
        return ExpFilterState(_t(e.value, device, np.float32), _t(e.seeded, device, bool))

    return AmclState(
        particles=particles(s.particles, device),
        generator=generator,
        thrun=ThrunState(exp_filter(s.thrun.slow), exp_filter(s.thrun.fast)),
        resample_count=int(np.asarray(s.resample_count)),
        motion_latest=se2(s.motion_latest, "cpu"),
        motion_seeded=bool(np.asarray(s.motion_seeded)),
        control_prev=se2(s.control_prev, "cpu"),
        control_seeded=bool(np.asarray(s.control_seeded)),
        force_update=bool(np.asarray(s.force_update)),
    )

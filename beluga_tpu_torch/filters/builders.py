"""Constructors wiring models into the AMCL filter (port of the
likelihood-field part of ``beluga_tpu/filters/builders.py``).

Returns the :class:`AmclModels` table and the ``ctx`` dict that
``filters.amcl.update`` consumes.  :func:`make_likelihood_field_filter`
has two lookup paths: the code table of kernel B1, which is what the JAX
package selects on an accelerator (``lookup_mode="codebook"``), and the
bf16 pz³ table of kernel B4 (``"codebook16"``, the fleet configuration);
the other modes wait for later slices and raise.
:func:`make_windowed_scan_filter` is the single (mega) filter's tracking
path through the windowed pose LUT: kernel B6, or kernel B5 fused with the
motion sample, with kernel B1 for the exact tail and the fallback.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from beluga_tpu_torch import resolve_device
from beluga_tpu_torch.algorithms.cluster import cluster_based_estimate
from beluga_tpu_torch.core.random import (
    sample_uniform_free_cells,
    sample_uniform_free_cells_pooled,
)
from beluga_tpu_torch.core.particles import tree_map
from beluga_tpu_torch.filters.amcl import AmclModels, default_estimate, default_hash_state
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.codebook import likelihood_field_codebook
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_decompose,
    diff_drive_propagate,
)
from beluga_tpu_torch.models.sensor.likelihood_field import (
    LikelihoodFieldParams,
    likelihood_field_weights_codebook,
    make_likelihood_field,
)
from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
    _pad_cells,
    build_windowed_scan_lut,
    precompute_padded_field,
    windowed_coverage_tiled_from_center,
    windowed_dft,
    windowed_scan_lut_weights,
)
from beluga_tpu_torch.ops.cuda_fused_step import fused_propagate_winlut, pack_scalars
from beluga_tpu_torch.ops.cuda_reweight import build_values3
from beluga_tpu_torch.ops.gather2d import build_device_codebook, encode_table

_LATER_MODES = {"gather": "A11", "onehot": "A11", "lowrank": "A11"}
POOL_CAP = 4096  # rows of kernel B3's pool


def make_motion_fn(motion_params):
    """The propagate function of a motion-params dataclass."""
    if isinstance(motion_params, DifferentialDriveParams):
        def propagate(ctx, z, states, pose, prev):
            del ctx
            return diff_drive_propagate(motion_params, z, states, pose, prev)

        return propagate
    raise NotImplementedError(
        f"motion model {motion_params!r} is not ported (ROADMAP A12)"
    )


def make_grid_random_state_fn(recovery_candidates: int = 0):
    """Recovery generator: uniform over the free cells of ``ctx['grid']``
    (beluga_ros/amcl.hpp map_distribution_), ``[..., n]`` states with the
    filter axes of ``particles``.

    ``recovery_candidates > 0`` (and below ``n``) switches to the pooled
    generator (core/random.py sample_uniform_free_cells_pooled, kernel B3):
    a fresh pool of ``min(n, max(recovery_candidates, n // 8), 4096)``
    candidate cells per call and filter (builders.py:58-87).  Marginals
    stay exact; injected particles of one call may share a cell."""

    def random_state(ctx, generator, n, particles=None):
        grid: OccupancyGrid = ctx["grid"]
        lead = () if particles is None else tuple(particles.log_weight.shape[:-1])
        if recovery_candidates and recovery_candidates < n:
            pool = min(n, max(recovery_candidates, n // 8), POOL_CAP)
            return sample_uniform_free_cells_pooled(
                generator, n, grid.free_xy, grid.num_free, pool=pool, lead=lead)
        return sample_uniform_free_cells(generator, n, grid.free_xy, grid.num_free, lead=lead)

    return random_state


def make_likelihood_field_filter(
    grid: OccupancyGrid,
    lf_params: LikelihoodFieldParams = LikelihoodFieldParams(),
    motion_params: Any = DifferentialDriveParams(),
    prob_model: bool = False,
    use_cluster_estimate: bool = False,
    lookup_mode: str = "auto",
    recovery_candidates: int = 0,
    device=None,
):
    """Likelihood-field AMCL: ``(models, ctx)`` with ``ctx = {'grid',
    'field', 'field_codes'}`` (and ``'field_values3'`` in codebook16 mode)
    on ``device`` (default ``"cuda"``).

    ``lookup_mode``: ``"auto"`` or ``"codebook"``, the 8-bit code table
    read by kernel B1 (exact for production fields); ``"codebook16"``, the
    bf16 pz³ table read by kernel B4 (within 5e-3 of the exact weights;
    the reference's "<=0.2%", builders.py:107-109, is the typical error,
    not a bound)."""
    if lookup_mode in _LATER_MODES:
        raise NotImplementedError(
            f"lookup_mode {lookup_mode!r} is not ported (ROADMAP {_LATER_MODES[lookup_mode]})"
        )
    if lookup_mode not in ("auto", "codebook", "codebook16"):
        raise ValueError(f"unknown lookup_mode {lookup_mode!r}")
    if prob_model:
        raise NotImplementedError("the likelihood-field prob model is not ported (ROADMAP A11)")

    def log_weight(ctx, states, points, beam_mask):
        lik = likelihood_field_weights_codebook(
            ctx["field"], ctx["field_codes"], states, points, beam_mask,
            values3=ctx.get("field_values3"),
        )
        return torch.log(lik)

    if use_cluster_estimate:
        def estimate(params, particles):
            del params
            return cluster_based_estimate(particles.state, particles.weight, particles.mask)
    else:
        estimate = default_estimate

    models = AmclModels(
        propagate=make_motion_fn(motion_params),
        log_weight=log_weight,
        random_state=make_grid_random_state_fn(recovery_candidates),
        hash_state=default_hash_state,
        estimate=estimate,
    )
    ctx = update_map_ctx({}, grid.to(resolve_device(device)), lf_params)
    if lookup_mode == "codebook16":
        ctx["field_values3"] = build_values3(*ctx["field_codes"])
    return models, ctx


def make_field_codes(field, lf_params: LikelihoodFieldParams, grid: OccupancyGrid):
    """``(codes uint8[H, W], codebook f32[256])``: the table's distinct
    values when there are at most 256, else the analytic host proposal
    (maps/codebook.py)."""
    fallback = torch.as_tensor(likelihood_field_codebook(lf_params, grid.resolution))
    book = build_device_codebook(field.values, fallback)
    return encode_table(field.values, book), book


def update_map_ctx(ctx: dict, grid: OccupancyGrid, lf_params: LikelihoodFieldParams) -> dict:
    """Hot-swap the map (amcl_node.cpp:469-471): rebuild the field, its
    code table, in codebook16 mode (a ``'field_values3'`` key) its bf16 pz³
    table, and for the windowed filter (a ``'field_pad3'`` key) its padded
    pz³ image and DFT matrices from the window geometry stored beside them,
    on the grid's device; keep everything else.  The reference keeps a
    stale ``field_pad3`` (builders.py:206-225), so its windowed filter goes
    on scoring the old map; the port does not copy that."""
    field = make_likelihood_field(lf_params, grid)
    codes = make_field_codes(field, lf_params, grid)
    new_ctx = {**ctx, "grid": grid, "field": field, "field_codes": codes}
    if "field_values3" in ctx:
        new_ctx["field_values3"] = build_values3(*codes)
    if "field_pad3" in ctx:
        new_ctx.update(_winlut_ctx(field, **ctx["winlut_geometry"]))
    return new_ctx


def _winlut_ctx(field, win, max_point_radius: float) -> dict:
    """The map-static parts of the windowed filter: the padded pz³ image,
    the DFT matrices of its window, and the geometry they were built for."""
    pad = _pad_cells(max_point_radius, field.resolution)
    return {
        "field_pad3": precompute_padded_field(field, win, max_point_radius),
        "winlut_dft": windowed_dft(win, pad, field.values.device),
        "winlut_geometry": {"win": win, "max_point_radius": max_point_radius},
    }


def _exact_tail_slots(n: int, tile: int, frac: float) -> int:
    """Suffix length (tile-aligned) scored by the exact model in the hybrid
    winlut reweight (builders.py:303-309); 0 disables the hybrid."""
    if frac <= 0.0 or n < 2 * tile:
        return 0
    s = max(tile, int(round(n * frac / tile)) * tile)
    return min(s, n - tile)


def fused_step_scalars(lut, motion_params: DifferentialDriveParams, pose: SE2, prev: SE2,
                       device) -> torch.Tensor:
    """Kernel B5's ``f32[18]`` scalars for one update on ``device``
    (builders.py:505-518): the motion's (mean, sd) pairs from the host
    poses, and the window's affine and θ bin from ``lut``'s device values,
    with nothing read back."""
    (r1m, r1s), (tm, ts), (r2m, r2s) = diff_drive_decompose(motion_params, pose, prev)
    wf = lut.world_to_field
    f32 = np.float32
    center = lut.theta0 + torch.tensor((lut.k_bins // 2) * lut.dth, dtype=torch.float32,
                                       device=lut.theta0.device)
    return pack_scalars(
        r1m, r1s, tm, ts, r2m, r2s, wf,
        float(f32(1.0) / f32(lut.resolution)),
        -0.5 + (lut.pad_cells - lut.x0.to(torch.float32)),
        -0.5 + (lut.pad_cells - lut.y0.to(torch.float32)),
        torch.atan2(wf.rot.sin, wf.rot.cos) - center,
        1.0 / lut.dth, float(lut.k_bins // 2), lut.miss, 1.0, device)


def make_windowed_scan_filter(
    grid: OccupancyGrid,
    lf_params: LikelihoodFieldParams = LikelihoodFieldParams(),
    motion_params: Any = DifferentialDriveParams(),
    k_bins: int = 64,
    win=128,
    dth: float = 2.0 * 3.141592653589793 / 128.0,
    max_point_radius: float = 4.0,
    tile: int = 512,
    tblk: int = 16,
    coverage_threshold: float = 0.98,
    recovery_candidates: int = 0,
    exact_tail_frac: float = 0.125,
    table_dtype: str = "bf16",
    fused: bool = False,
    device=None,
):
    """Likelihood-field AMCL through the windowed per-scan pose LUT, the
    single (mega) filter's tracking path (builders.py:312-573):
    ``(models, ctx)`` on ``device`` (default ``"cuda"``), with ``ctx =
    {'grid', 'field', 'field_codes', 'field_pad3', 'winlut_dft',
    'winlut_geometry'}``.

    Per update the reweight builds a ``k_bins × win`` pose-likelihood
    window around the propagated cloud's mean and scores each particle
    with one trilinear lookup (kernel B6).  A coverage gate, taken from the
    window origin before the build, falls back to the exact reweight
    (kernel B1 through ``field_codes``) when the cloud does not fit the
    window; the port takes it on the host from one scalar readback per
    update.  ``coverage_threshold <= 0`` removes the gate and the exact
    branch.  **Hybrid tail**: the last ``exact_tail_frac`` of the slots
    (tile-aligned), where the strays-last sort key pools the stray tail,
    are scored by the exact model, and the gate counts the prefix only.

    ``fused=True`` replaces propagate + reweight with kernel B5: the
    window is built around the *predicted* center (the pre-propagate cloud
    mean composed with the noiseless odometry delta) and one pass samples
    the motion, reads the window and takes the log.  It needs a
    ``DifferentialDriveParams`` motion model and ``exact_tail_frac=0``, as
    the reference does.

    Contracts: one filter only; ``AmclParams(sorted_slots=True)`` so that
    each tile of slots stays within its ``tblk``-bin θ slab.  Only bf16
    tables: ``table_dtype="int8"`` waits for ROADMAP B6-int8, and with
    ``fused=True`` it raises because the reference's fused kernel
    truncates its weights (ROADMAP §C).
    """
    if table_dtype == "int8" and fused:
        raise ValueError(
            "fused=True with table_dtype='int8' is refused: the reference's fused "
            "kernel truncates the tent weights to 0/1 and applies no scale "
            "(pallas_fused_step.py:141, ROADMAP C)")
    if table_dtype == "int8":
        raise NotImplementedError("int8 window tables are not ported (ROADMAP B6-int8)")
    if table_dtype != "bf16":
        raise ValueError(f"unknown table_dtype {table_dtype!r}")
    if fused and not isinstance(motion_params, DifferentialDriveParams):
        raise ValueError("fused=True requires a DifferentialDriveParams motion model "
                         "(the fused kernel samples it)")
    if fused and exact_tail_frac > 0.0:
        raise ValueError("fused=True requires exact_tail_frac=0 (the fused kernel "
                         "scores every slot; strays take the miss weight)")
    geo = dict(k_bins=k_bins, win=win, dth=dth, max_point_radius=max_point_radius)
    propagate = make_motion_fn(motion_params)

    def exact_weights(ctx, states, points, beam_mask):
        return likelihood_field_weights_codebook(ctx["field"], ctx["field_codes"], states,
                                                 points, beam_mask)

    def single(states: SE2) -> int:
        if states.x.dim() != 1:
            raise ValueError("the windowed scan filter runs one filter, not a fleet")
        return states.x.shape[0]

    def window_lut(ctx, points, beam_mask, cx, cy, ct):
        return build_windowed_scan_lut(
            ctx["field"], points, beam_mask, cx, cy, ct, padded_cubed=ctx["field_pad3"],
            dft=ctx["winlut_dft"], **geo)

    def coverage(ctx, states, cx, cy, ct) -> float:
        """The kernel-exact coverage, read back for the host gate."""
        return float(windowed_coverage_tiled_from_center(
            ctx["field"], states, cx, cy, ct, tile=tile, tblk=tblk, **geo))

    def log_weight(ctx, states, points, beam_mask):
        n = single(states)
        s_tail = _exact_tail_slots(n, tile, exact_tail_frac)
        cx, cy = torch.mean(states.x), torch.mean(states.y)
        ct = torch.atan2(torch.mean(states.rot.sin), torch.mean(states.rot.cos))
        prefix = tree_map(lambda leaf: leaf[: n - s_tail], states)
        if coverage_threshold > 0.0 and coverage(ctx, prefix, cx, cy, ct) < coverage_threshold:
            return torch.log(exact_weights(ctx, states, points, beam_mask))
        lut = window_lut(ctx, points, beam_mask, cx, cy, ct)
        w = windowed_scan_lut_weights(lut, prefix, tile=tile, tblk=tblk)
        if s_tail:
            tail = tree_map(lambda leaf: leaf[n - s_tail:], states)
            w = torch.cat([w, exact_weights(ctx, tail, points, beam_mask)])
        # clamp before the log: bf16 ringing can push 1 + Σpz³ to <= 0
        return torch.log(torch.clamp_min(w, 1e-30))

    fused_fn = None
    if fused:
        def fused_fn(ctx, z, states, pose, prev, points, beam_mask):
            single(states)
            dev = states.xy.device
            # predicted window center: the pre-propagate cloud mean composed
            # with the noiseless odometry delta, so the build precedes the
            # kernel (builders.py:483-497)
            delta = (prev.inverse() @ pose).to(dev)
            mean_th = torch.atan2(torch.mean(states.rot.sin), torch.mean(states.rot.cos))
            pred = SE2.from_xytheta(torch.mean(states.x), torch.mean(states.y), mean_th) @ delta
            cx, cy, ct = pred.x, pred.y, pred.theta
            if (coverage_threshold > 0.0
                    and coverage(ctx, states @ delta, cx, cy, ct) < coverage_threshold):
                moved = propagate(ctx, z, states, pose, prev)
                return moved, torch.log(exact_weights(ctx, moved, points, beam_mask))
            lut = window_lut(ctx, points, beam_mask, cx, cy, ct)
            scalars = fused_step_scalars(lut, motion_params, pose, prev, dev)
            xo, yo, co, so, lw = fused_propagate_winlut(
                states.x.contiguous(), states.y.contiguous(), states.theta.contiguous(),
                z.contiguous(), lut.values_t, scalars, tile=tile, tblk=tblk)
            return SE2(torch.stack([xo, yo], -1), SO2(torch.stack([co, so], -1))), lw

    models = AmclModels(
        propagate=propagate,
        log_weight=log_weight,
        random_state=make_grid_random_state_fn(recovery_candidates),
        hash_state=default_hash_state,
        estimate=default_estimate,
        fused_propagate_reweight=fused_fn,
    )
    ctx = update_map_ctx({}, grid.to(resolve_device(device)), lf_params)
    ctx.update(_winlut_ctx(ctx["field"], win, max_point_radius))
    return models, ctx

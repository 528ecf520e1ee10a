"""Constructors wiring models into the AMCL filter (port of the
likelihood-field and beam parts of ``beluga_tpu/filters/builders.py``).

Returns the :class:`AmclModels` table and the ``ctx`` dict that
``filters.amcl.update`` consumes.  :func:`make_likelihood_field_filter`
reads the field through the code table of kernel B1, which is what the
JAX package selects on an accelerator (``lookup_mode="codebook"``), the
bf16 table of kernel B4 (``"codebook16"``, the fleet configuration), the
float table (``"gather"``, ``"onehot"``) or its SVD factors
(``"lowrank"``); with ``prob_model`` it is nav2's ``likelihood_field_prob``
model, through B1-log or B4-log.  :func:`make_shared_scan_filter` scores
every particle from one correlation LUT per scan, built by kernel B9.
:func:`make_windowed_scan_filter` is the single (mega) filter's tracking
path through the windowed pose LUT: kernel B6 (B6-int8 for int8 tables),
or kernel B5 fused with the motion sample, with kernel B1 for the exact
tail and the fallback; :func:`make_winlut_fleet_update` is its fleet form
(one shared LUT, B6, with kernel B4 for the tails and the fallback).
:func:`make_beam_filter` is the beam model's four evaluation paths: the
exact Bresenham march (kernel R1), the range LUT by gather (built by R1),
the range LUT through kernel B7, and the sphere trace (kernel B8).
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
from beluga_tpu_torch.core.particles import tree_map, tree_where
from beluga_tpu_torch.filters.amcl import (
    AmclModels,
    default_estimate,
    default_hash_state,
    update,
)
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.maps.codebook import likelihood_field_codebook
from beluga_tpu_torch.maps.occupancy import OccupancyGrid
from beluga_tpu_torch.models.motion.differential_drive import (
    DifferentialDriveParams,
    diff_drive_decompose,
    diff_drive_propagate,
)
from beluga_tpu_torch.models.motion.omnidirectional import (
    OmnidirectionalDriveParams,
    omni_drive_propagate,
)
from beluga_tpu_torch.models.motion.stationary import stationary_propagate
from beluga_tpu_torch.models.sensor.beam import (
    BeamModelParams,
    beam_log_weights,
    beam_sphere_trace_log_weights,
)
from beluga_tpu_torch.models.sensor.beam_lut import beam_lut_weights, build_range_lut
from beluga_tpu_torch.models.sensor.likelihood_field import (
    LikelihoodFieldParams,
    likelihood_field_prob_weights,
    likelihood_field_weights,
    likelihood_field_weights_codebook,
    likelihood_field_weights_lowrank,
    make_likelihood_field,
)
from beluga_tpu_torch.models.sensor.likelihood_field_lut import (
    build_scan_lut,
    build_scan_lut_fft,
    build_scan_lut_pallas,
    scan_lut_padded,
    scan_lut_weights,
)
from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
    _pad_cells,
    build_windowed_scan_lut,
    precompute_padded_field,
    windowed_coverage_tiled_from_center,
    windowed_dft,
    windowed_scan_lut_weights,
)
from beluga_tpu_torch.ops.cuda_beam import make_distance_cells
from beluga_tpu_torch.ops.cuda_beam_lut import build_lut_bf16
from beluga_tpu_torch.ops.cuda_fused_step import fused_propagate_winlut, pack_scalars
from beluga_tpu_torch.ops.cuda_reweight import build_values3
from beluga_tpu_torch.ops.gather2d import build_device_codebook, encode_table, factorize_table
from beluga_tpu_torch.ops.raycast import VARIANTS, free_plane

LOOKUP_MODES = ("auto", "gather", "onehot", "codebook", "codebook16", "lowrank")
SCAN_LUT_BUILDS = {"roll": build_scan_lut, "pallas": build_scan_lut_pallas,
                   "fft": build_scan_lut_fft}
POOL_CAP = 4096  # rows of kernel B3's pool


def make_motion_fn(motion_params):
    """The propagate function of a motion model (builders.py:40-56):
    ``DifferentialDriveParams``, ``OmnidirectionalDriveParams`` or
    ``"stationary"``; anything else raises ``ValueError``."""
    if isinstance(motion_params, DifferentialDriveParams):
        def propagate(ctx, z, states, pose, prev):
            del ctx
            return diff_drive_propagate(motion_params, z, states, pose, prev)
    elif isinstance(motion_params, OmnidirectionalDriveParams):
        def propagate(ctx, z, states, pose, prev):
            del ctx
            return omni_drive_propagate(motion_params, z, states, pose, prev)
    elif isinstance(motion_params, str) and motion_params == "stationary":
        def propagate(ctx, z, states, pose, prev):
            del ctx, pose, prev
            return stationary_propagate(z, states)
    else:
        raise ValueError(f"unknown motion model: {motion_params!r}")
    return propagate


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


def _estimate_fn(use_cluster_estimate: bool):
    """The cluster estimate of the node path, or the plain weighted mean."""
    if not use_cluster_estimate:
        return default_estimate

    def estimate(params, particles):
        del params
        return cluster_based_estimate(particles.state, particles.weight, particles.mask)

    return estimate


def make_likelihood_field_filter(
    grid: OccupancyGrid,
    lf_params: LikelihoodFieldParams = LikelihoodFieldParams(),
    motion_params: Any = DifferentialDriveParams(),
    prob_model: bool = False,
    use_cluster_estimate: bool = False,
    lookup_mode: str = "auto",
    lowrank_rank: int = 48,
    recovery_candidates: int = 0,
    device=None,
):
    """Likelihood-field AMCL (builders.py:90-189): ``(models, ctx)`` on
    ``device`` (default ``"cuda"``), ``ctx = {'grid', 'field', ...}``.

    ``lookup_mode``: ``"auto"`` or ``"codebook"``, the 8-bit code table
    read by kernel B1 (exact for production fields; ``ctx['field_codes']``);
    ``"codebook16"``, the bf16 pz³ table read by kernel B4 (within 5e-3 of
    the exact weights; the reference's "<=0.2%", builders.py:107-109, is
    the typical error, not a bound; ``ctx['field_values3']``);
    ``"gather"`` or ``"onehot"``, the float table, plain torch;
    ``"lowrank"``, the rank-``lowrank_rank`` SVD factors of the field
    (``ctx['field_factors']``), plain torch.

    ``prob_model``: nav2's ``likelihood_field_prob`` model, log-weights
    ``Σ log pz`` as they are.  In the ``auto``, ``codebook`` and
    ``codebook16`` modes it reads the code table through kernel B1-log, in
    ``codebook16`` the ``bf16(log pz)`` table through kernel B4-log
    (``ctx['field_values3_log']`` is True); in the other modes, as the
    reference, the float table."""
    if lookup_mode not in LOOKUP_MODES:
        raise ValueError(f"unknown lookup_mode {lookup_mode!r}; expected one of {LOOKUP_MODES}")

    if prob_model:
        def log_weight(ctx, states, points, beam_mask):
            return likelihood_field_prob_weights(
                ctx["field"], states, points, beam_mask, codes_book=ctx.get("field_codes"),
                values3=ctx.get("field_values3"))
    elif lookup_mode in ("auto", "codebook", "codebook16"):
        def log_weight(ctx, states, points, beam_mask):
            return torch.log(likelihood_field_weights_codebook(
                ctx["field"], ctx["field_codes"], states, points, beam_mask,
                values3=ctx.get("field_values3")))
    elif lookup_mode == "lowrank":
        def log_weight(ctx, states, points, beam_mask):
            return torch.log(likelihood_field_weights_lowrank(
                ctx["field"], ctx["field_factors"], states, points, beam_mask))
    else:
        def log_weight(ctx, states, points, beam_mask):
            return torch.log(likelihood_field_weights(ctx["field"], states, points, beam_mask,
                                                      lookup_mode=lookup_mode))

    models = AmclModels(
        propagate=make_motion_fn(motion_params),
        log_weight=log_weight,
        random_state=make_grid_random_state_fn(recovery_candidates),
        hash_state=default_hash_state,
        estimate=_estimate_fn(use_cluster_estimate),
    )
    grid = grid.to(resolve_device(device))
    field = make_likelihood_field(lf_params, grid)
    ctx = {"grid": grid, "field": field}
    if lookup_mode in ("auto", "codebook", "codebook16"):
        ctx["field_codes"] = make_field_codes(field, lf_params, grid)
        if lookup_mode == "codebook16":
            ctx["field_values3"] = build_values3(*ctx["field_codes"], log_space=prob_model)
            if prob_model:
                ctx["field_values3_log"] = True
    elif lookup_mode == "lowrank":
        ctx["field_factors"] = factorize_table(field.values, lowrank_rank)
    return models, ctx


def make_field_codes(field, lf_params: LikelihoodFieldParams, grid: OccupancyGrid):
    """``(codes uint8[H, W], codebook f32[256])``: the table's distinct
    values when there are at most 256, else the analytic host proposal
    (maps/codebook.py)."""
    fallback = torch.as_tensor(likelihood_field_codebook(lf_params, grid.resolution))
    book = build_device_codebook(field.values, fallback)
    return encode_table(field.values, book), book


def update_map_ctx(ctx: dict, grid: OccupancyGrid, lf_params: LikelihoodFieldParams) -> dict:
    """Hot-swap the map (amcl_node.cpp:469-471, builders.py:206-225):
    rebuild the field and each map table the ctx holds, on the grid's
    device: the code table (``'field_codes'``), the codebook16 table
    (``'field_values3'``, in log space where ``'field_values3_log'``), the
    SVD factors at their rank (``'field_factors'``), for the windowed
    filter (``'field_pad3'``) its padded pz³ image and DFT matrices from
    the window geometry stored beside them, and for the shared-scan filter
    (``'scan_lut_pad3'``) the padded image its LUT build correlates; keep
    everything else.  The reference keeps a stale ``field_pad3``, so its
    windowed filter goes on scoring the old map; the port does not copy
    that."""
    field = make_likelihood_field(lf_params, grid)
    new_ctx = {**ctx, "grid": grid, "field": field}
    if "field_codes" in ctx:
        new_ctx["field_codes"] = make_field_codes(field, lf_params, grid)
        if "field_values3" in ctx:
            new_ctx["field_values3"] = build_values3(
                *new_ctx["field_codes"], log_space=ctx.get("field_values3_log", False))
    if "field_factors" in ctx:
        new_ctx["field_factors"] = factorize_table(field.values, ctx["field_factors"][0].shape[1])
    if "field_pad3" in ctx:
        new_ctx.update(_winlut_ctx(field, **ctx["winlut_geometry"]))
    if "scan_lut_pad3" in ctx:
        new_ctx["scan_lut_pad3"] = scan_lut_padded(field, **ctx["scan_lut_geometry"])
    return new_ctx


def make_shared_scan_filter(
    grid: OccupancyGrid,
    lf_params: LikelihoodFieldParams = LikelihoodFieldParams(),
    motion_params: Any = DifferentialDriveParams(),
    n_theta: int = 128,
    max_point_radius: float = 4.0,
    lut_build: str | None = None,
    lut_build_kwargs: dict | None = None,
    recovery_candidates: int = 0,
    device=None,
):
    """Likelihood-field AMCL for filters and fleets that score the *same*
    scan (builders.py:228-300): ``(models, ctx, prepare)`` on ``device``
    (default ``"cuda"``), ``ctx = {'grid', 'field', 'scan_lut_pad3',
    'scan_lut_geometry'}``: the padded pz³ image the build correlates is
    made once per map (and again by :func:`update_map_ctx`), not per scan.

    ``prepare(ctx, points, beam_mask) -> ctx`` builds the scan's
    correlation LUT (models/sensor/likelihood_field_lut.py) into
    ``ctx['scan_lut']``; call it once per scan, before the update.  The
    reweight then reads two θ-interpolated LUT entries per particle,
    whatever the beam count, for one filter ``[N]`` or a fleet ``[B, N]``.

    ``lut_build``: ``"pallas"``, kernel B9 (on a CPU grid its plain
    version); ``"roll"``, the reference's shifted accumulations in plain
    torch; ``"fft"``, the spectral build.  The default follows the grid's
    device: ``"pallas"`` on the card, ``"roll"`` on the CPU, as the
    reference picks its Pallas build on its accelerator.
    ``lut_build_kwargs`` go to the build (``sampling="nearest"``,
    ``downsample=2`` for B9)."""
    grid = grid.to(resolve_device(device))
    if lut_build is None:
        lut_build = "pallas" if grid.data.device.type == "cuda" else "roll"
    if lut_build not in SCAN_LUT_BUILDS:
        raise ValueError(f"unknown lut_build: {lut_build!r}")
    build_fn = SCAN_LUT_BUILDS[lut_build]
    extra = dict(lut_build_kwargs or {})

    def log_weight(ctx, states, points, beam_mask):
        del points, beam_mask  # folded into the shared LUT
        return torch.log(scan_lut_weights(ctx["scan_lut"], states))

    def prepare(ctx, points, beam_mask):
        lut = build_fn(ctx["field"], points, beam_mask, n_theta=n_theta,
                       padded_cubed=ctx["scan_lut_pad3"], **extra)
        return {**ctx, "scan_lut": lut}

    models = AmclModels(
        propagate=make_motion_fn(motion_params),
        log_weight=log_weight,
        random_state=make_grid_random_state_fn(recovery_candidates),
        hash_state=default_hash_state,
        estimate=default_estimate,
    )
    field = make_likelihood_field(lf_params, grid)
    geometry = {"max_point_radius": max_point_radius, "lut_build": lut_build,
                "downsample": extra.get("downsample", 1)}
    ctx = {"grid": grid, "field": field, "scan_lut_pad3": scan_lut_padded(field, **geometry),
           "scan_lut_geometry": geometry}
    return models, ctx, prepare


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

    ``table_dtype="int8"`` quantizes the window table (kernel B6-int8); with
    ``fused=True`` it raises because the reference's fused kernel truncates
    its weights (ROADMAP §C).

    Contracts: one filter only; ``AmclParams(sorted_slots=True)`` so that
    each tile of slots stays within its ``tblk``-bin θ slab.
    """
    if table_dtype == "int8" and fused:
        raise ValueError(
            "fused=True with table_dtype='int8' is refused: the reference's fused "
            "kernel truncates the tent weights to 0/1 and applies no scale "
            "(pallas_fused_step.py:141, ROADMAP C)")
    if table_dtype not in ("bf16", "int8"):
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
            ctx["field"], points, beam_mask, cx, cy, ct, table_dtype=table_dtype,
            padded_cubed=ctx["field_pad3"], dft=ctx["winlut_dft"], **geo)

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
    grid = grid.to(resolve_device(device))
    field = make_likelihood_field(lf_params, grid)
    ctx = {"grid": grid, "field": field, "field_codes": make_field_codes(field, lf_params, grid),
           **_winlut_ctx(field, win, max_point_radius)}
    return models, ctx


def make_winlut_fleet_update(
    params,
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
    recovery_candidates: int = 256,
    exact_tail_frac: float = 0.125,
    device=None,
):
    """Fleet AMCL through one shared windowed pose LUT an update, for B
    filters that score the same scan (builders.py:576-737): ``(step, ctx)``
    on ``device`` (default ``"cuda"``), with ``step(ctx, state, odoms,
    points, masks, draws=None) -> (state, estimate)`` shaped like
    ``parallel.fleet.make_fleet_update``'s, ``state`` a ``[B, N]`` fleet.

    Per update:

      1. each filter's particles composed with its noiseless odometry
         delta (the deterministic part of the motion), and the fleet-global
         mean of those predicted poses as the window's centre;
      2. each filter's kernel-exact coverage of the window (its exact tail
         left out), all filters in one launch of kernel B6's coverage
         entry, and the gate on their minimum: one diverged filter trips
         the exact branch;
      3. the fast branch: one windowed LUT build for the fleet (the scan of
         filter 0), then every filter's prefix through one launch of B6's
         states entry and its exact tail through the codebook16 model
         (kernel B4); the exact branch: the codebook16 fleet step (B4).

    The reference's ``lax.cond`` (taken outside its fleet ``vmap``) is one
    host branch here on one readback of the minimum coverage, as the
    windowed filter takes its gate; ``coverage_threshold <= 0`` removes the
    gate and the readback.  The reference runs the codebook16 model on its
    accelerator and the float table elsewhere; the port runs B4 on every
    device (its plain version on the CPU).  The JAX package's measurement
    that this path does not beat the codebook16 fleet at 64 x 4096 is a
    TPU one.

    Contracts: every filter carries the same scan (``points[0]`` and
    ``masks[0]`` feed the build); ``params.sorted_slots`` (per-tile θ
    slabs); each filter's prefix ``N - s_tail`` a whole number of tiles,
    so that the flat ``[B·(N - s_tail)]`` lookup has no tile across two
    filters."""
    if not params.sorted_slots:
        raise ValueError(
            "make_winlut_fleet_update requires AmclParams(sorted_slots=True): "
            "the winlut kernel windows each lane tile to a theta slab"
        )
    n = params.max_particles
    s_tail = _exact_tail_slots(n, tile, exact_tail_frac)
    if (n - s_tail) % tile:
        raise ValueError(
            f"{n - s_tail} prefix slots a filter is not a multiple of tile={tile}: a tile of "
            f"the fleet's flat lookup would straddle two filters"
        )
    geo = dict(k_bins=k_bins, win=win, dth=dth, max_point_radius=max_point_radius)
    # the exact branch: the codebook16 fleet configuration
    models_exact, ctx = make_likelihood_field_filter(
        grid, lf_params, motion_params, lookup_mode="codebook16",
        recovery_candidates=recovery_candidates, device=device)
    ctx.update(_winlut_ctx(ctx["field"], win, max_point_radius))

    def log_weight_fast(fctx, states, points, beam_mask):
        lead = tuple(states.x.shape[:-1])
        prefix = tree_map(lambda leaf: leaf[..., : n - s_tail, :], states)
        flat = SE2(prefix.xy.reshape(-1, 2), SO2(prefix.rot.z.reshape(-1, 2)))
        w = windowed_scan_lut_weights(fctx["winlut"], flat, tile=tile, tblk=tblk)
        log_w = torch.log(torch.clamp_min(w.reshape(*lead, n - s_tail), 1e-30))
        if s_tail:
            tail = tree_map(lambda leaf: leaf[..., n - s_tail:, :], states)
            log_w = torch.cat([log_w, models_exact.log_weight(fctx, tail, points, beam_mask)],
                              dim=-1)
        return log_w

    models_fast = models_exact._replace(log_weight=log_weight_fast)

    def step(ctx, state, odoms, points, masks, draws=None):
        field = ctx["field"]
        # noiseless motion prediction: state ∘ (prev⁻¹ ∘ odom) per filter;
        # the host deltas cross in one copy from pinned memory, which does
        # not wait on the stream
        seeded = torch.as_tensor(np.asarray(state.control_seeded))
        delta = tree_where(seeded, state.control_prev, odoms).inverse() @ odoms
        packed = torch.cat([delta.xy, delta.rot.z], dim=-1)[..., None, :]
        if field.values.is_cuda:
            packed = packed.pin_memory().to(field.values.device, non_blocking=True)
        predicted = state.particles.state @ SE2(packed[..., :2], SO2(packed[..., 2:]))
        cx, cy = torch.mean(predicted.x), torch.mean(predicted.y)
        ct = torch.atan2(torch.mean(predicted.rot.sin), torch.mean(predicted.rot.cos))
        if coverage_threshold > 0.0:
            prefix = tree_map(lambda leaf: leaf[..., : n - s_tail, :], predicted)
            cov = windowed_coverage_tiled_from_center(field, prefix, cx, cy, ct, tile=tile,
                                                      tblk=tblk, **geo)
            if float(torch.amin(cov)) < coverage_threshold:  # the gate's one readback
                return update(params, models_exact, ctx, state, odoms, points, masks, draws)
        lut = build_windowed_scan_lut(field, points[0], masks[0], cx, cy, ct,
                                      padded_cubed=ctx["field_pad3"], dft=ctx["winlut_dft"],
                                      **geo)
        return update(params, models_fast, {**ctx, "winlut": lut}, state, odoms, points,
                      masks, draws)

    step.models_fast, step.models_exact = models_fast, models_exact  # the two branches' tables
    return step, ctx


def sphere_trace_steps(max_range: float, resolution: float) -> int:
    """The sphere trace's march budget, ``2·sqrt(max_range / res)`` cells
    clipped to [20, 96] (builders.py:778-785): a beam that exhausts it
    scores the max range, and 20 steps cover only ~10 m at 5 cm cells."""
    return int(min(96, max(20, 2.0 * (max_range / resolution) ** 0.5)))


def make_beam_filter(
    grid: OccupancyGrid,
    beam_params: BeamModelParams | None = None,
    motion_params: Any = DifferentialDriveParams(),
    use_range_lut: bool | str = False,
    n_bearings: int = 128,
    use_cluster_estimate: bool = False,
    use_sphere_trace: bool = False,
    raycast_variant: str = "standard",
    recovery_candidates: int = 0,
    device=None,
):
    """Beam-model AMCL (builders.py:741-839): ``(models, ctx)`` on
    ``device`` (default ``"cuda"``).

    Paths, one filter or a fleet of ``[B, N]`` each:
      * default: the exact Bresenham march of every (particle, beam) ray,
        the whole model in one launch of kernel R1's exact entry
        (``raycast_variant`` ``"standard"`` or ``"supercover"``);
        ``ctx = {'grid'}``, the grid's packed free mask
        (``ops.raycast.free_plane``) made here, once a map;
      * ``use_range_lut=True``: the per-map CDDT range LUT of ``n_bearings``
        bins, built by R1 and read by a gather (bearing-quantization
        error); ``ctx = {'grid', 'range_lut'}``;
      * ``use_range_lut="windowed"``: the same LUT in bf16 through kernel
        B7, the fleet-scale tracking path; strays outside their block's
        window score as if every cast missed; ``ctx`` adds
        ``'range_lut_bf16'``.  The reference falls back to the gather off
        its TPU; the port runs B7, its plain version on the CPU;
      * ``use_sphere_trace=True``: kernel B8 over the distance table, range
        error ~1 cell, a march budget of :func:`sphere_trace_steps`;
        ``ctx = {'grid', 'beam_dist'}``.
    """
    if raycast_variant not in VARIANTS:
        raise ValueError(f"unknown Bresenham variant: {raycast_variant!r}")
    beam_params = beam_params or BeamModelParams()
    grid = grid.to(resolve_device(device))
    if use_sphere_trace:
        march_steps = sphere_trace_steps(beam_params.beam_max_range, grid.resolution)

        def log_weight(ctx, states, points, beam_mask):
            return beam_sphere_trace_log_weights(beam_params, ctx["beam_dist"], ctx["grid"],
                                                 states, points, beam_mask,
                                                 march_steps=march_steps)

        ctx = {"grid": grid, "beam_dist": make_distance_cells(grid.free_mask)}
    elif use_range_lut:
        if use_range_lut not in (True, "windowed"):
            raise ValueError(f"unknown use_range_lut {use_range_lut!r}")

        def log_weight(ctx, states, points, beam_mask):
            w = beam_lut_weights(beam_params, ctx["range_lut"], states, points, beam_mask,
                                 lut_bf16=ctx.get("range_lut_bf16"))
            return torch.log(torch.clamp_min(w, 1e-30))

        lut = build_range_lut(grid, beam_params.beam_max_range, n_bearings)
        ctx = {"grid": grid, "range_lut": lut}
        if use_range_lut == "windowed":
            ctx["range_lut_bf16"] = build_lut_bf16(lut.ranges)
    else:
        def log_weight(ctx, states, points, beam_mask):
            return beam_log_weights(beam_params, ctx["grid"], states, points, beam_mask,
                                    variant=raycast_variant)

        free_plane(grid)  # packed once a map, kept on the grid
        ctx = {"grid": grid}

    models = AmclModels(
        propagate=make_motion_fn(motion_params),
        log_weight=log_weight,
        random_state=make_grid_random_state_fn(recovery_candidates),
        hash_state=default_hash_state,
        estimate=_estimate_fn(use_cluster_estimate),
    )
    return models, ctx

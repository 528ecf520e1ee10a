"""The main-path configurations that ``chip_smoke.py`` drives and
``tools/profile_update.py`` profiles, built in one place.

All run on the synthetic 384x384 arena at 5 cm of ``io/synthetic.py`` (the
numpy copy of ``bench.py:113-178``), along its circle trajectory, with 60
beams per scan:

* :func:`node_config`: ``AmclNode`` at nav2 defaults, started at the first
  truth pose with covariance diag(0.25, 0.25, 0.068);
* :func:`large_filter`: ``bench.py:848-854``'s single filter, 262144
  particles, KLD down to 65536, systematic resampling, pooled recovery;
* :func:`fleet`: the JAX benchmark's fleet (``bench.py:46-49, 180-220``),
  64 filters x 4096 particles, codebook16, theta-sorted slots, a fixed
  count, multinomial resampling, pooled recovery; every filter scores the
  same scan and starts from its own cloud;
* :func:`mega`: the JAX benchmark's headline mega filter
  (``bench.py:247-386``, ``winlut_mega_1x2097152x60``): one filter of
  2097152 particles through the fused windowed kernel B5, k_bins 20, a
  (32, 128) window at dth 2π/64, tile 4096, tblk 20, gate-free, systematic
  and selective resampling, a 4096-state recovery pool; every update is
  forced, and the θ sort runs on every :data:`MEGA_SORT_EVERY`-th
  (``bench.py:313-325``);
* :func:`windowed`: the unfused, coverage-gated windowed filter of
  ``bench.py:880-900``, 262144 particles, k_bins 64, a 128-cell window,
  the hybrid exact tail; every update is forced;
* :func:`node_config` with ``laser_model_type="beam"``: the beam node at
  nav2 defaults (``laser_max_range`` 100 m) in one of its four
  ``beam_fast_path`` modes;
* :func:`beam_fleet`: ``bench.py:678-720``, 64 filters x 4096 particles
  through the windowed range LUT (kernel B7), ``beam_max_range`` 4 m, 128
  bearing bins, θ-sorted slots, a fixed count, multinomial resampling.

:func:`long_range` runs elsewhere: the JAX package's long-range beam row
(``benchmarks/REPORT.md:175-185``, ``tests/test_system_long_range.py``), a
1024² map at 0.1 m with sparse blocks, its arc trajectory and 60 m scans,
2048 particles through the sphere trace (kernel B8), ``sigma_hit`` 0.4,
nav2's alphas, 128 recovery candidates; every update forced.

The mega, windowed and beam-fleet filters start from a θ-sorted cloud
about the first pose (their slots must stay θ-sorted).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

GRID, RES, BEAMS = 384, 0.05, 60
BEAM_MODES = ("exact", "lut", "sphere_trace", "windowed")  # AmclNodeConfig.beam_fast_path
INITIAL_COV = np.diag([0.25, 0.25, 0.068])
RECOVERY_CANDIDATES = 256  # bench.py:190, :850
MEGA_N, WINDOWED_N = 2097152, 262144  # bench.py:266, :884
MEGA_SORT_EVERY = 8  # bench.py:313: sort_now on every 8th update
MEGA_FILTER = dict(k_bins=20, win=(32, 128), dth=2.0 * np.pi / 64.0, max_point_radius=3.6,
                   tile=4096, tblk=20, recovery_candidates=RECOVERY_CANDIDATES,
                   coverage_threshold=0.0, exact_tail_frac=0.0, fused=True)  # bench.py:289-299
# bench.py:886-889, with make_windowed_scan_filter's defaults written out
WINDOWED_FILTER = dict(k_bins=64, win=128, dth=2.0 * np.pi / 128.0, max_point_radius=3.6,
                       tile=512, tblk=16, recovery_candidates=RECOVERY_CANDIDATES,
                       coverage_threshold=0.98, exact_tail_frac=0.125)


class Scans(NamedTuple):
    """The arena, the truth poses of ``scans`` steps and their scans."""

    data: np.ndarray  # int8 occupancy [GRID, GRID]
    xs: np.ndarray
    ys: np.ndarray
    yaws: np.ndarray
    points: np.ndarray  # f32[scans, BEAMS, 2]
    mask: np.ndarray  # bool[scans, BEAMS]


class Workload(NamedTuple):
    """A filter configuration ready to step: per scan ``t``, update with
    odometry ``(xs[t], ys[t], yaws[t])`` and ``points[t]``, ``mask[t]`` (on
    the device; ``[B, BEAMS, ...]`` per scan for a fleet)."""

    scans: Scans
    points: torch.Tensor
    mask: torch.Tensor
    params: Any  # AmclParams
    models: Any  # AmclModels
    ctx: dict
    state: Any  # AmclState


# tests/test_system_long_range.py:40-57, benchmarks/REPORT.md:175-185
LONG_RANGE = dict(cells=1024, res=0.1, n=2048, beam_max_range=60.0, sigma_hit=0.4,
                  alphas=(0.1, 0.05, 0.1, 0.05), recovery_candidates=128,
                  initial_cov=np.diag([0.3, 0.3, 0.05]))
BEAM_FLEET = dict(beam_max_range=4.0, n_bearings=128)  # bench.py:694-699


def arena_scans(scans: int) -> Scans:
    from beluga_tpu_torch.io import synthetic

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    return Scans(data, xs, ys, yaws, pts, mask)


def node_config(s: Scans, **overrides):
    """nav2 defaults, with the initial pose at the first truth; keyword
    arguments override fields (``laser_model_type="beam"``,
    ``beam_fast_path=...`` for the beam node)."""
    from beluga_tpu_torch.io.config import AmclNodeConfig

    return AmclNodeConfig(
        set_initial_pose=True, initial_pose_x=float(s.xs[0]), initial_pose_y=float(s.ys[0]),
        initial_pose_yaw=float(s.yaws[0]), initial_pose_covariance_x=float(INITIAL_COV[0, 0]),
        initial_pose_covariance_y=float(INITIAL_COV[1, 1]),
        initial_pose_covariance_yaw=float(INITIAL_COV[2, 2]), **overrides,
    )


def large_filter(scans: int, device, n: int = 262144, n_min: int = 65536) -> Workload:
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    models, ctx = make_likelihood_field_filter(make_grid(s.data, RES, device=device),
                                               recovery_candidates=RECOVERY_CANDIDATES,
                                               device=device)
    params = AmclParams(max_particles=n, min_particles=n_min, resampling="systematic")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    states = sample_normal_se2(gen, n, host_pose(s.xs[0], s.ys[0], s.yaws[0]), INITIAL_COV)
    return Workload(s, torch.as_tensor(s.points).to(device), torch.as_tensor(s.mask).to(device),
                    params, models, ctx, init_state(gen, states, params, device=device))


def fleet(scans: int, device, batch: int = 64, n: int = 4096) -> Workload:
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    pts = torch.as_tensor(s.points).to(device)[:, None].expand(scans, batch, BEAMS, 2)
    mask = torch.as_tensor(s.mask).to(device)[:, None].expand(scans, batch, BEAMS)
    models, ctx = make_likelihood_field_filter(make_grid(s.data, RES, device=device),
                                               lookup_mode="codebook16",
                                               recovery_candidates=RECOVERY_CANDIDATES,
                                               device=device)
    params = AmclParams(max_particles=n, min_particles=n, sorted_slots=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    state = init_fleet_state(gen, batch, host_pose(s.xs[0], s.ys[0], s.yaws[0]), INITIAL_COV,
                             params, device=device)
    return Workload(s, pts.contiguous(), mask.contiguous(), params, models, ctx, state)


def _sorted_filter(scans: int, device, n: int, seed: int, filter_kw: dict, params_kw: dict):
    from beluga_tpu_torch.core.particles import tree_sort_by
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state
    from beluga_tpu_torch.filters.builders import make_windowed_scan_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    models, ctx = make_windowed_scan_filter(make_grid(s.data, RES, device=device),
                                            device=device, **filter_kw)
    params = AmclParams(max_particles=n, min_particles=n, sorted_slots=True,
                        resampling="systematic", **params_kw)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    states = sample_normal_se2(gen, n, host_pose(s.xs[0], s.ys[0], s.yaws[0]), INITIAL_COV)
    states = tree_sort_by(states.theta, states)
    return Workload(s, torch.as_tensor(s.points).to(device), torch.as_tensor(s.mask).to(device),
                    params, models, ctx, init_state(gen, states, params, device=device))


def mega(scans: int, device, n: int | None = None) -> Workload:
    """The mega filter (``bench.py:289-304``) of ``n`` (default
    :data:`MEGA_N`) particles; step it with ``force_update=True`` and
    ``sort_now=(t % MEGA_SORT_EVERY == 0)``."""
    return _sorted_filter(scans, device, MEGA_N if n is None else n, 3, MEGA_FILTER,
                          dict(recovery_pool=4096, selective_resampling=True))


def windowed(scans: int, device, n: int | None = None) -> Workload:
    """The coverage-gated windowed filter (``bench.py:886-891``) of ``n``
    (default :data:`WINDOWED_N`) particles; step it with
    ``force_update=True``."""
    return _sorted_filter(scans, device, WINDOWED_N if n is None else n, 4, WINDOWED_FILTER, {})


def long_range(scans: int, device) -> Workload:
    """The long-range sphere-trace filter (tests/test_system_long_range.py:
    40-57) of :data:`LONG_RANGE`; step it with ``force_update=True``."""
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state
    from beluga_tpu_torch.filters.builders import make_beam_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams

    cfg = LONG_RANGE
    data = synthetic.long_range_world(cfg["cells"])
    xs, ys, yaws = synthetic.arc_trajectory(scans, cfg["cells"], cfg["res"])
    pts, mask = synthetic.simulate_scans(data, cfg["res"], xs, ys, yaws, BEAMS,
                                         max_range=cfg["beam_max_range"])
    s = Scans(data, xs, ys, yaws, pts, mask)
    models, ctx = make_beam_filter(
        make_grid(data, cfg["res"], device=device),
        BeamModelParams(beam_max_range=cfg["beam_max_range"], sigma_hit=cfg["sigma_hit"]),
        motion_params=DifferentialDriveParams(*cfg["alphas"]), use_sphere_trace=True,
        recovery_candidates=cfg["recovery_candidates"], device=device)
    n = cfg["n"]
    params = AmclParams(max_particles=n, min_particles=n)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    states = sample_normal_se2(gen, n, host_pose(xs[0], ys[0], yaws[0]), cfg["initial_cov"])
    return Workload(s, torch.as_tensor(pts).to(device), torch.as_tensor(mask).to(device),
                    params, models, ctx, init_state(gen, states, params, device=device))


def beam_fleet(scans: int, device, batch: int = 64, n: int = 4096) -> Workload:
    """The windowed beam fleet (bench.py:678-720): ``batch`` filters of
    ``n`` particles through kernel B7; the range LUT is cast here (kernel
    R1 on the card)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.builders import make_beam_filter
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams

    s = arena_scans(scans)
    pts = torch.as_tensor(s.points).to(device)[:, None].expand(scans, batch, BEAMS, 2)
    mask = torch.as_tensor(s.mask).to(device)[:, None].expand(scans, batch, BEAMS)
    models, ctx = make_beam_filter(
        make_grid(s.data, RES, device=device),
        BeamModelParams(beam_max_range=BEAM_FLEET["beam_max_range"]),
        use_range_lut="windowed", n_bearings=BEAM_FLEET["n_bearings"], device=device)
    params = AmclParams(max_particles=n, min_particles=n, sorted_slots=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    state = init_fleet_state(gen, batch, host_pose(s.xs[0], s.ys[0], s.yaws[0]), INITIAL_COV,
                             params, device=device)
    return Workload(s, pts.contiguous(), mask.contiguous(), params, models, ctx, state)


def fleet_odometry(s: Scans, t: int, batch: int):
    """Scan ``t``'s odometry for every filter of a fleet: ``SE2 [batch]``
    on the host."""
    from beluga_tpu_torch.lie import SE2

    return SE2.from_xytheta(np.full(batch, s.xs[t]), np.full(batch, s.ys[t]),
                            np.full(batch, s.yaws[t]), device="cpu")

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
  bearing bins, θ-sorted slots, a fixed count, multinomial resampling;
* :func:`node_config` with ``laser_model_type="likelihood_field_prob"``:
  the probability-model node at nav2 defaults (kernel B1-log);
* :func:`shared_scan`: ``bench.py:916-955``, one filter of 262144
  particles, KLD down to 65536, systematic resampling, through the
  shared-scan LUT (kernel B9: 128 bins, 4 m, nearest sampling, downsample
  2), the LUT rebuilt by ``Workload.prepare`` before every update;
* :func:`fleet` with ``prob_model=True``: the fleet in the probability
  model's codebook16 mode (kernel B4-log);
* :func:`windowed` with ``table_dtype="int8"``: the windowed filter on
  int8 window tables (kernel B6-int8);
* :func:`ndt_scans` with :func:`node_config`: ``NdtAmclNode`` at nav2
  defaults on the 2D NDT map (:func:`ndt_map_2d`: the arena's occupied
  cells fitted at 0.4 m, 287 rows, so the stencil probe runs kernel B10),
  360-beam 3.5 m scans of the circle as point clouds;
* :func:`ndt_fleet`: ``bench.py:780-837``'s NDT fleet, 64 filters x 4096
  particles, a fixed count, 60 points, forced updates, each filter from a
  cloud of diag(0.05, 0.05, 0.02) about the truth; the points are 12 map
  means within 3 m of the truth, 5 points each with 1 cm of noise, in the
  robot frame (the bench draws 60 independent means, which leaves almost
  no cell its 5 points);
* :func:`ndt_clouds` with ``NdtAmclNode3D``: the 3D NDT map
  (:func:`ndt_map_3d`: the occupied cells extruded over z in [0, 2) m at
  0.1 m, fitted at 0.5 m, 996 rows) and each 360-beam scan repeated at ten
  heights, 0.1-1.9 m (3600 points);
* :func:`vdb_filter`: BASELINE config #4 (``bench.py:722-778``), 131072
  SE3 particles x 80 points in the room it builds, ``voxel_size_hint=0.2``
  (kernel B11), KLD down to 32768, forced updates at the identity
  odometry.

* slice 14's cells: :func:`node_config` with nav2's omni model
  (``robot_model_type="nav2_amcl::OmniMotionModel"``) on
  ``arena_scans(n, yaw_offset=π/2)``, the circle strafed; with
  ``robot_model_type="stationary"`` on :func:`still_scans`, forced
  updates at one pose; :func:`large_filter` and :func:`fleet` with
  ``resampling="residual"``; the raw node with ``max_particles=10000``
  (the sparse cluster estimate); :func:`winlut_fleet`
  (``benchmarks/report.py:289-318``), 64 x 4096 through one shared
  windowed LUT.

:func:`arena_ranges` gives the node's raw input for the same circle: LDS-01
ranges (360 beams over 2π, 0.12-3.5 m) and the same returns as 3D clouds;
:func:`arena_map_yaml` writes the arena as a map_server map, for
``load_pgm_yaml`` and the replay tools.

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
SHARED_SCAN_N, SHARED_SCAN_MIN = 262144, 65536  # bench.py:926, :933
SHARED_SCAN_FILTER = dict(n_theta=128, max_point_radius=4.0, lut_build="pallas",
                          lut_build_kwargs=dict(sampling="nearest", downsample=2))  # :928-932


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
    the device; ``[B, BEAMS, ...]`` per scan for a fleet), on the ctx that
    ``prepare(ctx, points[t], mask[t])`` returns where there is one."""

    scans: Scans
    points: torch.Tensor
    mask: torch.Tensor
    params: Any  # AmclParams
    models: Any  # AmclModels
    ctx: dict
    state: Any  # AmclState
    prepare: Any = None  # the shared-scan filter's per-scan LUT build
    # a fleet step in place of filters.amcl.update (the winlut fleet's
    # ``step(ctx, state, odoms, points, masks)``)
    step: Any = None


# tests/test_system_long_range.py:40-57, benchmarks/REPORT.md:175-185
LONG_RANGE = dict(cells=1024, res=0.1, n=2048, beam_max_range=60.0, sigma_hit=0.4,
                  alphas=(0.1, 0.05, 0.1, 0.05), recovery_candidates=128,
                  initial_cov=np.diag([0.3, 0.3, 0.05]))
BEAM_FLEET = dict(beam_max_range=4.0, n_bearings=128)  # bench.py:694-699


def arena_scans(scans: int, yaw_offset: float = 0.0) -> Scans:
    """The arena's circle; ``yaw_offset`` turns the robot's heading away
    from the tangent (``π/2``: it faces outward and strafes the circle)."""
    from beluga_tpu_torch.io import synthetic

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    if yaw_offset:
        yaws = np.arctan2(np.sin(yaws + yaw_offset), np.cos(yaws + yaw_offset))
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, BEAMS)
    return Scans(data, xs, ys, yaws, pts, mask)


def still_scans(scans: int) -> Scans:
    """``scans`` copies of the circle's first pose and scan: a robot that
    stands still (the stationary node's cell)."""
    s = arena_scans(1)
    rep = lambda a: np.repeat(a, scans, axis=0)  # noqa: E731
    return Scans(s.data, rep(s.xs), rep(s.ys), rep(s.yaws), rep(s.points), rep(s.mask))


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


def large_filter(scans: int, device, n: int = 262144, n_min: int = 65536,
                 resampling: str = "systematic") -> Workload:
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    models, ctx = make_likelihood_field_filter(make_grid(s.data, RES, device=device),
                                               recovery_candidates=RECOVERY_CANDIDATES,
                                               device=device)
    params = AmclParams(max_particles=n, min_particles=n_min, resampling=resampling)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    states = sample_normal_se2(gen, n, host_pose(s.xs[0], s.ys[0], s.yaws[0]), INITIAL_COV)
    return Workload(s, torch.as_tensor(s.points).to(device), torch.as_tensor(s.mask).to(device),
                    params, models, ctx, init_state(gen, states, params, device=device))


def shared_scan(scans: int, device, n: int = SHARED_SCAN_N,
                n_min: int = SHARED_SCAN_MIN) -> Workload:
    """The shared-scan filter of ``bench.py:916-955``; before each update
    call ``prepare`` on the scan (the bench folds the build into its step)
    and step with ``force_update=True``."""
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state
    from beluga_tpu_torch.filters.builders import make_shared_scan_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    models, ctx, prepare = make_shared_scan_filter(make_grid(s.data, RES, device=device),
                                                   device=device, **SHARED_SCAN_FILTER)
    params = AmclParams(max_particles=n, min_particles=n_min, resampling="systematic")
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    states = sample_normal_se2(gen, n, host_pose(s.xs[0], s.ys[0], s.yaws[0]), INITIAL_COV)
    return Workload(s, torch.as_tensor(s.points).to(device), torch.as_tensor(s.mask).to(device),
                    params, models, ctx, init_state(gen, states, params, device=device), prepare)


def fleet(scans: int, device, batch: int = 64, n: int = 4096,
          prob_model: bool = False, resampling: str = "multinomial") -> Workload:
    """The codebook16 fleet; ``prob_model`` scores it with the probability
    model (its ``bf16(log pz)`` table, kernel B4-log); ``resampling``
    another strategy (``"residual"``: two passes of kernel B2)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    pts = torch.as_tensor(s.points).to(device)[:, None].expand(scans, batch, BEAMS, 2)
    mask = torch.as_tensor(s.mask).to(device)[:, None].expand(scans, batch, BEAMS)
    models, ctx = make_likelihood_field_filter(make_grid(s.data, RES, device=device),
                                               prob_model=prob_model, lookup_mode="codebook16",
                                               recovery_candidates=RECOVERY_CANDIDATES,
                                               device=device)
    params = AmclParams(max_particles=n, min_particles=n, sorted_slots=True,
                        resampling=resampling)
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


def windowed(scans: int, device, n: int | None = None, table_dtype: str = "bf16") -> Workload:
    """The coverage-gated windowed filter (``bench.py:886-891``) of ``n``
    (default :data:`WINDOWED_N`) particles, on bf16 or int8 window tables;
    step it with ``force_update=True``."""
    return _sorted_filter(scans, device, WINDOWED_N if n is None else n, 4,
                          {**WINDOWED_FILTER, "table_dtype": table_dtype}, {})


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


# benchmarks/report.py:289-318 (config_5_fleet): the winlut fleet at the
# fleet's shape; the rest make_winlut_fleet_update's defaults
WINLUT_FLEET = dict(k_bins=64, win=128, dth=2.0 * np.pi / 128.0, max_point_radius=3.6,
                    tile=512, tblk=16, coverage_threshold=0.98,
                    recovery_candidates=RECOVERY_CANDIDATES, exact_tail_frac=0.125)
# a cloud tight enough that each 512-slot tile fits its 16-bin θ slab, so
# that the gate takes the fast branch (the nav2 posterior's spread does not,
# the reference's own finding, builders.py:593-603)
WINLUT_FLEET_COV = np.diag([0.01, 0.01, 0.002])


def winlut_fleet(scans: int, device, batch: int = 64, n: int = 4096) -> Workload:
    """The winlut fleet (``filters/builders.py:make_winlut_fleet_update``):
    ``batch`` filters of ``n`` particles that score one shared scan through
    one windowed LUT (kernel B6), the exact tails and the fallback through
    codebook16 (kernel B4); θ-sorted slots, a fixed count, multinomial
    resampling, pooled recovery; every filter from its own cloud of
    :data:`WINLUT_FLEET_COV` about the first pose.  Step it with
    ``Workload.step(ctx, state, odoms, points[t], mask[t])``."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.builders import make_winlut_fleet_update
    from beluga_tpu_torch.maps.occupancy import make_grid

    s = arena_scans(scans)
    pts = torch.as_tensor(s.points).to(device)[:, None].expand(scans, batch, BEAMS, 2)
    mask = torch.as_tensor(s.mask).to(device)[:, None].expand(scans, batch, BEAMS)
    params = AmclParams(max_particles=n, min_particles=n, sorted_slots=True)
    step, ctx = make_winlut_fleet_update(params, make_grid(s.data, RES, device=device),
                                         device=device, **WINLUT_FLEET)
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    state = init_fleet_state(gen, batch, host_pose(s.xs[0], s.ys[0], s.yaws[0]),
                             WINLUT_FLEET_COV, params, device=device)
    return Workload(s, pts.contiguous(), mask.contiguous(), params, step.models_fast, ctx,
                    state, step=step)


def fleet_odometry(s: Scans, t: int, batch: int):
    """Scan ``t``'s odometry for every filter of a fleet: ``SE2 [batch]``
    on the host."""
    from beluga_tpu_torch.lie import SE2

    return SE2.from_xytheta(np.full(batch, s.xs[t]), np.full(batch, s.ys[t]),
                            np.full(batch, s.yaws[t]), device="cpu")


# -- slice 13: the node's raw input and the replay tools ---------------------------

LDS_BEAMS, LDS_MIN, LDS_MAX = 360, 0.12, 3.5  # the turtlebot3 LDS-01 (io/replay.py:ScanSpec)
CLOUD_HEIGHT = 0.15  # the sensor's height when a scan is sent as a 3D cloud
REPLAY_START = (GRID * RES / 2 + 1.2, GRID * RES / 2)  # on the arena's circle


class RawScans(NamedTuple):
    """The arena's circle as the node's raw inputs: LaserScan ranges (NaN
    for no return) and the same returns as 3D clouds."""

    scans: Scans
    ranges: np.ndarray  # f32[T, LDS_BEAMS]
    clouds: np.ndarray  # f32[T, LDS_BEAMS, 3], NaN rows for no return
    angle_min: float
    angle_increment: float


def arena_ranges(scans: int) -> RawScans:
    """``scans`` LDS-01 scans of the arena's circle (the DDA simulator of
    ``io/synthetic.py`` at 360 beams)."""
    from beluga_tpu_torch.io import synthetic

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, LDS_BEAMS, LDS_MAX)
    ranges = np.where(mask, np.hypot(pts[..., 0], pts[..., 1]), np.nan).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, LDS_BEAMS, endpoint=False)
    clouds = np.stack([ranges * np.cos(angles), ranges * np.sin(angles),
                       np.full_like(ranges, CLOUD_HEIGHT)], -1).astype(np.float32)
    return RawScans(Scans(data, xs, ys, yaws, pts, mask), ranges, clouds, -np.pi,
                    2 * np.pi / LDS_BEAMS)


def arena_map_yaml(directory) -> str:
    """The arena written as a map_server map (PGM and YAML) in
    ``directory``; returns the YAML's path."""
    from beluga_tpu_torch.io import synthetic

    return synthetic.write_map_yaml(directory, synthetic.tracking_arena(GRID, RES), RES)


# -- slice 6: the NDT and VDB filters --------------------------------------------

NDT_BEAMS = 360  # the NDT workloads' scans: 360 beams at 3.5 m
NDT_CELL_2D, NDT_CELL_3D = 0.4, 0.5
NDT_HEIGHTS = np.arange(0.0, 2.0, 0.1)  # the 3D map's extrusion
CLOUD_HEIGHTS = np.linspace(0.1, 1.9, 10)  # the 3D node's cloud layers
NDT_FLEET = dict(means=12, points_per_mean=5, noise=0.01, radius=3.0,
                 cov=np.diag([0.05, 0.05, 0.02]))  # bench.py:793-809
INITIAL_COV_3D = np.diag([0.25, 0.25, 0.01, 0.001, 0.001, 0.068])
VDB_N, VDB_POINTS = 131072, 80  # bench.py:742-748
VDB_TRUTH = (3.0, 3.0, 0.0, 0.0, 0.0, 0.3)  # bench.py:748-754


def _arena_points() -> np.ndarray:
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.tools.make_ndt_map import grid_to_points

    return grid_to_points(synthetic.tracking_arena(GRID, RES), RES)


def ndt_map_2d(device):
    """The arena's occupied cells fitted at 0.4 m: 287 rows."""
    from beluga_tpu_torch.maps.ndt import make_ndt_map
    from beluga_tpu_torch.tools.make_ndt_map import fit_ndt_cells

    return make_ndt_map(*fit_ndt_cells(_arena_points(), NDT_CELL_2D), NDT_CELL_2D, device)


def ndt_map_3d(device):
    """The arena's occupied cells extruded over z in [0, 2) m at 0.1 m and
    fitted at 0.5 m: 996 rows."""
    from beluga_tpu_torch.maps.ndt import make_ndt_map
    from beluga_tpu_torch.tools.make_ndt_map import fit_ndt_cells

    p2 = _arena_points()
    p3 = np.concatenate([np.c_[p2, np.full(len(p2), z)] for z in NDT_HEIGHTS])
    return make_ndt_map(*fit_ndt_cells(p3, NDT_CELL_3D), NDT_CELL_3D, device)


def ndt_scans(scans: int) -> Scans:
    """The arena circle with 360-beam 3.5 m scans (about 165 hits each)."""
    from beluga_tpu_torch.io import synthetic

    data = synthetic.tracking_arena(GRID, RES)
    xs, ys, yaws = synthetic.circle_trajectory(scans, GRID, RES)
    pts, mask = synthetic.simulate_scans(data, RES, xs, ys, yaws, NDT_BEAMS)
    return Scans(data, xs, ys, yaws, pts, mask)


def ndt_clouds(s: Scans) -> tuple[np.ndarray, np.ndarray]:
    """Each scan's points at ten heights: ``f32[scans, 3600, 3]`` in the base
    frame and their mask (a beam's mask at every height)."""
    layers = [np.concatenate([s.points, np.full((*s.points.shape[:2], 1), z, np.float32)], -1)
              for z in CLOUD_HEIGHTS]
    return (np.concatenate(layers, axis=1).astype(np.float32),
            np.concatenate([s.mask] * len(CLOUD_HEIGHTS), axis=1))


def ndt_fleet_points(ndt_map, truth, seed: int = 0) -> np.ndarray:
    """``f32[60, 2]``: 12 map means within 3 m of ``truth`` (x, y, yaw), 5
    points each with 1 cm of noise, in the robot frame
    (bench.py:793-809 with 5 points a mean, so that 12 cells are live)."""
    cfg = NDT_FLEET
    rng = np.random.default_rng(seed)
    mu = ndt_map.means[:ndt_map.num_cells].cpu().numpy()
    near = mu[np.linalg.norm(mu - np.asarray(truth[:2]), axis=1) < cfg["radius"]]
    sel = np.repeat(near[rng.choice(len(near), cfg["means"], replace=False)],
                    cfg["points_per_mean"], axis=0)
    c, s = np.cos(truth[2]), np.sin(truth[2])
    local = (sel - np.asarray(truth[:2])) @ np.array([[c, -s], [s, c]])
    return (local + rng.normal(0, cfg["noise"], local.shape)).astype(np.float32)


def ndt_fleet(scans: int, device, batch: int = 64, n: int = 4096) -> Workload:
    """The NDT fleet (bench.py:780-837) at the first truth pose of the
    circle; step it with ``force_update`` on every filter at the truth
    odometry (``fleet_odometry(w.scans, 0, batch)``)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.ndt_builders import make_ndt_filter_2d

    s = arena_scans(1)
    truth = (s.xs[0], s.ys[0], s.yaws[0])
    ndt_map = ndt_map_2d(device)
    models, ctx = make_ndt_filter_2d(ndt_map)
    params = AmclParams(max_particles=n, min_particles=n)
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    state = init_fleet_state(gen, batch, host_pose(*truth), NDT_FLEET["cov"], params,
                             device=device)
    pts = torch.as_tensor(ndt_fleet_points(ndt_map, truth)).to(device)
    return Workload(s, pts.expand(batch, *pts.shape).contiguous(),
                    torch.ones((batch, pts.shape[0]), dtype=torch.bool, device=device),
                    params, models, ctx, state)


def vdb_room_points() -> np.ndarray:
    """BASELINE config #4's room (bench.py:734-739): a floor, two walls and
    a pillar as an obstacle cloud."""
    pts = [[x, y, 0.0] for x in np.arange(0, 8, 0.2) for y in np.arange(0, 8, 0.2)]
    for t in np.arange(0, 8, 0.1):
        for z in np.arange(0, 2.5, 0.25):
            pts += [[t, 0.0, z], [0.0, t, z]]
    pts += [[5.0, 5.0, z] for z in np.arange(0, 2.0, 0.2)]
    return np.asarray(pts)


def vdb_filter(scans: int, device, n: int = VDB_N) -> Workload:
    """BASELINE config #4 (bench.py:722-778): the room's distance volume at
    0.2 m (49 x 49 x 21 voxels, 5 m background), its code table, ``n`` SE3
    particles about (3, 3, 0, yaw 0.3) with covariance 0.05·I, KLD down to
    n/4, 80 measurement points; ``points`` ``f32[80, 3]`` and ``mask`` serve
    every update (step with ``force_update`` at ``SE3.identity()``)."""
    from beluga_tpu_torch.core.random import sample_normal_se3
    from beluga_tpu_torch.filters.amcl import AmclParams, init_state
    from beluga_tpu_torch.filters.vdb_builders import make_vdb_filter_3d
    from beluga_tpu_torch.lie import SE3
    from beluga_tpu_torch.maps.voxel import make_distance_grid_from_points

    grid = make_distance_grid_from_points(vdb_room_points(), 0.2, max_distance=5.0,
                                          device=device)
    models, ctx = make_vdb_filter_3d(grid, voxel_size_hint=0.2)
    params = AmclParams(max_particles=n, min_particles=n // 4)
    rng = np.random.default_rng(4)
    meas = np.asarray([[5.0, 5.0, z] for z in np.arange(0, 2.0, 0.2)]
                      + [[t, 0.0, 1.0] for t in np.arange(0, 8, 0.4)]
                      + [[0.0, t, 1.0] for t in np.arange(0, 8, 0.4)])
    sel = meas[rng.integers(0, len(meas), VDB_POINTS)]
    x, y, z, _, _, yaw = VDB_TRUTH
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pts = ((sel - np.array([x, y, z])) @ rot + rng.normal(0, 0.02, sel.shape)).astype(np.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    mean = SE3.from_xyzrpy([x, y, z], VDB_TRUTH[3:], device="cpu")
    states = sample_normal_se3(gen, n, mean, np.eye(6) * 0.05)
    state = init_state(gen, states, params, device=device, odom_identity=SE3.identity())
    return Workload(None, torch.as_tensor(pts).to(device),
                    torch.ones(VDB_POINTS, dtype=torch.bool, device=device),
                    params, models, ctx, state)

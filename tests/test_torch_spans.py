"""The AMCL update's own profiler ranges (``utils/profiling.py:span``): the
stages ``amcl.*``, nested as the calls are, and one ``sync.*`` range around
each call that makes the host wait for the card, on small fleets through
``make_fleet_update`` on the CPU; with no profiler recording, no
``record_function`` at all.  On the card (marked ``cuda``):
``torch.cuda.set_sync_debug_mode("warn")`` reports no synchronizing call
of a fleet update outside a ``sync.*`` block.

The fleets are the benchmark's two configurations (``mclbench/configs``)
at a small size: nav2's likelihood field through the bf16 code table,
fixed counts, theta-sorted slots and pooled recovery; beluga's 2D NDT
model at 360 beams, its recovery a Gaussian about each filter's estimate.
The single mega filter (``tools/workloads.py:mega``, the fused windowed
path) opens ``winlut.build`` and ``winlut.fused`` inside
``amcl.propagate_reweight``, and its own ``sync.*`` ranges.
"""

import ast
import os
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile

import beluga_tpu_torch as bt
from beluga_tpu_torch.filters.amcl import init_fleet_state
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.models.sensor.ndt import NdtModelParams
from beluga_tpu_torch.parallel.fleet import make_fleet_update
from beluga_tpu_torch.tools.make_ndt_map import fit_ndt_cells, grid_to_points
from beluga_tpu_torch.utils import profiling

torch.set_num_threads(1)

PACKAGE = Path(bt.__file__).resolve().parent
SIZE, RES = 384, 0.05  # the benchmark's arena: its NDT map takes the fused kernel
ROBOTS, PARTICLES = 4, 64
STEPS = 6  # poses 0.22 rad apart, each past the gate's 0.2 rad

# the stages of one update (table of PERF.md §3), each with the stage it
# opens in; every other one opens in amcl.update
INSIDE = {"amcl.recovery": "amcl.resample", "amcl.kld": "amcl.resample"}
STAGES = {
    "lf": {"amcl.gate", "amcl.propagate", "amcl.reweight", "amcl.normalize", "amcl.resample",
           "amcl.recovery", "amcl.sort", "amcl.estimate"},
    "ndt": {"amcl.gate", "amcl.propagate", "amcl.reweight", "amcl.normalize", "amcl.resample",
            "amcl.recovery", "amcl.estimate"},
    "lf_kld": {"amcl.gate", "amcl.propagate", "amcl.reweight", "amcl.normalize",
               "amcl.resample", "amcl.recovery", "amcl.kld", "amcl.sort", "amcl.estimate"},
}
# the syncs of one update, in order: a later change that removes one edits
# this list on purpose
SYNCS = {
    "lf": ["sync.motion_coefficients"],
    "ndt": ["sync.motion_coefficients", "sync.recovery_sqrt_cov"],
    "lf_half": ["sync.motion_coefficients", "sync.gate_keep"],
    "lf_kld": ["sync.motion_coefficients"],
}


@pytest.fixture(scope="module")
def world():
    """The synthetic arena, a circle driven at 0.22 rad a step, and the
    scans at each pose for 60 beams (the field) and 360 (NDT)."""
    data = synthetic.tracking_arena(SIZE, RES)
    xs, ys, yaws = synthetic.circle_trajectory(STEPS, SIZE, RES)
    scans = {beams: synthetic.simulate_scans(data, RES, xs, ys, yaws, beams)
             for beams in (60, 360)}
    return dict(data=data, traj=(xs, ys, yaws), scans=scans)


class Fleet:
    """A fleet of ``robots`` filters on ``dev``, every robot at the
    trajectory's pose of each step (standing robots keep an earlier one)."""

    def __init__(self, world, kind: str, dev, robots=ROBOTS, particles=PARTICLES):
        data, (xs, ys, yaws) = world["data"], world["traj"]
        motion = DifferentialDriveParams(0.2, 0.2, 0.2, 0.2)
        if kind == "ndt":
            cells = fit_ndt_cells(grid_to_points(data, RES), 0.4, 6, 0.005)
            models, self.ctx = bt.make_ndt_filter_2d(
                bt.make_ndt_map(*cells, 0.4, dev), NdtModelParams(minimum_likelihood=1e-6),
                motion)
            beams, sorted_slots = 360, False
        else:
            models, self.ctx = make_likelihood_field_filter(
                make_grid(data, RES, device=dev),
                LikelihoodFieldParams(max_obstacle_distance=2.0, max_laser_distance=100.0),
                motion, lookup_mode="codebook16", recovery_candidates=max(particles // 16, 8),
                device=dev)
            beams, sorted_slots = 60, True
        low = particles // 2 if kind == "lf_kld" else particles
        self.params = bt.AmclParams(min_particles=low, max_particles=particles,
                                    resampling="multinomial", sorted_slots=sorted_slots)
        self.update = make_fleet_update(self.params, models)
        self.robots, self.dev, self.traj = robots, dev, (xs, ys, yaws)
        mean = SE2.from_xytheta(*(torch.full((robots,), float(v[0])) for v in self.traj),
                                device=dev)
        self.state = init_fleet_state(0, robots, mean, np.diag([0.01, 0.01, 0.01]),
                                      self.params, device=dev)
        pts, mask = world["scans"][beams]
        self.points = torch.as_tensor(pts, device=dev)
        self.mask = torch.as_tensor(mask, device=dev)
        self.at = np.zeros(robots, np.int64)  # each robot's step

    def inputs(self, moving=None):
        """The next update's odometry and scans: the robots ``moving`` (all
        by default) advance a step, the others stand."""
        moving = np.ones(self.robots, bool) if moving is None else moving
        self.at = np.minimum(self.at + moving, STEPS - 1)
        odom = SE2.from_xytheta(*(torch.as_tensor(v[self.at], dtype=torch.float32)
                                  for v in self.traj), device="cpu")
        idx = torch.as_tensor(self.at, device=self.dev)
        return odom, self.points.index_select(0, idx), self.mask.index_select(0, idx)

    def step(self, moving=None, inputs=None):
        """One fleet update on ``inputs`` (default: :meth:`inputs` of
        ``moving``); returns ``est.valid``."""
        self.state, est = self.update(self.ctx, self.state, *(inputs or self.inputs(moving)))
        return np.asarray(est.valid)


HALF = np.arange(ROBOTS) < ROBOTS // 2


def ranges(prof) -> list:
    """``(name, enclosing amcl.* names)`` of every ``amcl.*`` and ``sync.*``
    range of the profile, in start order."""
    out = []
    events = sorted((e for e in prof.events() if e.name.startswith(("amcl.", "sync."))),
                    key=lambda e: e.time_range.start)
    for e in events:
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("amcl."):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((e.name, chain))
    return out


def profiled(fleet: Fleet, updates: int, moving=None) -> list:
    fleet.step()  # the forced first update, outside the profile
    with profile() as prof:
        for _ in range(updates):
            assert fleet.step(moving).tolist() == (
                [True] * fleet.robots if moving is None else moving.tolist())
    return ranges(prof)


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_each_stage_is_a_range_nested_as_the_calls(world, kind):
    seen = profiled(Fleet(world, kind, "cpu"), 2)
    assert sum(name == "amcl.update" for name, _ in seen) == 2  # one a call
    assert all(chain == [] for name, chain in seen if name == "amcl.update")
    stages = [(name, chain) for name, chain in seen if name not in ("amcl.update",)
              and name.startswith("amcl.")]
    assert {name for name, _ in stages} == STAGES[kind]
    for name, chain in stages:
        parent = INSIDE.get(name, "amcl.update")
        assert chain[0] == parent, (name, chain)
        assert chain[-1] == "amcl.update"
    # every sync range opens inside the update
    assert all(chain and chain[-1] == "amcl.update"
               for name, chain in seen if name.startswith("sync."))


def test_gated_out_filters_are_kept_in_a_select(world):
    seen = profiled(Fleet(world, "lf", "cpu"), 1, moving=HALF)
    names = [name for name, _ in seen]
    assert names.count("amcl.select") == 1
    chain = dict(seen)["amcl.select"]
    assert chain == ["amcl.update"]
    assert dict(seen)["sync.gate_keep"] == ["amcl.select", "amcl.update"]


@pytest.mark.parametrize("kind", sorted(SYNCS))
def test_the_syncs_of_an_update_are_pinned(world, kind):
    half = kind == "lf_half"
    fleet = Fleet(world, "lf" if half else kind, "cpu")
    seen = profiled(fleet, 2, moving=HALF if half else None)
    syncs = [name for name, _ in seen if name.startswith("sync.")]
    assert syncs == SYNCS[kind] * 2


def test_no_record_function_while_no_profiler_records(world, monkeypatch):
    built = []
    real = torch.profiler.record_function

    def counting(name, *args):
        built.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    fleet = Fleet(world, "lf", "cpu")
    fleet.step()
    fleet.step(HALF)
    assert built == []
    assert profiling.span("amcl.update") is profiling.span("sync.gate_keep")  # one null context
    with profile():
        fleet.step()
    assert built[0] == "amcl.update" and "sync.motion_coefficients" in built


# -- on the card ---------------------------------------------------------------------


def sync_blocks() -> dict:
    """``{file: [(first, last line)]}`` of every ``with span("sync.…")``
    block of the package."""
    blocks = {}
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.With) and any(
                    isinstance(item.context_expr, ast.Call)
                    and getattr(item.context_expr.func, "id", None) == "span"
                    and isinstance(item.context_expr.args[0], ast.Constant)
                    and str(item.context_expr.args[0].value).startswith("sync.")
                    for item in node.items):
                blocks.setdefault(str(path), []).append((node.lineno, node.end_lineno))
    return blocks


def test_sync_blocks_are_found():
    blocks = sync_blocks()
    files = {os.path.relpath(f, PACKAGE) for f in blocks}
    assert {"filters/amcl.py", "core/random.py", "models/motion/differential_drive.py"} <= files


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lf", "ndt", "lf_half", "lf_kld"])
def test_every_sync_of_an_update_is_inside_a_sync_range(world, kind):
    """64 robots x 4096 particles: every call that PyTorch's sync debug
    mode reports during one update has a frame of the package inside a
    ``with span("sync.…")`` block.  Prints each site and its syncs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    half = kind == "lf_half"
    fleet = Fleet(world, "lf" if half else kind, torch.device("cuda"), robots=64,
                  particles=4096)
    moving = (np.arange(64) < 32) if half else None
    for _ in range(3):
        fleet.step()
    inputs = fleet.inputs(moving)
    torch.cuda.synchronize()
    caught = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):  # not the mode's own notice
            caught.append([(f.filename, f.lineno) for f in traceback.extract_stack()
                           if f.filename.startswith(str(PACKAGE))] or [(filename, lineno)])

    blocks = sync_blocks()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fleet.step(inputs=inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert caught  # the mode reports: at least the motion coefficients' copy
    sites = {}
    for frames in caught:
        inside = [(f, n) for f, n in frames
                  if any(a <= n <= b for a, b in blocks.get(f, []))]
        assert inside, f"a sync outside every sync range: {frames}"
        f, n = inside[-1]
        key = f"{os.path.relpath(f, PACKAGE)}:{n}"
        sites[key] = sites.get(key, 0) + 1
    print(kind, sites)


# -- the single mega filter ------------------------------------------------------------

MEGA_SMALL = 8192  # two of the configuration's 4096-slot tiles
MEGA_SYNCS = ["sync.winlut_delta", "sync.fused_scalars", "sync.ess_gate"]


def mega_ranges(prof) -> list:
    """``(name, enclosing amcl.* names)`` of every ``amcl.*``, ``winlut.*``
    and ``sync.*`` range, in start order."""
    out = []
    events = sorted((e for e in prof.events()
                     if e.name.startswith(("amcl.", "winlut.", "sync."))),
                    key=lambda e: e.time_range.start)
    for e in events:
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("amcl."):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((e.name, chain))
    return out


class Mega:
    """``tools/workloads.py:mega`` stepped as its docstring says: every
    update forced, the θ sort on every ``MEGA_SORT_EVERY``-th."""

    def __init__(self, dev, n=None, scans=6):
        from beluga_tpu_torch.tools import workloads

        self.w, self.t, self.sort_every = workloads.mega(scans, dev, n), 0, \
            workloads.MEGA_SORT_EVERY
        self.state = self.w.state

    def inputs(self):
        from beluga_tpu_torch.filters.amcl import host_pose

        s = self.w.scans
        return (host_pose(s.xs[self.t], s.ys[self.t], s.yaws[self.t]), self.w.points[self.t],
                self.w.mask[self.t])

    def step(self, inputs=None):
        from beluga_tpu_torch.filters.amcl import update

        self.state, est = update(self.w.params, self.w.models, self.w.ctx,
                                 self.state._replace(force_update=True),
                                 *(inputs or self.inputs()),
                                 sort_now=self.t % self.sort_every == 0)
        self.t += 1
        return est


def test_a_mega_update_opens_the_window_spans():
    """At 8192 particles on the CPU: the window's build and kernel B5 each
    once an update, inside ``amcl.propagate_reweight``; the update's syncs
    pinned, the fused path's two copies beside the ESS gate's readback."""
    mega = Mega("cpu", MEGA_SMALL)
    mega.step()  # the forced first update, outside the profile
    with profile() as prof:
        for _ in range(2):
            mega.step()
    seen = mega_ranges(prof)
    for name in ("winlut.build", "winlut.fused", "sync.winlut_delta", "sync.fused_scalars"):
        chains = [chain for n, chain in seen if n == name]
        assert len(chains) == 2, (name, seen)
        assert all(chain == ["amcl.propagate_reweight", "amcl.update"] for chain in chains)
    assert [n for n, _ in seen if n.startswith("sync.")] == MEGA_SYNCS * 2
    assert not any(n == "amcl.propagate" for n, _ in seen)


@pytest.mark.cuda
def test_every_sync_of_a_mega_update_is_inside_a_sync_range():
    """The mega filter, 2097152 particles, after 3 updates: every call that
    PyTorch's sync debug mode reports during the 4th has a frame of the
    package inside a ``with span("sync.…")`` block.  Prints each site and
    its syncs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    mega = Mega(torch.device("cuda"))
    for _ in range(3):
        mega.step()
    inputs = mega.inputs()
    torch.cuda.synchronize()
    caught = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            caught.append([(f.filename, f.lineno) for f in traceback.extract_stack()
                           if f.filename.startswith(str(PACKAGE))] or [(filename, lineno)])

    blocks = sync_blocks()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mega.step(inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert caught  # at least the ESS gate's readback
    sites = {}
    for frames in caught:
        inside = [(f, n) for f, n in frames
                  if any(a <= n <= b for a, b in blocks.get(f, []))]
        assert inside, f"a sync outside every sync range: {frames}"
        f, n = inside[-1]
        key = f"{os.path.relpath(f, PACKAGE)}:{n}"
        sites[key] = sites.get(key, 0) + 1
    print("mega", sites)

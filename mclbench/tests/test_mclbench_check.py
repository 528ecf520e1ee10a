"""The check that decides ``correct``, on the CPU at a small fleet: the
reference agrees with the port, the control and each fault of the timed
path fail it."""

import numpy as np
import pytest
import torch

from mclbench import harness
from mclbench.reference import common

CELLS = ("lf_fleet.track", "ndt_fleet.track")
ALL_CELLS = CELLS + ("lf_fleet.half_idle",)
SMALL = dict(robots=4, particles=64)


def run(cell, seed=2**31 + 5, **kw):
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", log=lambda line: None,
                            **SMALL, **kw)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_reference_agrees_with_the_port(cell):
    r = run(cell, control=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    failed = [k for k, c in r["control_checks"].items() if c["value"] > c["limit"]]
    assert failed, r["control_checks"]  # the control fails at least one number


def test_a_tick_on_which_no_filter_is_due():
    """At 4 robots an armed tick of half_idle can find every robot standing
    (seed 5): the update propagates none, and the check holds the particles
    kept."""
    r = harness.run_cell("lf_fleet.half_idle", 5, 0.3, False, device="cpu",
                         log=lambda line: None, **SMALL)
    assert r["correct"], r["checks"]
    assert r["checks"]["resample_gap"]["value"] < 1e-6


@pytest.mark.parametrize("cell", CELLS)
def test_sensor_reference_against_the_port_model(cell):
    """The sensor reference on its own, against the port's model table on
    random states about the arena's circle (not the harness's path)."""
    from mclbench import world
    import beluga_tpu_torch as bt
    from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams

    _, _, config, mix = harness.cell_files(cell)
    data = world.tracking_arena(384, 0.05)
    poses = world.lattice_poses(4, 384, 0.05, 1.2)
    pts, mask = world.cast_scans(data, 0.05, poses, config["scan"]["beams"], 3.5, "cpu")
    sensor = harness.importlib.import_module(f"mclbench.sensors.{config['sensor']}")
    models, ctx = sensor.build(config, data, DifferentialDriveParams(), "cpu")

    g = torch.Generator().manual_seed(3)
    xy = torch.as_tensor(poses[:, None, :2], dtype=torch.float32) + 0.3 * torch.randn(
        (4, 128, 2), generator=g)
    th = torch.as_tensor(poses[:, None, 2], dtype=torch.float32) + 0.2 * torch.randn(
        (4, 128), generator=g)
    states = bt.SE2(xy, bt.SO2.exp(th))
    got = models.log_weight(ctx, states, pts, mask).double()
    ref = harness.importlib.import_module(f"mclbench.reference.{config['reference']}")
    reference = ref.Sensor(data, config, "cpu")
    want = reference.log_weight(xy, states.rot.z, pts, mask)
    assert (got - want).abs().max() < 1e-4
    assert reference.gap(got, want, xy, states.rot.z, pts, mask) < 1e-4


def test_likelihood_field_takes_nav2s_mapping():
    """nav2 caps the field's obstacle distance at laser_likelihood_max_dist
    and spreads z_rand over laser_max_range; so do the program and the
    reference."""
    from mclbench import world
    from mclbench.reference.lf_fleet import Sensor
    from mclbench.sensors import likelihood_field

    _, _, config, _ = harness.cell_files("lf_fleet.track")
    lf = config["likelihood_field"]
    p = likelihood_field.params(config)
    assert p.max_obstacle_distance == lf["laser_likelihood_max_dist"] == 2.0
    assert p.max_laser_distance == lf["laser_max_range"] == 100.0
    ref = Sensor(world.tracking_arena(384, 0.05), config, "cpu")
    assert ref.unknown3 == pytest.approx(1e-6)
    assert float(ref.table.min()) == pytest.approx((0.5 / 100) ** 3, rel=1e-2)  # z_rand / 100


def test_ndt_gap_takes_either_cell_at_an_edge():
    """A world mean within EDGE_TOL of a cell edge may take the stencil on
    either side: the gap is the smaller; away from an edge, it is not."""
    from mclbench import world
    from mclbench.reference import ndt_fleet

    _, _, config, _ = harness.cell_files("ndt_fleet.track")
    ref = ndt_fleet.Sensor(world.tracking_arena(384, 0.05), config, "cpu")
    size, f64 = ref.size, torch.float64
    pts = torch.tensor([[[0.81 + 0.05 * i, 0.5 + 0.003 * i] for i in range(8)]])  # along a wall
    mask = torch.ones((1, 8), dtype=torch.bool)
    mean = pts[0].double().mean(0)
    rot = torch.tensor([[[1.0, 0.0]] * 2])
    for row in range(len(ref.means)):  # an edge where the two stencils differ
        kx = int(torch.floor(ref.means[row, 0] / size))
        y = float(ref.means[row, 1] - mean[1])
        # particle 0: its mean's x a hair above the cell's left edge; particle 1: 5 cm above
        xy = torch.tensor([[[kx * size - float(mean[0]) + d, y] for d in (2e-6, 0.05)]],
                          dtype=torch.float32)
        want = ref.log_weight(xy, rot, pts, mask)
        wx, wy, mw, cw = ref._cells(xy[0], rot[0], pts[0], mask[0], f64)
        centre = torch.stack([torch.floor(wx / size), torch.floor(wy / size)], -1).long()
        other = centre.clone()
        other[..., 0] = torch.where(centre[..., 0] == kx, kx - 1, kx)
        across = torch.log1p(ref._likelihood(other, mw, cw, f64).sum(-1))[None]
        if float((across - want).abs().min()) > 1e-3:
            break
    else:
        raise AssertionError("no edge of the map where the stencils differ")
    assert ref.gap(across[:, :1], want[:, :1], xy[:, :1], rot[:, :1], pts, mask) < 1e-12
    assert ref.gap(across[:, 1:], want[:, 1:], xy[:, 1:], rot[:, 1:], pts, mask) > 1e-3


def _unchanged(update):
    def broken(ctx, state, odom, points, masks):
        _, est = update(ctx, state, odom, points, masks)
        return state, est
    return broken


def _half_left_out(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        half = state.particles.log_weight.shape[0] // 2
        keep = torch.arange(state.particles.log_weight.shape[0]) >= half
        from beluga_tpu_torch.core.particles import ParticleSet, tree_where

        old, nw = state.particles, new.particles
        mixed = ParticleSet(tree_where(keep, old.state, nw.state),
                            torch.where(keep[:, None], old.log_weight, nw.log_weight),
                            torch.where(keep, old.active, nw.active))
        return new._replace(particles=mixed), est
    return broken


def _answer_altered(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        import beluga_tpu_torch as bt

        xy = est.pose.xy.clone()
        xy[-1, 0] += 0.05  # one robot's estimate, 5 cm off
        return new, est._replace(pose=bt.SE2(xy, est.pose.rot))
    return broken


def _weights_altered(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        p = new.particles
        w = p.log_weight.clone()
        w[..., 0] += 0.5  # one slot's weight a filter, after the resample
        return new._replace(particles=p.replace(log_weight=w)), est
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered,
                                   _weights_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = run(cell, fault=fault)
    assert not r["correct"], r["checks"]


def test_ks_of_a_multinomial_draw():
    g = torch.Generator().manual_seed(0)
    w = torch.rand(4096, generator=g, dtype=torch.float64) ** 8
    donors = torch.multinomial(w, 4096, replacement=True, generator=g)
    assert common.ks_distance(donors, w) < 2.5
    uniform = torch.randint(0, 4096, (4096,), generator=g)
    assert common.ks_distance(uniform, w) > 10


def test_motion_reference_keeps_still_robots_still():
    z = torch.zeros((1, 3, 5), dtype=torch.float64)
    xy = torch.rand((1, 5, 2), dtype=torch.float64)
    th = torch.rand((1, 5), dtype=torch.float64)
    pose = torch.tensor([[1.0, 2.0, 0.3]], dtype=torch.float64)
    new_xy, new_th = common.motion(z, xy, th, pose, pose, (0.2,) * 4, 0.01)
    assert torch.allclose(new_xy, xy) and torch.allclose(new_th, th)
    moved = torch.tensor([[1.0, 2.26, 0.3]], dtype=torch.float64)
    new_xy, _ = common.motion(z, xy, th, moved, pose, (0.2,) * 4, 0.01)
    assert np.allclose((new_xy - xy).norm(dim=-1).numpy(), 0.26)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_port_passes_and_the_control_fails(card, cell):
    """At the cell's particle count on 64 robots: three seeds, each correct,
    the control failing at least one number on each."""
    for seed in (11, 2**31 + 3, 977):
        r = harness.run_cell(cell, seed, 1.0, False, device=card, robots=64,
                             log=lambda line: None, control=True)
        assert r["correct"], r["checks"]
        assert any(c["value"] > c["limit"] for c in r["control_checks"].values())

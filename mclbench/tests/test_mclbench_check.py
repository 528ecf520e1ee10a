"""The check that decides ``correct``, on the CPU at a small fleet: the
reference agrees with the port, the control and each fault of the timed
path fail it; the donor search against the search over every pair; a
configuration's reference that brings its own check."""

import math
import time

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


def _moved_off(update):
    def broken(ctx, state, odom, points, masks):
        new, est = update(ctx, state, odom, points, masks)
        import beluga_tpu_torch as bt

        p = new.particles  # every particle 5 cm off, after the resample
        return new._replace(particles=p.replace(state=bt.SE2(p.state.xy + 0.05, p.state.rot))), est
    return broken


@pytest.mark.parametrize("all_pairs_max", [common.ALL_PAIRS_MAX, 0])
def test_past_the_all_pairs_size_an_output_with_no_donor_fails_the_draw(monkeypatch,
                                                                         all_pairs_max):
    """Outputs with no reference particle within the radius: at a fleet's
    size the search over every pair finds their donors; past it they read
    the index -1 and ``resample_gap`` the radius, above every limit."""
    monkeypatch.setattr(common, "ALL_PAIRS_MAX", all_pairs_max)
    r = run("lf_fleet.track", fault=_moved_off)
    assert not r["correct"], r["checks"]
    gap = r["checks"]["resample_gap"]
    assert gap["value"] > gap["limit"]
    assert (gap["value"] == common.NEAREST_RADIUS) == (all_pairs_max == 0)
    assert math.isfinite(r["checks"]["resample_ks"]["value"])


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_past_the_all_pairs_size_a_sound_run_passes(monkeypatch, cell):
    """The grid's search in every filter, recovery states (index -1 where
    no donor lies within the radius) left to the free cells' distance."""
    monkeypatch.setattr(common, "ALL_PAIRS_MAX", 0)
    r = run(cell)
    assert r["correct"], r["checks"]


def test_a_reference_whose_check_loads_jax_gives_no_result(monkeypatch):
    """A module of JAX loaded by a configuration's own check, after the
    window: the run ends with no result."""
    import sys
    import types

    from mclbench.reference import lf_fleet

    def own(*args, **kw):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return {"motion_gap": 0.0}

    monkeypatch.setattr(lf_fleet, "check", own, raising=False)
    with pytest.raises(SystemExit, match="flax"):
        run("lf_fleet.track")


def test_a_reference_that_defines_check_brings_its_own(monkeypatch):
    from mclbench.reference import lf_fleet

    calls = []

    def own(records, inputs, sensor, config, device, low=False, seed=0):
        calls.append(low)
        return {"motion_gap": 1.0 if low else 0.0}

    monkeypatch.setattr(lf_fleet, "check", own, raising=False)
    r = run("lf_fleet.track", control=True)
    assert calls == [False, True]
    assert r["correct"] and r["checks"] == {"motion_gap": {"value": 0.0, "limit": 0.003}}
    assert r["control_checks"] == {"motion_gap": {"value": 1.0, "limit": 0.003}}


def test_a_reference_without_check_takes_the_common_one(monkeypatch):
    from mclbench.reference import lf_fleet

    assert not hasattr(lf_fleet, "check")
    calls, common_check = [], common.check

    def spy(*args, **kw):
        calls.append(kw.get("low", False))
        return common_check(*args, **kw)

    monkeypatch.setattr(common, "check", spy)
    r = run("lf_fleet.track", control=True)
    assert calls == [False, True] and r["correct"], r["checks"]


def test_every_resample_gap_limit_lies_below_the_donor_search_radius():
    bench = harness.load(harness.BENCHMARK)
    for c in bench["configs"]:
        limits = harness.load(harness.HERE.parent / c["file"])["limits"]
        assert limits.get("resample_gap", 0.0) < common.NEAREST_RADIUS, c["name"]


# -- the donor search ------------------------------------------------------------------

def _all_pairs_as_before(out_xy, out_th, ref_xy, ref_th, chunk=1024):
    """The donor search before the grid, kept here as it was: every pair."""
    dist, idx = [], []
    for s in range(0, out_xy.shape[0], chunk):
        d = common.pose_gap(out_xy[s:s + chunk, None], out_th[s:s + chunk, None], ref_xy[None],
                            ref_th[None])
        m = d.min(-1)
        dist.append(m.values)
        idx.append(m.indices)
    return torch.cat(dist), torch.cat(idx)


@pytest.fixture
def one_thread():
    """The search over every pair reads the same bits as the grid's on the
    CPU in one thread (a thread's share of ``atan2`` may end on its scalar
    path); on the card at any size."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud(m, g, sd_xy, sd_th):
    """``m`` reference states about heading π, unwrapped as the reference's
    motion gives them."""
    xy = torch.randn((m, 2), generator=g, dtype=torch.float64) * torch.tensor(sd_xy,
                                                                              dtype=torch.float64)
    return xy, math.pi + sd_th * torch.randn(m, generator=g, dtype=torch.float64)


def _as_program(xy, th):
    """States as the program holds them: float32, the heading from its
    rotation, in [-π, π]."""
    th = th.float()
    return xy.float().double(), torch.atan2(torch.sin(th), torch.cos(th)).double()


def test_nearest_equals_the_search_over_every_pair(one_thread, monkeypatch):
    """4096 x 4096 (a fleet filter's size), searched over every pair as
    before, and by the grid (``ALL_PAIRS_MAX`` 0): exact copies of
    duplicated reference states, float32 copies across ±π, headings a few
    mrad off (also searched one output at a time), ties, outputs beyond
    the radius near the cloud and far from it."""
    g = torch.Generator().manual_seed(7)
    ref_xy, ref_th = _cloud(4096, g, (0.05, 0.05), 0.3)
    ref_xy[100:200], ref_th[100:200] = ref_xy[:100], ref_th[:100]  # duplicates
    pair = torch.arange(300, 556, 2)  # pairs 2^-11 m apart in x, all else equal
    step = torch.tensor([2.0 ** -11, 0.0], dtype=torch.float64)
    ref_xy[pair] = torch.round(ref_xy[pair] * 1024) / 1024
    ref_xy[pair + 1], ref_th[pair + 1] = ref_xy[pair] + step, ref_th[pair]
    k = torch.randint(0, 4096, (4096,), generator=g)
    out_xy, out_th = ref_xy[k].clone(), ref_th[k].clone()
    out_xy[:100], out_th[:100] = ref_xy[100:200], ref_th[100:200]  # the second of each duplicate
    out_xy[1024:2048], out_th[1024:2048] = _as_program(out_xy[1024:2048], out_th[1024:2048])
    # 5-10 mrad off in heading alone, each where it can be: where atan2's vector and
    # scalar paths part in the last bit on this CPU (if they ever do)
    turned = slice(1024, 1280)
    base = ref_th[k[turned], None]
    tries = base + 5e-3 + 5e-3 * torch.rand((256, 256), generator=g, dtype=torch.float64)
    s, c = torch.sin(tries - base), torch.cos(tries - base)
    parts = torch.atan2(s, c) != torch.atan2(torch.stack([s, s], -1)[..., 0],
                                             torch.stack([c, c], -1)[..., 0])
    out_xy[turned] = ref_xy[k[turned]]
    out_th[turned] = tries[torch.arange(256), parts.int().argmax(1)]
    ties = slice(2048, 2048 + len(pair))  # midway between the two of a pair
    out_xy[ties] = ref_xy[pair] + step / 2
    out_th[ties] = ref_th[pair]
    out_xy[2560:3072, 0] += 0.05
    out_xy[3072:, 0] += 1.0

    want_dist, want_idx = _all_pairs_as_before(out_xy, out_th, ref_xy, ref_th)
    dist, idx = common.nearest(out_xy, out_th, ref_xy, ref_th)
    assert torch.equal(dist, want_dist) and torch.equal(idx, want_idx)
    assert int((dist > common.NEAREST_RADIUS).sum()) >= 1024  # searched over every pair

    monkeypatch.setattr(common, "ALL_PAIRS_MAX", 0)
    within = want_dist <= common.NEAREST_RADIUS
    dist, idx = common.nearest(out_xy, out_th, ref_xy, ref_th)
    assert torch.equal(dist[within], want_dist[within]) and torch.equal(idx[within],
                                                                          want_idx[within])
    assert bool((dist[~within] == common.NEAREST_RADIUS).all() and (idx[~within] == -1).all())
    for i in range(turned.start, turned.stop):  # a few pairs a search
        one = common.nearest(out_xy[i:i + 1], out_th[i:i + 1], ref_xy, ref_th)
        assert torch.equal(one[0], want_dist[i:i + 1]) and torch.equal(one[1], want_idx[i:i + 1])
    assert torch.equal(idx[:100], torch.arange(100)) and bool((dist[:100] == 0).all())
    assert int((idx[ties] == pair).sum()) >= 100  # the first of a tie


def test_nearest_past_the_all_pairs_size(one_thread):
    """2^18 x 2^18 in a cloud as wide as the mega filter's: exact within the
    radius (copies, and a sample of outputs 2 cm off against every pair),
    the radius and the index -1 beyond it."""
    n = 1 << 18
    g = torch.Generator().manual_seed(8)
    ref_xy, ref_th = _cloud(n, g, (0.25, 0.22), 0.31)
    ref_xy[1::64], ref_th[1::64] = ref_xy[::64], ref_th[::64]  # duplicates
    k = torch.randint(0, n, (n,), generator=g)
    dist, idx = common.nearest(ref_xy[k], ref_th[k], ref_xy, ref_th)
    assert bool((dist == 0).all())
    assert torch.equal(idx, torch.where(k % 64 == 1, k - 1, k))

    out_xy = ref_xy[k] + torch.tensor([0.02, 0.0], dtype=torch.float64)
    dist, idx = common.nearest(out_xy, ref_th[k], ref_xy, ref_th)
    some = torch.randperm(n, generator=g)[:64]
    want_dist, want_idx = _all_pairs_as_before(out_xy[some], ref_th[k][some], ref_xy, ref_th)
    within = want_dist <= common.NEAREST_RADIUS
    assert 0 < int(within.sum()) < len(some)
    assert torch.equal(dist[some][within], want_dist[within])
    assert torch.equal(idx[some][within], want_idx[within])
    assert bool((dist[some][~within] == common.NEAREST_RADIUS).all())
    assert bool((idx[some][~within] == -1).all())

    clear = ref_xy[k] + torch.tensor([float(ref_xy[:, 0].max() - ref_xy[:, 0].min()) + 0.02,
                                      0.0], dtype=torch.float64)
    dist, idx = common.nearest(clear, ref_th[k], ref_xy, ref_th)
    assert bool((dist == common.NEAREST_RADIUS).all()) and bool((idx == -1).all())


@pytest.mark.cuda
def test_on_the_card_the_donor_search_takes_the_mega_filter(card):
    """The port's mega filter, 2097152 particles, after 24 forced updates
    (the θ sort on every 8th), then a 25th that resamples (the ESS gate
    off) and injects its whole recovery pool of 4096 (Thrun's slow filter
    set far above the fast one).  On that update every output is a
    bit-equal copy of a propagated particle (distance 0, the donors
    following the weights) or a recovery state (the radius and -1 where no
    propagated particle lies within it); outputs 2 cm off agree with the
    search over every pair on a sample, and the copies shifted clear of the
    cloud read the radius; each search within 10 s and 4 GB beyond its inputs.  The other
    shared pieces run at this size."""
    import dataclasses

    from beluga_tpu_torch.algorithms.thrun import ExpFilterState, ThrunState
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.tools import workloads

    w = workloads.mega(25, card)
    kept = {}
    fused, random_state = w.models.fused_propagate_reweight, w.models.random_state

    def keep_prop(*args):
        out = fused(*args)
        kept["prop"], kept["loglik"] = out
        return out

    def keep_pool(*args):
        kept["pool"] = random_state(*args)
        return kept["pool"]

    models = w.models._replace(fused_propagate_reweight=keep_prop, random_state=keep_pool)
    params, state, s = w.params, w.state, w.scans
    for t in range(25):
        if t == 24:
            params = dataclasses.replace(params, selective_resampling=False)
            seeded = torch.tensor(True, device=card)
            state = state._replace(thrun=ThrunState(
                ExpFilterState(torch.tensor(1.0, device=card), seeded),
                ExpFilterState(torch.tensor(0.0, device=card), seeded)))
            in_logw = state.particles.log_weight
        state, _ = update(params, models, w.ctx, state._replace(force_update=True),
                          host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t],
                          sort_now=t % workloads.MEGA_SORT_EVERY == 0)
    prop, out, pool = kept["prop"], state.particles.state, kept["pool"]
    f64 = torch.float64
    ref_xy, ref_th = prop.xy.to(f64), common.heading(prop.rot.z.to(f64))
    out_xy, out_th = out.xy.to(f64), common.heading(out.rot.z.to(f64))
    pool_xy, pool_th = pool.xy.to(f64), common.heading(pool.rot.z.to(f64))
    weights = torch.softmax(in_logw.to(f64) + kept["loglik"].to(f64), -1)
    del w, models, state, kept, prop, out, pool, in_logw
    torch.cuda.empty_cache()

    def search(o_xy, o_th, what):
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
        base = torch.cuda.memory_allocated(card)
        t0 = time.perf_counter()
        found = common.nearest(o_xy, o_th, ref_xy, ref_th)
        torch.cuda.synchronize(card)
        seconds = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated(card) - base
        print(f"nearest at {len(o_xy)} x {len(ref_xy)}, {what}: {seconds} s, {extra} B beyond "
              f"its inputs ({torch.cuda.get_device_name(card)})")
        assert seconds <= 10.0 and extra <= 4e9
        return found

    dist, idx = search(out_xy, out_th, "the resampled update's outputs")
    copies = dist == 0
    rest = torch.nonzero(~copies).squeeze(1)
    donors = idx[idx >= 0]
    ks = common.ks_distance(donors, weights)
    print(f"{int(copies.sum())} copies ({len(torch.unique(idx[copies]))} donors), "
          f"{len(rest)} other outputs, {int((idx == -1).sum())} with no donor within the "
          f"radius; resample_ks over the donors {ks}")
    assert torch.equal(ref_xy[idx[copies]], out_xy[copies])
    assert torch.equal(ref_th[idx[copies]], out_th[copies])
    assert len(torch.unique(idx[copies])) < int(copies.sum())  # the draw duplicated donors
    assert ks < 2.0
    # the rest are the pool's recovery states, bit for bit, nearly all far from the cloud
    assert 4000 <= len(rest) <= 4096
    on_pool, _ = common.nearest(out_xy[rest], out_th[rest], pool_xy, pool_th)
    assert bool((on_pool == 0).all())
    assert bool(((idx[rest] == -1) == (dist[rest] == common.NEAREST_RADIUS)).all())
    assert int((idx[rest] == -1).sum()) >= 4000

    off_xy = out_xy + torch.tensor([0.02, 0.0], dtype=f64, device=card)
    dist, idx = search(off_xy, out_th, "2 cm off")
    some = torch.randperm(len(out_xy), generator=torch.Generator().manual_seed(0))[:128]
    some = some.to(card)
    want_dist, want_idx = _all_pairs_as_before(off_xy[some], out_th[some], ref_xy, ref_th,
                                               chunk=16)
    within = want_dist <= common.NEAREST_RADIUS
    print(f"2 cm off: {float((dist <= common.NEAREST_RADIUS).double().mean())} of the outputs "
          f"within the radius of a donor")
    assert torch.equal(dist[some][within], want_dist[within])
    assert torch.equal(idx[some][within], want_idx[within])
    assert bool((dist[some][~within] == common.NEAREST_RADIUS).all())
    assert bool((idx[some][~within] == -1).all())

    span = float(ref_xy[:, 0].max() - ref_xy[:, 0].min())  # the copies, shifted clear of it
    clear = out_xy[copies] + torch.tensor([span + 0.02, 0.0], dtype=f64, device=card)
    dist, idx = search(clear, out_th[copies], "the copies clear of the cloud")
    assert bool((dist == common.NEAREST_RADIUS).all()) and bool((idx == -1).all())

    z = torch.randn((1, 3, len(out_xy)), generator=torch.Generator(card).manual_seed(0),
                    dtype=f64, device=card)
    pose = torch.tensor([[0.3, 0.1, 0.2]], dtype=f64, device=card)
    m_xy, m_th = common.motion(z, out_xy[None], out_th[None], pose, pose * 0.5, (0.2,) * 4, 0.01)
    assert bool(torch.isfinite(m_xy).all() and torch.isfinite(m_th).all())

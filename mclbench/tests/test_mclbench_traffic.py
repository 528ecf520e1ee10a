import math

import numpy as np

from mclbench import generator, world


def _run(mix, robots, seed, n):
    ticks = generator.Ticks(generator.load_mix(mix), robots, seed)
    return [ticks.next() for _ in range(n)]


def test_deterministic_in_seed():
    a, b, c = (_run("half_idle", 64, s, 30) for s in (7, 7, 8))
    for x, y in zip(a, b):
        assert np.array_equal(x.idx, y.idx) and np.array_equal(x.moved, y.moved)
    assert any(not np.array_equal(x.idx, z.idx) for x, z in zip(a, c))


def test_track_every_robot_passes_the_motion_gate():
    mix = generator.load_mix("track")
    poses = world.lattice_poses(mix["lattice"], 384, 0.05, mix["radius"])
    ticks = _run("track", 4096, 2**31 + 11, 5)
    for prev, tick in zip(ticks, ticks[1:]):
        assert tick.moved.all()
        assert np.array_equal(tick.prev_idx, prev.idx)
        assert len(np.unique(tick.idx)) == 4096  # every robot its own pose and scan
        d = poses[tick.idx] - poses[prev.idx]
        dyaw = np.abs(np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2])))
        assert (np.hypot(d[:, 0], d[:, 1]) > 0.25).all() and (dyaw > 0.2).all()  # nav2 defaults


def test_half_idle_stands_about_half():
    ticks = _run("half_idle", 1024, 3, 200)
    standing = np.mean([1.0 - t.moved.mean() for t in ticks[1:]])
    assert 0.4 < standing < 0.6
    for prev, tick in zip(ticks[1:], ticks[2:]):
        still = ~tick.moved
        assert np.array_equal(tick.idx[still], prev.idx[still])


def test_scans_cast_on_the_lattice():
    data = world.tracking_arena(384, 0.05)
    poses = world.lattice_poses(8, 384, 0.05, 1.2)
    pts, mask = world.cast_scans(data, 0.05, poses, 60, 3.5, "cpu")
    assert pts.shape == (8, 60, 2) and mask.shape == (8, 60)
    r = pts.norm(dim=-1)
    assert (r[mask] > 0).all() and (r[mask] <= 3.5 + 1e-5).all() and (r[~mask] == 0).all()
    assert 10 < mask.sum(-1).float().mean() < 50
    assert math.isclose(float(poses[0, 2]), math.pi / 2)

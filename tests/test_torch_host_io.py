"""The port's host IO (``beluga_tpu_torch/io/native.py``, ``io/rosbag.py``,
the node's ``prepare_scan`` / ``prepare_point_cloud``, ``io/viz.py`` and
``utils/metrics.py``) held against the JAX package's on the CPU.

Every comparison is exact: both sides are numpy or the same C++ source,
and each is run in its native form (the host library, the JAX package's
``native/_beluga_io.so`` and the port's own build of
``csrc/host/beluga_io.cc``) and in its numpy form (``_load`` patched to
None on both sides).  The CDR blobs come from the encoders of
``tests/test_rosbag.py`` and the bags from the writers of
``tests/test_system_bag.py``; the maps are the synthetic arena, written
to ``tmp_path``.
"""

import sqlite3

import numpy as np
import pytest
import torch

from beluga_tpu.io import native as j_native
from beluga_tpu.io import rosbag as j_rosbag
from beluga_tpu.io import viz as j_viz
from beluga_tpu.io.config import AmclNodeConfig as JAmclNodeConfig
from beluga_tpu.maps.ndt import make_ndt_map as j_make_ndt_map
from beluga_tpu.node import AmclNode as JAmclNode
from beluga_tpu.utils import metrics as j_metrics
from beluga_tpu_torch.io import native, rosbag, synthetic, viz
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.maps.ndt import make_ndt_map
from beluga_tpu_torch.maps.occupancy import load_pgm_yaml
from beluga_tpu_torch.node import AmclNode
from beluga_tpu_torch.ops.cuda_resample import resample_take_reference
from beluga_tpu_torch.ops.resample import multinomial_positions
from beluga_tpu_torch.utils import metrics
from tests.test_rosbag import encode_laserscan, encode_odometry, encode_pointcloud2
from tests.test_system_bag import _write_bag, _write_cloud_bag

torch.set_num_threads(1)


@pytest.fixture(params=["native", "numpy"])
def form(request, monkeypatch):
    """Both sides in one form: their host libraries, or numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(j_native, "_load", lambda: None)
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native.native_available() and j_native.native_available()
    return request.param


def random_ranges(seed, n=360):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 5.0, n).astype(np.float32)
    r[::17] = np.nan
    r[::23] = np.inf
    r[::29] = -np.inf
    return r


# -- the host library -------------------------------------------------------------


def test_port_builds_its_own_host_library():
    """The port's library is built from its own copy of the source into
    the git-ignored build directory, named by the source's and the flags'
    hash, and is not the JAX package's tracked ``native/_beluga_io.so``."""
    assert native.build_native()
    path = native.library_path()
    assert path.exists() and path.parent.name == "beluga_tpu_torch"
    assert path.parent.parent.name == "build"
    assert path.resolve() != j_native._SO.resolve()
    assert native._SRC.parent.name == "host"


@pytest.mark.parametrize("seed,pose", [(0, (0.0, 0.0, 0.0)), (1, (0.1, -0.05, 0.3)),
                                       (2, (-0.2, 0.15, -2.5))])
def test_scan_to_points(form, seed, pose):
    args = (random_ranges(seed), -np.pi, 2 * np.pi / 360, 0.12, 3.5, pose)
    pts, mask = native.scan_to_points(*args)
    j_pts, j_mask = j_native.scan_to_points(*args)
    assert pts.dtype == np.float32 and mask.dtype == bool
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(pts, j_pts)
    assert 0.2 < mask.mean() < 0.9


def test_take_evenly_indices(form):
    for n, k in [(4, 2), (5, 3), (6, 3), (9, 3), (4, 3), (10, 6), (4, 10), (4, 1), (0, 1),
                 (4, 0), (1, 5), (360, 60), (3600, 60), (1000, 999), (7, 7)]:
        np.testing.assert_array_equal(native.take_evenly_indices(n, k),
                                      j_native.take_evenly_indices(n, k))
    np.testing.assert_array_equal(native.take_evenly_indices(10, 6), [0, 2, 4, 6, 8, 9])


def test_decode_pgm_trinary(form, tmp_path):
    """The native PGM decoder against the JAX package's, and both against
    the map the port's loader reads from the same file; the numpy form is
    the loader itself (the decoder returns None in both packages)."""
    data = synthetic.tracking_arena(96, 0.2, seed=4)
    data[5:9, 10:20] = -1  # unknown cells too
    yaml_path = synthetic.write_map_yaml(tmp_path, data, 0.2)
    blob = (tmp_path / "arena.pgm").read_bytes()
    got, want = native.decode_pgm_trinary(blob), j_native.decode_pgm_trinary(blob)
    if form == "numpy":
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data)
        assert native.decode_pgm_trinary(b"P2\n1 1\n255\n0") is None
    np.testing.assert_array_equal(load_pgm_yaml(yaml_path, device="cpu").data.numpy(), data)


# -- CDR decoding -----------------------------------------------------------------


def cloud_blobs():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(24, 3)).astype(np.float32)
    pts[3] = np.nan
    return [encode_pointcloud2(pts), encode_pointcloud2(pts, datatype="f64"),
            encode_pointcloud2(pts, extra_fields=("intensity", "ring"), point_pad=6),
            encode_pointcloud2(pts, height=4, row_pad=10)]


def test_decode_laserscan_odometry_and_stamp(form):
    for ranges in (random_ranges(3, 37), np.asarray([1.0, 2.5, np.inf, 0.5], np.float32)):
        blob = encode_laserscan(ranges, angle_min=-np.pi, angle_inc=2 * np.pi / len(ranges))
        (p, r), (jp, jr) = native.decode_laserscan_cdr(blob), j_native.decode_laserscan_cdr(blob)
        assert p == jp
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(r, ranges)
        assert native.decode_header_stamp_cdr(blob) == j_native.decode_header_stamp_cdr(blob)
    for x, y, yaw in [(1.5, -2.25, 0.7), (0.0, 0.0, -3.1)]:
        blob = encode_odometry(x, y, yaw)
        np.testing.assert_array_equal(native.decode_odometry_cdr(blob),
                                      j_native.decode_odometry_cdr(blob))


def test_decode_pointcloud2(form):
    for blob in cloud_blobs():
        got, want = native.decode_pointcloud2_cdr(blob), j_native.decode_pointcloud2_cdr(blob)
        assert got.shape == (24, 3)
        np.testing.assert_array_equal(got, want)


def test_malformed_blobs_raise(form):
    scan = encode_laserscan([1.0, 2.0, 3.0], intensities=False)
    big = bytearray(scan)
    big[1] = 0x00  # big-endian
    cloud = cloud_blobs()[0]
    for fn, blob in [(native.decode_laserscan_cdr, scan[:12]),
                     (native.decode_laserscan_cdr, bytes(big)),
                     (native.decode_odometry_cdr, encode_odometry(1.0, 2.0, 0.5)[:40]),
                     (native.decode_pointcloud2_cdr, cloud[:40]),
                     (native.decode_pointcloud2_cdr,
                      encode_pointcloud2(np.zeros((2, 3)), field_order=("a", "b", "c")))]:
        with pytest.raises(ValueError):
            fn(blob)


# -- bags -------------------------------------------------------------------------


def scan_stream(t=6, beams=90):
    rng = np.random.default_rng(7)
    traj = np.cumsum(rng.normal(0.1, 0.05, (t, 3)), axis=0)
    scans = rng.uniform(0.1, 3.4, (t, beams)).astype(np.float32)
    scans[rng.random((t, beams)) < 0.2] = np.nan
    return traj, scans


def test_encoders_and_bag_writers_are_the_test_wire_format(tmp_path):
    """The port's encoders give the test oracles' bytes, and its writers
    the same rows as ``tests/test_system_bag.py``'s."""
    pts = np.random.default_rng(1).normal(size=(6, 3))
    assert rosbag.encode_laserscan([1.0, np.nan, 2.0], -1.0, 0.5, 0.1, 4.0) == encode_laserscan(
        [1.0, np.nan, 2.0], -1.0, 0.5, 0.1, 4.0)
    assert rosbag.encode_odometry(1.0, -2.0, 0.3) == encode_odometry(1.0, -2.0, 0.3)
    for kw in ({}, dict(datatype="f64"), dict(extra_fields=("intensity",), point_pad=4),
               dict(height=2, row_pad=3)):
        assert rosbag.encode_pointcloud2(pts, **kw) == encode_pointcloud2(pts, **kw)

    def rows(path):
        with sqlite3.connect(path) as db:
            return (db.execute("SELECT * FROM topics").fetchall(),
                    db.execute("SELECT * FROM messages").fetchall())

    traj, scans = scan_stream(beams=360)
    rosbag.write_scan_bag(tmp_path / "a.db3", traj, scans, -np.pi, 2 * np.pi / 360, 0.12, 3.5)
    _write_bag(tmp_path / "b.db3", traj, scans)
    assert rows(tmp_path / "a.db3") == rows(tmp_path / "b.db3")
    clouds = [np.c_[s[:, None], s[:, None], np.full((len(s), 1), 0.15)] for s in scans]
    rosbag.write_cloud_bag(tmp_path / "c.db3", traj, clouds)
    _write_cloud_bag(tmp_path / "d.db3", traj, clouds)
    assert rows(tmp_path / "c.db3") == rows(tmp_path / "d.db3")


def assert_streams_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key


def test_read_bag_streams(form, tmp_path):
    traj, scans = scan_stream()
    _write_bag(tmp_path / "scan.db3", traj, scans)
    clouds = [np.stack([s, -s, np.full_like(s, 0.15)], -1) for s in scans]
    _write_cloud_bag(tmp_path / "cloud.db3", traj, clouds)
    for path in (tmp_path / "scan.db3", tmp_path / "cloud.db3"):
        assert rosbag.read_bag_topics(path) == j_rosbag.read_bag_topics(path)
    got = rosbag.read_bag_stream(tmp_path / "scan.db3")
    assert_streams_equal(got, j_rosbag.read_bag_stream(tmp_path / "scan.db3"))
    np.testing.assert_array_equal(got["scans"], scans)
    assert_streams_equal(rosbag.read_bag_cloud_stream(tmp_path / "cloud.db3"),
                         j_rosbag.read_bag_cloud_stream(tmp_path / "cloud.db3"))
    assert_streams_equal(rosbag.bag_to_npz(tmp_path / "scan.db3", tmp_path / "s.npz"),
                         dict(np.load(tmp_path / "s.npz")))
    with pytest.raises(ValueError, match="LaserScan"):
        rosbag.read_bag_stream(tmp_path / "cloud.db3")
    with pytest.raises(KeyError):
        rosbag.read_bag_stream(tmp_path / "scan.db3", odom_topic="/nope")


def test_sample_at_is_the_latest_at_or_before():
    ts = np.array([10, 20, 30], np.int64)
    series = np.arange(3.0)[:, None]
    q = np.array([5, 10, 15, 30, 99], np.int64)
    np.testing.assert_array_equal(rosbag._sample_at(ts, series, q),
                                  j_rosbag._sample_at(ts, series, q))
    np.testing.assert_array_equal(rosbag._sample_at(ts, series, q)[:, 0], [0, 0, 0, 2, 2])


# -- the node's adapters ------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(max_beams=37, laser_min_range=0.3),
                                dict(max_beams=500, laser_max_range=2.5)])
def test_prepare_scan(form, kw):
    node, j_node = AmclNode(AmclNodeConfig(**kw), device="cpu"), JAmclNode(JAmclNodeConfig(**kw))
    ranges = random_ranges(11)
    for args in [(-np.pi, 2 * np.pi / 360), (-np.pi, 2 * np.pi / 360, 0.12, 3.5, (0.1, 0.0, 0.2)),
                 (-1.0, 0.01, None, None, (-0.2, 0.1, np.pi))]:
        (pts, mask), (j_pts, j_mask) = node.prepare_scan(ranges, *args), j_node.prepare_scan(
            ranges, *args)
        assert pts.shape == (node.config.max_beams, 2)
        np.testing.assert_array_equal(mask, j_mask)
        np.testing.assert_array_equal(pts, j_pts)


@pytest.mark.parametrize("width,max_beams", [(45, None), (360, None), (360, 200), (3600, 512)])
def test_prepare_point_cloud(form, width, max_beams):
    """Clouds narrower and wider than the capacity, NaN points among them,
    with and without a capacity of the call's own."""
    rng = np.random.default_rng(width)
    cloud = rng.normal(0.0, 3.0, (width, 3)).astype(np.float32)
    cloud[rng.random(width) < 0.1] = np.nan
    cloud[::31, 1] = np.inf
    node, j_node = AmclNode(device="cpu"), JAmclNode()
    for pose in [(0.0, 0.0, 0.0), (0.2, -0.1, 0.7)]:
        (pts, mask), (j_pts, j_mask) = (
            node.prepare_point_cloud(cloud, pose, max_beams=max_beams),
            j_node.prepare_point_cloud(cloud, pose, max_beams=max_beams))
        np.testing.assert_array_equal(mask, j_mask)
        np.testing.assert_array_equal(pts, j_pts)
        assert len(mask) == (max_beams or 60)


# -- metrics and visualization -------------------------------------------------------


def test_ape_and_compare_runs():
    rng = np.random.default_rng(2)
    gt = rng.normal(size=(40, 3)) * [3.0, 3.0, 3.0]
    est = gt + rng.normal(0.0, 0.1, gt.shape)
    est[5, 2] += 2 * np.pi  # yaw wraps
    got, want = metrics.ape(est, gt), j_metrics.ape(est, gt)
    assert got == want
    assert got["yaw_max"] < 0.5
    runs = {"a": got, "b": metrics.ape(gt, gt)}
    assert metrics.compare_runs(runs) == j_metrics.compare_runs(runs)
    with pytest.raises(ValueError):
        metrics.ape(est[:, :2], gt[:, :2])


def test_particle_markers():
    rng = np.random.default_rng(3)
    xyt = rng.normal(0.0, 0.3, (500, 3))
    w = rng.random(500)
    for res in (0.1, 0.5):
        for got, want in zip(viz.particle_markers(xyt, w, res), j_viz.particle_markers(xyt, w, res)):
            np.testing.assert_array_equal(got, want)


def test_resampled_pose_array_draws_rows_by_weight():
    """Rows of the poses drawn at iid positions from the generator, as B2's
    plain version takes them; a zero-weight row is never drawn."""
    g = torch.Generator().manual_seed(4)
    xyt = torch.randn(300, 3, generator=g)
    w = torch.rand(300, generator=g)
    w[::3] = 0.0
    out = viz.resampled_pose_array(torch.Generator().manual_seed(9), xyt, w, 1000)
    positions = multinomial_positions(torch.Generator().manual_seed(9), 1000)
    assert torch.equal(out, resample_take_reference(w, positions, xyt.T.contiguous()))
    rows = (out[:, None, :] == xyt[None]).all(-1)
    assert rows.any(1).all() and not rows[:, ::3].any()


def test_ndt_ellipsoids():
    rng = np.random.default_rng(6)
    cells = rng.integers(-20, 20, (30, 3))
    cells = np.unique(cells, axis=0)
    a = rng.normal(size=(len(cells), 3, 3))
    covs = a @ a.transpose(0, 2, 1) + 0.01 * np.eye(3)
    covs[0] = np.diag([1.0, -0.5, 1.0])  # not positive: invalid
    means = rng.normal(size=(len(cells), 3))
    got = viz.ndt_ellipsoids(make_ndt_map(cells, means, covs, 0.5, device="cpu"))
    want = j_viz.ndt_ellipsoids(j_make_ndt_map(cells, means, covs, 0.5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[3].sum() == len(cells) - 1


def test_likelihood_field_as_occupancy():
    from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodField

    values = torch.rand(20, 30) * 0.7
    out = viz.likelihood_field_as_occupancy(LikelihoodField(values, 0.1, None, 0.0))
    want = np.clip(values.numpy().astype(np.float64) / values.max().item() * 100.0, 0, 100)
    np.testing.assert_array_equal(out, want.astype(np.int8))
    assert out.max() == 100 and out.dtype == np.int8

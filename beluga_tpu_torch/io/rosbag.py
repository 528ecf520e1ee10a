"""rosbag2 (.db3) reading and writing, without middleware (port of
``beluga_tpu/io/rosbag.py``).

The reference's system tests and examples replay rosbag2 bags
(beluga_example/bags/perfect_odometry, beluga_system_tests/test/
test_system.cpp:119-272).  A rosbag2 bag is a sqlite3 database with two
tables, ``topics(id, name, type, serialization_format, ...)`` and
``messages(id, topic_id, timestamp, data)``, whose blobs are DDS-CDR
serialized.  The readers decode LaserScan, PointCloud2 and Odometry blobs
with ``io/native.py``'s decoders into the stream dict that
``tools/localize.py`` consumes, so a bag of the reference's users replays
directly.

The writers (:func:`write_scan_bag`, :func:`write_cloud_bag`) record a
stream in the same wire format, XCDR1 little-endian: a bag for the replay
tools made from a synthetic stream, with no ROS installation.
"""

from __future__ import annotations

import sqlite3
import struct
from pathlib import Path

import numpy as np

from beluga_tpu_torch.io.native import (
    decode_laserscan_cdr,
    decode_odometry_cdr,
    decode_pointcloud2_cdr,
)

_SCAN_TYPES = ("sensor_msgs/msg/LaserScan",)
_CLOUD_TYPES = ("sensor_msgs/msg/PointCloud2",)
_ODOM_TYPES = ("nav_msgs/msg/Odometry",)


def _quat_to_yaw(qx, qy, qz, qw):
    return np.arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))


def read_bag_topics(bag_path: str | Path) -> dict:
    """{topic name: (id, type, serialization_format)} of a .db3 bag."""
    with sqlite3.connect(f"file:{Path(bag_path)}?mode=ro", uri=True) as db:
        rows = db.execute("SELECT id, name, type, serialization_format FROM topics").fetchall()
    return {name: (tid, typ, fmt) for tid, name, typ, fmt in rows}


def _pick_topic(topics, explicit, types, name_hint=None, exclude=()):
    """A topic: the explicit name (checked) or the first match."""
    if explicit is not None:
        if explicit not in topics:
            raise KeyError(f"topic {explicit!r} not in bag: {list(topics)}")
        return explicit
    for name, (_, typ, _) in sorted(topics.items()):
        if typ in types and name not in exclude:
            if name_hint is None or name_hint in name:
                return name
    return None


def _pick_odom_topics(topics, odom_topic, ground_truth_topic):
    """(odom, ground truth), shared by both stream readers: the ground
    truth matches by name hint; a perfect-odometry recording whose only
    Odometry topic is the ground truth drives the filter with it too."""
    ground_truth_topic = _pick_topic(topics, ground_truth_topic, _ODOM_TYPES,
                                     name_hint="ground_truth")
    odom_topic = _pick_topic(topics, odom_topic, _ODOM_TYPES,
                             exclude=(ground_truth_topic or "",))
    if odom_topic is None and ground_truth_topic is not None:
        odom_topic = ground_truth_topic
    if odom_topic is None:
        raise ValueError(f"no Odometry topic in bag: {list(topics)}")
    return odom_topic, ground_truth_topic


def _fetch_rows(db, topics, topic):
    tid = topics[topic][0]
    return db.execute("SELECT timestamp, data FROM messages WHERE topic_id = ?"
                      " ORDER BY timestamp", (tid,)).fetchall()


def _decode_odom_series(rows):
    ts = np.asarray([t for t, _ in rows], np.int64)
    poses = np.empty((len(rows), 3), np.float64)
    for i, (_, blob) in enumerate(rows):
        p = decode_odometry_cdr(bytes(blob))
        poses[i] = (p[0], p[1], _quat_to_yaw(p[3], p[4], p[5], p[6]))
    return ts, poses


def _sample_at(ts, series, query_ts):
    """The latest series entry at or before each query stamp (the tf
    lookup's analog)."""
    idx = np.clip(np.searchsorted(ts, query_ts, side="right") - 1, 0, len(ts) - 1)
    return series[idx]


def _read_series(bag_path, topics, sensor_topic, odom_topic, ground_truth_topic, what):
    with sqlite3.connect(f"file:{bag_path}?mode=ro", uri=True) as db:
        sensor_rows = _fetch_rows(db, topics, sensor_topic)
        odom_rows = _fetch_rows(db, topics, odom_topic)
        gt_rows = _fetch_rows(db, topics, ground_truth_topic) if ground_truth_topic else []
    if not sensor_rows or not odom_rows:
        raise ValueError(f"bag has no {what} or no odometry messages")
    return sensor_rows, _decode_odom_series(odom_rows), (
        _decode_odom_series(gt_rows) if gt_rows else (None, None))


def read_bag_stream(bag_path: str | Path, scan_topic: str | None = None,
                    odom_topic: str | None = None,
                    ground_truth_topic: str | None = None) -> dict:
    """A rosbag2 .db3 with LaserScan traffic as the localize stream.

    Topics default to the first LaserScan and Odometry topics found
    (``ground_truth_topic`` also matches names holding "ground_truth",
    like the reference bag's /odometry/ground_truth).  Each scan takes the
    latest odometry at or before its bag timestamp.  Returns ``odom``
    f64[T, 3], ``scans`` f32[T, B] (NaN-padded to the longest scan),
    ``angle_min``, ``angle_increment``, ``range_min``, ``range_max`` and,
    where the bag has one, ``ground_truth`` f64[T, 3].
    """
    bag_path = Path(bag_path)
    topics = read_bag_topics(bag_path)
    scan_topic = _pick_topic(topics, scan_topic, _SCAN_TYPES)
    if scan_topic is None:
        raise ValueError(f"no LaserScan topic in bag: {list(topics)}")
    odom_topic, ground_truth_topic = _pick_odom_topics(topics, odom_topic, ground_truth_topic)
    scan_rows, (odom_ts, odom_xyyaw), (gt_ts, gt_xyyaw) = _read_series(
        bag_path, topics, scan_topic, odom_topic, ground_truth_topic, "scan")

    params0 = None
    decoded = []
    scan_ts = np.empty(len(scan_rows), np.int64)
    for i, (t, blob) in enumerate(scan_rows):
        p, r = decode_laserscan_cdr(bytes(blob))
        params0 = params0 or p
        decoded.append(r)
        scan_ts[i] = t
    # the longest scan sets the width (a short first scan must not cut the
    # rest); missing tail beams stay NaN, invalid
    nb = max(len(r) for r in decoded)
    scans = np.full((len(scan_rows), nb), np.nan, np.float32)
    for i, r in enumerate(decoded):
        scans[i, : len(r)] = r

    stream = dict(
        odom=_sample_at(odom_ts, odom_xyyaw, scan_ts),
        scans=scans,
        angle_min=np.float64(params0["angle_min"]),
        angle_increment=np.float64(params0["angle_increment"]),
        range_min=np.float64(params0["range_min"]),
        range_max=np.float64(params0["range_max"]),
    )
    if gt_ts is not None:
        stream["ground_truth"] = _sample_at(gt_ts, gt_xyyaw, scan_ts)
    return stream


def read_bag_cloud_stream(bag_path: str | Path, cloud_topic: str | None = None,
                          odom_topic: str | None = None,
                          ground_truth_topic: str | None = None) -> dict:
    """A rosbag2 .db3 with PointCloud2 traffic as a cloud stream, the
    point-cloud analog of :func:`read_bag_stream` (the reference node takes
    clouds in place of scans, amcl_node.cpp:236-239).  Returns ``clouds``
    f32[T, P, 3] (NaN-padded to the widest cloud), ``cloud_mask`` bool[T,
    P] (finite points), ``odom`` f64[T, 3] and, where the bag has one,
    ``ground_truth``."""
    bag_path = Path(bag_path)
    topics = read_bag_topics(bag_path)
    cloud_topic = _pick_topic(topics, cloud_topic, _CLOUD_TYPES)
    if cloud_topic is None:
        raise ValueError(f"no PointCloud2 topic in bag: {list(topics)}")
    odom_topic, ground_truth_topic = _pick_odom_topics(topics, odom_topic, ground_truth_topic)
    cloud_rows, (odom_ts, odom_xyyaw), (gt_ts, gt_xyyaw) = _read_series(
        bag_path, topics, cloud_topic, odom_topic, ground_truth_topic, "cloud")

    decoded = []
    cloud_ts = np.empty(len(cloud_rows), np.int64)
    for i, (t, blob) in enumerate(cloud_rows):
        decoded.append(decode_pointcloud2_cdr(bytes(blob)))
        cloud_ts[i] = t
    cap = max(len(p) for p in decoded)
    clouds = np.full((len(cloud_rows), cap, 3), np.nan, np.float32)
    mask = np.zeros((len(cloud_rows), cap), bool)
    for i, p in enumerate(decoded):
        clouds[i, : len(p)] = p
        mask[i, : len(p)] = np.isfinite(p).all(axis=-1)

    stream = dict(odom=_sample_at(odom_ts, odom_xyyaw, cloud_ts), clouds=clouds,
                  cloud_mask=mask)
    if gt_ts is not None:
        stream["ground_truth"] = _sample_at(gt_ts, gt_xyyaw, cloud_ts)
    return stream


def bag_to_npz(bag_path, output_npz, **kwargs):
    """Convert a .db3 bag with LaserScan traffic to the localize stream .npz."""
    stream = read_bag_stream(bag_path, **kwargs)
    np.savez(output_npz, **stream)
    return stream


# -- writing: CDR encoders and the bag layout ---------------------------------------


class _CdrWriter:
    """XCDR1 little-endian writer (alignment relative to byte 4)."""

    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")  # CDR_LE encapsulation

    def align(self, n):
        rem = (len(self.buf) - 4) % n
        if rem:
            self.buf += b"\x00" * (n - rem)

    def write(self, fmt, size, v):
        self.align(size)
        self.buf += struct.pack("<" + fmt, v)

    def string(self, s):
        data = s.encode() + b"\x00"
        self.write("I", 4, len(data))
        self.buf += data

    def header(self, sec=7, nsec=9, frame="odom"):
        self.write("i", 4, sec)
        self.write("I", 4, nsec)
        self.string(frame)


def encode_laserscan(ranges, angle_min=-1.5, angle_inc=0.01, range_min=0.1, range_max=12.0,
                     intensities=True) -> bytes:
    """A sensor_msgs/LaserScan CDR blob (scan_time 0.2, intensities 1)."""
    w = _CdrWriter()
    w.header(frame="base_scan")
    for v in (angle_min, angle_min + angle_inc * (len(ranges) - 1), angle_inc, 0.0, 0.2,
              range_min, range_max):
        w.write("f", 4, v)
    w.write("I", 4, len(ranges))
    for r in ranges:
        w.write("f", 4, float(r))
    if intensities:
        w.write("I", 4, len(ranges))
        for _ in ranges:
            w.write("f", 4, 1.0)
    return bytes(w.buf)


def encode_odometry(x, y, yaw, frame="odom", child="base_link") -> bytes:
    """A nav_msgs/Odometry CDR blob: the planar pose, zero covariances and
    twist."""
    w = _CdrWriter()
    w.header(frame=frame)
    w.string(child)
    qz, qw = np.sin(yaw / 2), np.cos(yaw / 2)
    for v in (x, y, 0.0, 0.0, 0.0, qz, qw):
        w.write("d", 8, float(v))
    for _ in range(36 + 6 + 36):  # pose covariance, twist, twist covariance
        w.write("d", 8, 0.0)
    return bytes(w.buf)


def encode_pointcloud2(points, datatype="f32", extra_fields=(), point_pad=0, height=1,
                       row_pad=0, field_order=("x", "y", "z")) -> bytes:
    """A sensor_msgs/PointCloud2 CDR blob of ``points`` [N, 3].
    ``extra_fields`` names trailing scalar fields of the same datatype (the
    reference's sparse layout); ``point_pad`` bytes follow each point and
    ``row_pad`` bytes each row."""
    points = np.asarray(points, np.float64)
    n = len(points)
    if n % height:
        raise ValueError(f"{n} points do not fill {height} rows")
    width = n // height
    scalar = 4 if datatype == "f32" else 8
    code = 7 if datatype == "f32" else 8
    names = list(field_order) + list(extra_fields)
    point_step = scalar * len(names) + point_pad
    row_step = width * point_step + row_pad

    w = _CdrWriter()
    w.header(frame="lidar")
    w.write("I", 4, height)
    w.write("I", 4, width)
    w.write("I", 4, len(names))
    for i, name in enumerate(names):
        w.string(name)
        w.write("I", 4, i * scalar)  # offset
        w.write("B", 1, code)  # datatype
        w.write("I", 4, 1)  # count
    w.write("B", 1, 0)  # is_bigendian
    w.write("I", 4, point_step)
    w.write("I", 4, row_step)
    data = bytearray()
    fmt = "<f" if datatype == "f32" else "<d"
    for r in range(height):
        for c in range(width):
            p = points[r * width + c]
            for k in range(len(names)):
                data += struct.pack(fmt, p[k] if k < 3 else 42.0 + k)
            data += b"\x00" * point_pad
        data += b"\xEE" * row_pad
    w.write("I", 4, len(data))
    w.buf += bytes(data)
    w.write("B", 1, 1)  # is_dense
    return bytes(w.buf)


def _write_bag(path, sensor_topic, sensor_type, traj, blobs) -> None:
    """The bag layout: one sensor topic, /odom and /odometry/ground_truth
    (perfect odometry: both the truth), ~7 Hz in integer nanoseconds, each
    odometry 1 µs before its scan."""
    with sqlite3.connect(path) as db:
        db.execute("CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, type TEXT,"
                   " serialization_format TEXT, offered_qos_profiles TEXT)")
        db.execute("CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER,"
                   " timestamp INTEGER, data BLOB)")
        db.executemany("INSERT INTO topics VALUES (?,?,?,?,?)", [
            (1, sensor_topic, sensor_type, "cdr", ""),
            (2, "/odom", "nav_msgs/msg/Odometry", "cdr", ""),
            (3, "/odometry/ground_truth", "nav_msgs/msg/Odometry", "cdr", ""),
        ])
        mid = 1
        for t, (pose, blob) in enumerate(zip(traj, blobs)):
            x, y, yaw = pose[0], pose[1], pose[-1]
            ts = 10_000_000 + 140_000 * t
            for topic in (2, 3):
                db.execute("INSERT INTO messages VALUES (?,?,?,?)",
                           (mid, topic, ts - 1000, encode_odometry(x, y, yaw)))
                mid += 1
            db.execute("INSERT INTO messages VALUES (?,?,?,?)", (mid, 1, ts, blob))
            mid += 1
    db.close()


def write_scan_bag(path, traj, scans, angle_min, angle_increment, range_min,
                   range_max) -> None:
    """A rosbag2 .db3 of LaserScan traffic on /scan with perfect odometry:
    ``traj`` f64[T, 3] poses, ``scans`` f32[T, B] ranges (NaN for no
    return)."""
    _write_bag(path, "/scan", _SCAN_TYPES[0], traj, (
        encode_laserscan(r, angle_min=angle_min, angle_inc=angle_increment,
                         range_min=range_min, range_max=range_max) for r in scans))


def write_cloud_bag(path, traj, clouds) -> None:
    """A rosbag2 .db3 of PointCloud2 traffic on /points with perfect
    odometry, in the sparse layout (xyz, an intensity field and 4 bytes of
    padding a point, the stress case of sparse_point_cloud.hpp:53)."""
    _write_bag(path, "/points", _CLOUD_TYPES[0], traj, (
        encode_pointcloud2(p, extra_fields=("intensity",), point_pad=4) for p in clouds))

"""The host-side IO routines (port of ``beluga_tpu/io/native.py``): the
laser-scan adapter's conversion and decimation, the PGM decoder and the
rosbag2 CDR decoders.

Each routine has two forms that give the same results: the native one, a
ctypes call into ``csrc/host/beluga_io.cc`` (the port's own copy of the
host library), and a numpy one.  The library is built at first use with
the system C++ compiler into ``build/beluga_tpu_torch/``, named by a hash
of the source and the flags, as the CUDA kernels are (``ops/_build.py``).
Without a compiler every routine takes its numpy form, so the package
works without a toolchain; :func:`native_available` says which form runs.
``scan_to_points`` is the per-scan host work of the node's laser-scan
input.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from beluga_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "beluga_io.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_build_attempted = False


def library_path() -> Path:
    """Where the library built from ``csrc/host/beluga_io.cc`` lives: named
    by a hash of the source and the flags."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbeluga_io-{digest.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> bool:
    """Compile the host library.  Returns True on success.  The library is
    written to a temporary file and renamed into place, so that processes
    building at once never load a half-written one."""
    global _build_attempted
    _build_attempted = True
    out = library_path()
    if out.exists() and not force:
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for cc in ("g++", "c++", "clang++"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, *CXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        return True
    return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists() and not _build_attempted:
        build_native()
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    f32p, u8p, i64p = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_uint8,
                                                   ctypes.c_int64))
    lib.scan_to_points.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, f32p, u8p,
    ]
    lib.scan_to_points.restype = None
    lib.take_evenly_indices.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p]
    lib.take_evenly_indices.restype = None
    lib.parse_pgm_p5.argtypes = [u8p, ctypes.c_int64, i64p, i64p, i64p]
    lib.parse_pgm_p5.restype = ctypes.c_int64
    lib.pgm_to_trinary.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int8),
    ]
    lib.pgm_to_trinary.restype = None
    lib.decode_laserscan_cdr.argtypes = [u8p, ctypes.c_int64, f32p, f32p, ctypes.c_int64]
    lib.decode_laserscan_cdr.restype = ctypes.c_int64
    lib.decode_odometry_cdr.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.decode_odometry_cdr.restype = ctypes.c_int64
    lib.decode_header_stamp_cdr.argtypes = [u8p, ctypes.c_int64, i64p, i64p]
    lib.decode_header_stamp_cdr.restype = ctypes.c_int64
    lib.decode_pointcloud2_cdr.argtypes = [u8p, ctypes.c_int64, f32p, ctypes.c_int64, i64p]
    lib.decode_pointcloud2_cdr.restype = ctypes.c_int64
    _lib = lib
    return lib


def native_available() -> bool:
    """True when the native forms run (the library built and loaded)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def scan_to_points(ranges, angle_min, angle_increment, min_range, max_range,
                   sensor_pose=(0.0, 0.0, 0.0)):
    """LaserScan ranges -> (points ``f32[N, 2]`` in the base frame, mask
    ``bool[N]``): laser_scan.hpp:59-93 and the sensor-origin transform
    (beluga_ros/src/amcl.cpp:57-62).  Invalid beams (not finite, or
    outside ``[min_range, max_range]``) get a zero point and mask False."""
    ranges = np.ascontiguousarray(ranges, np.float32)
    n = len(ranges)
    sx, sy, syaw = (float(v) for v in sensor_pose)
    lib = _load()
    if lib is not None:
        out = np.empty((n, 2), np.float32)
        mask = np.empty(n, np.uint8)
        lib.scan_to_points(_ptr(ranges, ctypes.c_float), n, float(angle_min),
                           float(angle_increment), float(min_range), float(max_range),
                           sx, sy, syaw, _ptr(out, ctypes.c_float), _ptr(mask, ctypes.c_uint8))
        return out, mask.astype(bool)
    angles = angle_min + np.arange(n, dtype=np.float32) * angle_increment
    ok = np.isfinite(ranges) & (ranges >= min_range) & (ranges <= max_range)
    px = np.where(ok, ranges * np.cos(angles), 0.0)
    py = np.where(ok, ranges * np.sin(angles), 0.0)
    c, s = np.cos(syaw), np.sin(syaw)
    out = np.stack([c * px - s * py + sx, s * px + c * py + sy], -1).astype(np.float32)
    out[~ok] = 0.0
    return out, ok


def take_evenly_indices(n: int, k: int) -> np.ndarray:
    """Indices of an evenly spaced k-subsample of n slots,
    ``ceil((n - 1) j / (k - 1))`` (take_evenly.hpp, pinned by
    test_take_evenly.cpp): 3 of 6 -> {0, 3, 5}, 6 of 10 -> {0, 2, 4, 6, 8,
    9}; every index when ``k >= n``."""
    if k <= 0 or n <= 0:
        return np.zeros(0, np.int64)
    if k >= n:
        return np.arange(n, dtype=np.int64)
    if k == 1 or n == 1:
        return np.zeros(k, np.int64)
    lib = _load()
    if lib is not None:
        out = np.empty(k, np.int64)
        lib.take_evenly_indices(n, k, _ptr(out, ctypes.c_int64))
        return out
    num = (n - 1) * np.arange(k, dtype=np.int64)
    return -(-num // (k - 1))


def decode_pgm_trinary(data: bytes, occupied_thresh=0.65, free_thresh=0.196, negate=False):
    """P5 PGM bytes -> ROS trinary ``int8[H, W]`` (row 0 the bottom), or
    None where the native form is unavailable or the file is not binary
    P5 (``maps.occupancy.load_pgm_yaml`` is the numpy form)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    w, h, mv = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    off = lib.parse_pgm_p5(_ptr(buf, ctypes.c_uint8), len(buf), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(mv))
    if off < 0:
        return None
    out = np.empty((h.value, w.value), np.int8)
    pixels = buf[off:]
    lib.pgm_to_trinary(_ptr(pixels, ctypes.c_uint8), w.value, h.value, mv.value,
                       float(occupied_thresh), float(free_thresh), int(bool(negate)),
                       _ptr(out, ctypes.c_int8))
    return out


# -- rosbag2 CDR message decoding ------------------------------------------------------


class _CdrReader:
    """Minimal XCDR1 little-endian reader (alignment relative to byte 4)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 4

    def align(self, n: int):
        rem = (self.pos - 4) % n
        if rem:
            self.pos += n - rem

    def read(self, fmt: str, size: int):
        self.align(size)
        try:
            v = struct.unpack_from("<" + fmt, self.data, self.pos)[0]
        except struct.error as e:
            raise ValueError(f"malformed CDR message: {e}") from None
        self.pos += size
        return v

    def skip_string(self):
        n = self.read("I", 4)
        self.pos += n

    def skip_header(self):
        self.read("i", 4)
        self.read("I", 4)
        self.skip_string()


def _little_endian(data: bytes, what: str) -> None:
    if len(data) < 4 or data[1] != 0x01:
        raise ValueError(f"malformed {what}CDR message")


def decode_laserscan_cdr(data: bytes):
    """sensor_msgs/LaserScan CDR blob -> (params dict, ranges ``f32[N]``);
    params: angle_min, angle_max, angle_increment, scan_time, range_min,
    range_max.  Little-endian XCDR1 (the rosbag2 and DDS default) only."""
    buf = np.frombuffer(data, np.uint8)
    lib = _load()
    if lib is not None:
        params = np.empty(6, np.float32)
        cap = max((len(data) - 40) // 4, 16)
        ranges = np.empty(cap, np.float32)
        n = lib.decode_laserscan_cdr(_ptr(buf, ctypes.c_uint8), len(buf),
                                     _ptr(params, ctypes.c_float), _ptr(ranges, ctypes.c_float),
                                     cap)
        if n < 0:
            raise ValueError("malformed LaserScan CDR message")
        if n > cap:  # cap bounds the blob's size; kept for a decoder that changes
            ranges = np.empty(n, np.float32)
            n = lib.decode_laserscan_cdr(_ptr(buf, ctypes.c_uint8), len(buf),
                                         _ptr(params, ctypes.c_float),
                                         _ptr(ranges, ctypes.c_float), n)
        keys = ("angle_min", "angle_max", "angle_increment", "scan_time", "range_min",
                "range_max")
        return dict(zip(keys, (float(v) for v in params))), ranges[:n].copy()
    _little_endian(data, "LaserScan ")
    r = _CdrReader(data)
    r.skip_header()
    vals = [r.read("f", 4) for _ in range(7)]
    n = r.read("I", 4)
    ranges = np.frombuffer(data, np.float32, count=n, offset=r.pos)
    params = dict(angle_min=vals[0], angle_max=vals[1], angle_increment=vals[2],
                  scan_time=vals[4], range_min=vals[5], range_max=vals[6])
    return params, ranges.copy()


def decode_odometry_cdr(data: bytes) -> np.ndarray:
    """nav_msgs/Odometry CDR blob -> pose (x, y, z, qx, qy, qz, qw) ``f64[7]``."""
    buf = np.frombuffer(data, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(7, np.float64)
        if lib.decode_odometry_cdr(_ptr(buf, ctypes.c_uint8), len(buf),
                                   _ptr(out, ctypes.c_double)) < 0:
            raise ValueError("malformed Odometry CDR message")
        return out
    _little_endian(data, "Odometry ")
    r = _CdrReader(data)
    r.skip_header()
    r.skip_string()  # child_frame_id
    return np.asarray([r.read("d", 8) for _ in range(7)], np.float64)


def decode_pointcloud2_cdr(data: bytes) -> np.ndarray:
    """sensor_msgs/PointCloud2 CDR blob -> xyz points ``f32[N, 3]``.

    Both layouts of the reference: dense xyz-contiguous float or double
    (beluga_ros point_cloud.hpp:59) and sparse strided fields
    (sparse_point_cloud.hpp:53).  x, y, z must lead the layout in that
    order with one floating-point datatype, the adapters' contract.  NaN
    points are kept (callers mask them).  Little-endian XCDR1 only."""
    buf = np.frombuffer(data, np.uint8)
    lib = _load()
    if lib is not None:
        info = np.empty(4, np.int64)
        cap = max((len(data) - 40) // 12, 16)
        out = np.empty((cap, 3), np.float32)
        n = lib.decode_pointcloud2_cdr(_ptr(buf, ctypes.c_uint8), len(buf),
                                       _ptr(out, ctypes.c_float), cap,
                                       _ptr(info, ctypes.c_int64))
        if n < 0:
            raise ValueError("malformed PointCloud2 CDR message")
        if n > cap:
            out = np.empty((n, 3), np.float32)
            n = lib.decode_pointcloud2_cdr(_ptr(buf, ctypes.c_uint8), len(buf),
                                           _ptr(out, ctypes.c_float), n,
                                           _ptr(info, ctypes.c_int64))
        return out[:n].copy()
    _little_endian(data, "PointCloud2 ")
    r = _CdrReader(data)
    r.skip_header()
    height = r.read("I", 4)
    width = r.read("I", 4)
    n_fields = r.read("I", 4)
    if n_fields < 3 or n_fields > 256:
        raise ValueError("malformed PointCloud2 CDR message")
    offs, dtypes = [], []
    for i in range(n_fields):
        r.align(4)
        slen = r.read("I", 4)
        name = data[r.pos : r.pos + max(slen - 1, 0)].decode(errors="replace")
        r.pos += slen
        f_off = r.read("I", 4)
        f_dtype = r.read("B", 1)
        r.read("I", 4)  # count
        if i < 3:
            if name != "xyz"[i]:
                raise ValueError("point cloud layout is not xyz-led")
            offs.append(f_off)
            dtypes.append(f_dtype)
    if len(set(dtypes)) != 1 or dtypes[0] not in (7, 8):
        raise ValueError("xyz fields must share one floating-point datatype")
    scalar = np.float32 if dtypes[0] == 7 else np.float64
    if r.read("B", 1):  # is_bigendian: little-endian only
        raise ValueError("big-endian PointCloud2 payloads are unsupported")
    point_step = r.read("I", 4)
    row_step = r.read("I", 4)
    data_len = r.read("I", 4)
    if r.pos + data_len > len(data):
        raise ValueError("malformed PointCloud2 CDR message")
    payload = np.frombuffer(data, np.uint8, count=data_len, offset=r.pos)
    if point_step == 0:
        raise ValueError("malformed PointCloud2 CDR message")
    if row_step == 0:
        row_step = width * point_step
    # the bounds checks of the native decoder, before the strided views
    # (which check none)
    itemsize = np.dtype(scalar).itemsize
    if any(off + itemsize > point_step for off in offs):
        raise ValueError("xyz field offset beyond point_step")
    if height and (height - 1) * row_step + width * point_step > data_len:
        raise ValueError("PointCloud2 data shorter than its layout")
    out = np.empty((height * width, 3), np.float32)
    for k, off in enumerate(offs):
        col = np.lib.stride_tricks.as_strided(
            payload[off:].view(np.uint8), shape=(height, width, itemsize),
            strides=(row_step, point_step, 1))
        out[:, k] = col.reshape(height * width, -1).copy().view(scalar).ravel()
    return out


def decode_header_stamp_cdr(data: bytes):
    """(sec, nanosec) of any Header-led message."""
    buf = np.frombuffer(data, np.uint8)
    lib = _load()
    if lib is not None:
        sec, nsec = ctypes.c_int64(), ctypes.c_int64()
        if lib.decode_header_stamp_cdr(_ptr(buf, ctypes.c_uint8), len(buf), ctypes.byref(sec),
                                       ctypes.byref(nsec)) < 0:
            raise ValueError("malformed CDR message")
        return sec.value, nsec.value
    _little_endian(data, "")
    r = _CdrReader(data)
    return r.read("i", 4), r.read("I", 4)

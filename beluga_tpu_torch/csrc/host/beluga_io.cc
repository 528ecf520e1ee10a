// Host-side IO routines of beluga_tpu_torch: the per-scan adapter work of
// beluga_ros::LaserScan / beluga_ros::Amcl::update (beluga_ros/src/amcl.cpp:
// 54-63) -- polar->cartesian conversion with range filtering and the
// sensor-frame transform, evenly-spaced beam decimation
// (views/take_evenly.hpp) -- a PGM map decoder, and the rosbag2 CDR
// decoders of LaserScan, Odometry, PointCloud2 and message headers.
// Loaded through ctypes by beluga_tpu_torch/io/native.py, which builds this
// file with the system C++ compiler at first use and keeps a numpy form of
// every routine for a machine without one.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Convert a laser scan (ranges + implicit angles) to 2D points in the base
// frame.  Mirrors BaseLaserScan::points_in_cartesian_coordinates
// (sensor/data/laser_scan.hpp:59-93) + the planar sensor-origin transform
// (beluga_ros/src/amcl.cpp:57-62).  Invalid beams (NaN/inf or outside
// [min_range, max_range]) get mask 0 and a zero point.
void scan_to_points(
    const float* ranges, int64_t n,
    float angle_min, float angle_increment,
    float min_range, float max_range,
    // sensor pose in the base frame (x, y, yaw)
    float sx, float sy, float syaw,
    float* out_xy, uint8_t* out_mask) {
  const float c = std::cos(syaw);
  const float s = std::sin(syaw);
  for (int64_t i = 0; i < n; ++i) {
    const float r = ranges[i];
    const bool ok = std::isfinite(r) && r >= min_range && r <= max_range;
    if (ok) {
      const float a = angle_min + static_cast<float>(i) * angle_increment;
      const float px = r * std::cos(a);
      const float py = r * std::sin(a);
      out_xy[2 * i] = c * px - s * py + sx;
      out_xy[2 * i + 1] = s * px + c * py + sy;
      out_mask[i] = 1;
    } else {
      out_xy[2 * i] = 0.0f;
      out_xy[2 * i + 1] = 0.0f;
      out_mask[i] = 0;
    }
  }
}

// Evenly-spaced decimation of n source slots into k destination slots.
// Reference semantics (views/take_evenly.hpp, pinned by
// test_take_evenly.cpp): index_j = ceil((n-1) * j / (k-1)); first and last
// elements are always included when k > 1.
void take_evenly_indices(int64_t n, int64_t k, int64_t* out_idx) {
  if (k <= 0 || n <= 0) return;
  if (k == 1 || n == 1) {
    for (int64_t j = 0; j < k; ++j) out_idx[j] = 0;
    return;
  }
  for (int64_t j = 0; j < k; ++j) {
    const int64_t num = (n - 1) * j;
    out_idx[j] = (num + k - 2) / (k - 1);  // ceil(num / (k-1))
  }
}

// Parse a binary P5 PGM header.  Returns the offset of the pixel data, or
// -1 on malformed input.  Width/height/maxval written through pointers.
int64_t parse_pgm_p5(
    const uint8_t* buf, int64_t len, int64_t* w, int64_t* h, int64_t* maxval) {
  int64_t pos = 0;
  auto skip_ws_comments = [&]() {
    while (pos < len) {
      const uint8_t ch = buf[pos];
      if (ch == '#') {
        while (pos < len && buf[pos] != '\n') ++pos;
      } else if (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r') {
        ++pos;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> int64_t {
    skip_ws_comments();
    int64_t v = 0;
    bool any = false;
    while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
      v = v * 10 + (buf[pos] - '0');
      ++pos;
      any = true;
    }
    return any ? v : -1;
  };

  if (len < 2 || buf[0] != 'P' || buf[1] != '5') return -1;
  pos = 2;
  const int64_t ww = read_int();
  const int64_t hh = read_int();
  const int64_t mv = read_int();
  if (ww <= 0 || hh <= 0 || mv <= 0) return -1;
  ++pos;  // single whitespace after maxval
  if (pos + ww * hh > len) return -1;
  *w = ww;
  *h = hh;
  *maxval = mv;
  return pos;
}

// Threshold PGM intensities into ROS trinary occupancy (map_server rule),
// flipping vertically (PGM row 0 = top; grid row 0 = bottom).
void pgm_to_trinary(
    const uint8_t* pixels, int64_t w, int64_t h, int64_t maxval,
    float occupied_thresh, float free_thresh, int negate,
    int8_t* out /* h*w, row 0 = bottom */) {
  const float inv = 1.0f / static_cast<float>(maxval);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = pixels + y * w;
    int8_t* dst = out + (h - 1 - y) * w;
    for (int64_t x = 0; x < w; ++x) {
      const float v = static_cast<float>(src[x]) * inv;
      const float p = negate ? v : 1.0f - v;
      dst[x] = p > occupied_thresh ? 100 : (p < free_thresh ? 0 : -1);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rosbag2 CDR message decoding (XCDR1 little-endian, the rosbag2 default).
//
// The reference ships its system-test inputs as rosbag2 .db3 bagfiles
// (beluga_example/bags/; replayed by beluga_system_tests).  A bag is a
// sqlite3 database (read host-side in Python) whose message blobs are
// DDS-CDR serialized; these decoders parse the two message types the
// localization pipeline needs.  Layout: 4-byte encapsulation header
// {representation id/options}, then fields in declaration order, with
// primitives aligned to their size relative to the end of the header.
// ---------------------------------------------------------------------------

namespace {

struct CdrCursor {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;  // absolute; alignment is relative to byte 4

  bool ok() const { return pos >= 0 && pos <= len; }
  void align(int64_t n) {
    if (pos < 0) return;  // failed cursors stay failed
    const int64_t rel = pos - 4;
    const int64_t rem = rel % n;
    if (rem) pos += n - rem;
  }
  template <typename T>
  T read() {
    align(sizeof(T));
    if (pos < 0 || pos + static_cast<int64_t>(sizeof(T)) > len) {
      pos = -1;
      return T{};
    }
    T v;
    std::memcpy(&v, buf + pos, sizeof(T));
    pos += sizeof(T);
    return v;
  }
  void skip_string() {
    const uint32_t n = read<uint32_t>();  // length including NUL
    if (pos < 0 || pos + static_cast<int64_t>(n) > len) {
      pos = -1;
      return;
    }
    pos += n;
  }
  void skip_header() {       // std_msgs/Header
    read<int32_t>();         // stamp.sec
    read<uint32_t>();        // stamp.nanosec
    skip_string();           // frame_id
  }
};

}  // namespace

extern "C" {

// Decode sensor_msgs/msg/LaserScan.  Writes up to max_ranges range values
// and the 6 scan parameters (angle_min, angle_max, angle_increment,
// scan_time, range_min, range_max).  Returns the number of ranges in the
// message (may exceed max_ranges; caller re-calls with a larger buffer),
// or -1 on malformed input.  Intensities are ignored.
int64_t decode_laserscan_cdr(
    const uint8_t* buf, int64_t len,
    float* params6, float* out_ranges, int64_t max_ranges) {
  if (len < 4 || buf[1] != 0x01) return -1;  // CDR_LE only
  CdrCursor c{buf, len, 4};
  c.skip_header();
  const float angle_min = c.read<float>();
  const float angle_max = c.read<float>();
  const float angle_increment = c.read<float>();
  c.read<float>();  // time_increment
  const float scan_time = c.read<float>();
  const float range_min = c.read<float>();
  const float range_max = c.read<float>();
  const uint32_t n = c.read<uint32_t>();
  if (!c.ok() || c.pos + static_cast<int64_t>(n) * 4 > len) return -1;
  const int64_t copy = n < static_cast<uint32_t>(max_ranges)
                           ? static_cast<int64_t>(n)
                           : max_ranges;
  std::memcpy(out_ranges, buf + c.pos, copy * sizeof(float));
  params6[0] = angle_min;
  params6[1] = angle_max;
  params6[2] = angle_increment;
  params6[3] = scan_time;
  params6[4] = range_min;
  params6[5] = range_max;
  return static_cast<int64_t>(n);
}

// Decode nav_msgs/msg/Odometry: writes (x, y, z, qx, qy, qz, qw) of
// pose.pose.  Returns 0, or -1 on malformed input.
int64_t decode_odometry_cdr(const uint8_t* buf, int64_t len, double* out7) {
  if (len < 4 || buf[1] != 0x01) return -1;
  CdrCursor c{buf, len, 4};
  c.skip_header();
  c.skip_string();  // child_frame_id
  for (int i = 0; i < 7; ++i) out7[i] = c.read<double>();
  return c.ok() ? 0 : -1;
}

// Decode sensor_msgs/msg/PointCloud2 into xyz triples (f32).
//
// Covers BOTH reference adapters: the dense wrapper
// (beluga_ros/include/beluga_ros/point_cloud.hpp:59 — xyz-contiguous
// float/double, point_step a multiple of the scalar size) and the sparse
// wrapper (sparse_point_cloud.hpp:53 — per-field offsets, arbitrary
// strides).  The x/y/z fields must lead the layout in that order and
// share one floating-point datatype (FLOAT32=7 / FLOAT64=8), exactly the
// reference's construction-time checks; each point is then read through
// its field offsets with point_step/row_step strides.
//
// Writes up to max_pts xyz triples into out_xyz and
// {height, width, point_step, datatype} into info4.  Returns the total
// point count (height * width; caller re-calls with a larger buffer if it
// exceeds max_pts), or -1 on malformed input / unsupported layout.
int64_t decode_pointcloud2_cdr(
    const uint8_t* buf, int64_t len,
    float* out_xyz, int64_t max_pts, int64_t* info4) {
  if (len < 4 || buf[1] != 0x01) return -1;  // CDR_LE only
  CdrCursor c{buf, len, 4};
  c.skip_header();
  const uint32_t height = c.read<uint32_t>();
  const uint32_t width = c.read<uint32_t>();
  const uint32_t n_fields = c.read<uint32_t>();
  if (!c.ok() || n_fields < 3 || n_fields > 256) return -1;

  uint32_t off[3] = {0, 0, 0};
  uint8_t dtype[3] = {0, 0, 0};
  const char* expected[3] = {"x", "y", "z"};
  for (uint32_t i = 0; i < n_fields; ++i) {
    // PointField: string name, uint32 offset, uint8 datatype, uint32 count
    c.align(4);
    const uint32_t slen = c.read<uint32_t>();
    if (!c.ok() || c.pos + static_cast<int64_t>(slen) > len) return -1;
    const char* name = reinterpret_cast<const char*>(buf + c.pos);
    const int64_t name_len =
        slen > 0 ? static_cast<int64_t>(slen) - 1 : 0;  // minus NUL
    c.pos += slen;
    const uint32_t f_off = c.read<uint32_t>();
    const uint8_t f_dtype = c.read<uint8_t>();
    c.read<uint32_t>();  // count
    if (!c.ok()) return -1;
    if (i < 3) {
      if (name_len != 1 || name[0] != expected[i][0]) return -1;
      off[i] = f_off;
      dtype[i] = f_dtype;
    }
  }
  if (dtype[0] != dtype[1] || dtype[1] != dtype[2]) return -1;
  if (dtype[0] != 7 && dtype[0] != 8) return -1;  // FLOAT32 / FLOAT64
  const int64_t scalar = dtype[0] == 7 ? 4 : 8;

  // little-endian-only contract: reject big-endian payloads instead of
  // silently decoding garbage coordinates
  if (c.read<uint8_t>() != 0) return -1;  // is_bigendian
  const uint32_t point_step = c.read<uint32_t>();
  uint32_t row_step = c.read<uint32_t>();
  const uint32_t data_len = c.read<uint32_t>();
  if (!c.ok() || c.pos + static_cast<int64_t>(data_len) > len) return -1;
  const uint8_t* data = buf + c.pos;
  if (point_step == 0) return -1;
  if (row_step == 0) row_step = width * point_step;
  for (int k = 0; k < 3; ++k) {
    if (off[k] + scalar > point_step) return -1;
  }
  const int64_t total = static_cast<int64_t>(height) * width;
  if (height != 0 &&
      static_cast<int64_t>(height - 1) * row_step +
              static_cast<int64_t>(width) * point_step >
          static_cast<int64_t>(data_len)) {
    return -1;
  }

  const int64_t write = total < max_pts ? total : max_pts;
  int64_t w_i = 0;
  for (uint32_t r = 0; r < height && w_i < write; ++r) {
    const uint8_t* row = data + static_cast<int64_t>(r) * row_step;
    for (uint32_t q = 0; q < width && w_i < write; ++q, ++w_i) {
      const uint8_t* p = row + static_cast<int64_t>(q) * point_step;
      for (int k = 0; k < 3; ++k) {
        if (scalar == 4) {
          float v;
          std::memcpy(&v, p + off[k], 4);
          out_xyz[3 * w_i + k] = v;
        } else {
          double v;
          std::memcpy(&v, p + off[k], 8);
          out_xyz[3 * w_i + k] = static_cast<float>(v);
        }
      }
    }
  }
  info4[0] = height;
  info4[1] = width;
  info4[2] = point_step;
  info4[3] = dtype[0];
  return total;
}

// Decode the stamp (sec, nanosec) of any message starting with a Header.
int64_t decode_header_stamp_cdr(
    const uint8_t* buf, int64_t len, int64_t* sec, int64_t* nanosec) {
  if (len < 4 || buf[1] != 0x01) return -1;
  CdrCursor c{buf, len, 4};
  *sec = c.read<int32_t>();
  *nanosec = c.read<uint32_t>();
  return c.ok() ? 0 : -1;
}

}  // extern "C"

// Kernel B9: the shared-scan correlation LUT, all heading bins of one scan.
//
// Replaces beluga_tpu/ops/pallas_scan_lut.py:scan_lut_correlate
// (_kernel_bilinear and _kernel_nearest).  For a padded pz^3 field F [hp, wp]
// and K heading bins, each (bin k, beam b) has a cell shift (sy, sx) =
// (mod(-iy, hp), mod(-ix, wp)) and the weights (m, ax, ay), m the beam mask
// as 0/1.  pltpu.roll(a, s) reads a[(i - s) mod n], so the reference's rolled
// images read F at ((y - sy) mod hp, (x - sx) mod wp) = ((y + iy) mod hp,
// (x + ix) mod wp), and output cell (k, y, x) is, with the beams in order
// b = 0..B-1:
//
//   nearest:  sum_b m * F[y + iy, x + ix]
//   bilinear: r(y', x') = F[(y' + iy) mod hp, (x' + ix) mod wp]
//             u(y')     = r(y', x) + ax * (r(y', x + 1) - r(y', x))
//             acc_u    += (m * (1 - ay)) * u(y)
//             acc_v    += (m * ay) * u(y + 1)
//             out       = acc_u + acc_v
//
// the reference's order: its loop keeps acc_v unshifted and rolls it by one
// row in the epilogue, so here one thread computes u at two rows.  Every
// product and sum is a round-to-nearest intrinsic, which nvcc never
// contracts into an FMA: the plain PyTorch version takes the same float32
// operations in the same order and the two agree bit for bit.
//
// The tables come from one of two sources (a template flag, one kernel
// body): the scan itself, in the prologue (FromPoints: the bins' cos and
// sin from a cached table, ox = (c px - s py) / res and oy = (s px + c py)
// / res in the plain version's order, floor (bilinear) or rint, half to
// even as torch.round (nearest), the non-negative remainders, so that one
// launch builds a scan's LUT), or tables given as inputs (the tests feed
// the reference's own, and masks that differ by bin).
//
// What bounds it on an H100: the output's bytes.  At the shared-scan
// filter's shape (K 128, F 280 x 384 after downsample 2, 26 of 60 beams
// unmasked, nearest) the 3.6e8 (cell, beam) multiply-adds are 0.72 GFLOP,
// 10.7 us at 67 TFLOP/s, under the 55.1 MB output's 16.6 us at 3.35 TB/s;
// bilinear at full resolution (K 128, 552 x 640): 1.2e9 pairs x 7
// operations, 123 us, above the 181 MB output's 54 us.  Shared memory's
// bandwidth, one 32-lane read a cycle an SM, is the practical limit: ~48 us
// for the nearest build's 3.6e8 reads.  A first design read F per (cell,
// beam) through L2 (26 reads a cell scattered over +-42 cells of a 430 KB
// image, 1.4 GB of L2 traffic a build).  Design: a block of 16 warps owns
// an output tile of 32 x 96 cells (a warp's 32 columns; each thread 6
// rows) and stages in dynamic shared memory the field window that the
// tile's shifts reach, the tile grown by a halo of R cells on each side
// (one more row and column for bilinear), indices wrapped modulo hp and wp.
// It walks its bins in batches of 16, one bin a warp: each warp stages its
// bin's unmasked beams in beam order (at most kSlots; more go through a
// chunked loop), then the block sums the batch's bins one after another
// from shared memory, with one barrier a batch.  R comes from the caller
// (the pad of likelihood_field_lut.scan_lut_padded, which bounds the
// scan's offsets), cut to what shared memory holds; a (bin, beam) whose
// shift falls outside the window is read through L2 by the same threads
// (its stager marks it).  The grid is one wave of resident blocks; each
// owns a contiguous range of the (tile, bin) pairs in tile-major order, so
// that the work is split evenly and a block stages a window once for each
// tile its range touches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;  // a warp's columns
constexpr int kWarps = 16;
constexpr int kRows = 6;  // rows a thread computes
constexpr int kTileY = kWarps * kRows;
constexpr int kThreads = kTileX * kWarps;
constexpr int kSlots = 64;  // unmasked beams of one bin staged at a time

// a staged (bin, beam): off >= 0 is its offset in the window (row-major, the
// halo included); off < 0 marks a shift outside the window, -1 - (sy * wp + sx)
struct Beam {
  int off;
  float c0, c1, ax;  // m (nearest) or m * (1 - ay); m * ay; ax
};

// the block's static shared memory (the staged beams and their counts) and
// what is left of the 227 KB a block may hold for the window, 1 KB kept
constexpr int kStaticBytes =
    sizeof(Beam) * (kWarps + 1) * kSlots + sizeof(int) * (2 * kWarps + 2);
constexpr int kMaxWindowBytes = 232448 - kStaticBytes - 1024;

// where the (bin, beam) terms come from: the tables, or the scan
struct Source {
  const int32_t* __restrict__ shifts;  // [K, nb, 2] (sy, sx)
  const float* __restrict__ weights;   // [K, nb, 3] (m, ax, ay)
  const float* __restrict__ points;    // [nb, 2] in the base frame
  const uint8_t* __restrict__ mask;    // [nb]
  const float* __restrict__ trig;      // [K, 2] (cos, sin) of the bins
  float res;
};

__device__ __forceinline__ int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// (-i) mod n, non-negative, for any int64 i (torch.remainder(-i, n))
__device__ __forceinline__ int neg_mod(long long i, int n) {
  if (i > -n && i < n) {
    const int v = static_cast<int>(i);
    return v > 0 ? n - v : -v;
  }
  const long long v = i % n;
  return static_cast<int>(v > 0 ? n - v : -v);
}

// the signed offset d = -s (mod n) with |d| <= halo, if there is one
__device__ __forceinline__ bool in_halo(int s, int n, int halo, int& d) {
  const int up = s == 0 ? 0 : n - s;
  if (up <= halo) {
    d = up;
    return true;
  }
  if (n - up <= halo) {
    d = up - n;
    return true;
  }
  return false;
}

// One warp stages bin k's beams with m != 0, from beam `from` on, in beam
// order, into out (at most kSlots); a masked beam adds +0 to both sums, so
// leaving it out changes no bit.  Returns how many; *next is the first beam
// not looked at.
template <bool Bilinear, bool FromPoints>
__device__ __forceinline__ int stage_bin(const Source& src, int k, int nb, int hp, int wp,
                                         int halo, int ww, int from, Beam* out, int* next) {
  const int lane = threadIdx.x;
  int live = 0, b0 = from;
  float c = 0.0f, s = 0.0f;
  if (FromPoints) {
    c = __ldg(src.trig + 2 * k);
    s = __ldg(src.trig + 2 * k + 1);
  }
  while (b0 < nb && live <= kSlots - 32) {
    const int b = b0 + lane;
    const size_t kb = static_cast<size_t>(k) * nb + b;
    float m = 0.0f, ax = 0.0f, ay = 0.0f;
    int sy = 0, sx = 0;
    if (FromPoints) {
      if (b < nb && __ldg(src.mask + b) != 0) {
        m = 1.0f;
        const float px = __ldg(src.points + 2 * b), py = __ldg(src.points + 2 * b + 1);
        const float ox = __fdiv_rn(__fsub_rn(__fmul_rn(c, px), __fmul_rn(s, py)), src.res);
        const float oy = __fdiv_rn(__fadd_rn(__fmul_rn(s, px), __fmul_rn(c, py)), src.res);
        const float fx = Bilinear ? floorf(ox) : rintf(ox);
        const float fy = Bilinear ? floorf(oy) : rintf(oy);
        if (Bilinear) {
          ax = __fsub_rn(ox, fx);
          ay = __fsub_rn(oy, fy);
        }
        sy = neg_mod(static_cast<long long>(fy), hp);
        sx = neg_mod(static_cast<long long>(fx), wp);
      }
    } else if (b < nb) {
      m = __ldg(src.weights + 3 * kb);
      if (m != 0.0f) {
        ax = __ldg(src.weights + 3 * kb + 1);
        ay = __ldg(src.weights + 3 * kb + 2);
        sy = __ldg(src.shifts + 2 * kb);
        sx = __ldg(src.shifts + 2 * kb + 1);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, m != 0.0f);
    if (m != 0.0f) {
      int dy, dx;
      const bool near = in_halo(sy, hp, halo, dy) && in_halo(sx, wp, halo, dx);
      out[live + __popc(ballot & ((1u << lane) - 1u))] =
          Beam{near ? (dy + halo) * ww + dx + halo : -1 - (sy * wp + sx),
               Bilinear ? __fmul_rn(m, __fsub_rn(1.0f, ay)) : m, __fmul_rn(m, ay), ax};
    }
    live += __popc(ballot);
    b0 += 32;
  }
  *next = b0;
  return live;
}

// The thread's kRows cells (x, y0 + r) summed over `live` staged beams.
template <bool Bilinear>
__device__ __forceinline__ void accumulate(const Beam* beams, int live, const float* base0,
                                           int ww, const float* __restrict__ field, int hp,
                                           int wp, int x, int y0, float* acc_u, float* acc_v) {
  for (int j = 0; j < live; ++j) {
    const Beam bm = beams[j];
    if (bm.off >= 0) {  // from the window
      const float* base = base0 + bm.off;
      if (!Bilinear) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc_u[r] = __fadd_rn(acc_u[r], __fmul_rn(bm.c0, base[r * ww]));
        }
        continue;
      }
      float a0 = base[0], a1 = base[1];
      float u = __fadd_rn(a0, __fmul_rn(bm.ax, __fsub_rn(a1, a0)));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a0 = base[(r + 1) * ww];
        a1 = base[(r + 1) * ww + 1];
        const float u1 = __fadd_rn(a0, __fmul_rn(bm.ax, __fsub_rn(a1, a0)));
        acc_u[r] = __fadd_rn(acc_u[r], __fmul_rn(bm.c0, u));
        acc_v[r] = __fadd_rn(acc_v[r], __fmul_rn(bm.c1, u1));
        u = u1;
      }
      continue;
    }
    // through L2: the shift lies outside the window
    const int packed = -1 - bm.off;
    const int sy = packed / wp, sx = packed - sy * wp;
    const int cx = wrap(x - sx, wp);
    const int cx1 = cx + 1 == wp ? 0 : cx + 1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ry = wrap(y0 + r - sy, hp);
      const float* row0 = field + static_cast<size_t>(ry) * wp;
      if (!Bilinear) {
        acc_u[r] = __fadd_rn(acc_u[r], __fmul_rn(bm.c0, __ldg(row0 + cx)));
        continue;
      }
      const int ry1 = ry + 1 == hp ? 0 : ry + 1;
      const float* row1 = field + static_cast<size_t>(ry1) * wp;
      const float a0 = __ldg(row0 + cx), a1 = __ldg(row0 + cx1);
      const float b0 = __ldg(row1 + cx), b1 = __ldg(row1 + cx1);
      const float u0 = __fadd_rn(a0, __fmul_rn(bm.ax, __fsub_rn(a1, a0)));
      const float u1 = __fadd_rn(b0, __fmul_rn(bm.ax, __fsub_rn(b1, b0)));
      acc_u[r] = __fadd_rn(acc_u[r], __fmul_rn(bm.c0, u0));
      acc_v[r] = __fadd_rn(acc_v[r], __fmul_rn(bm.c1, u1));
    }
  }
}

template <bool Bilinear, bool FromPoints>
__global__ void __launch_bounds__(kThreads)
    scan_lut_kernel(const float* __restrict__ field, int hp, int wp, Source src, int n_theta,
                    int nb, int halo, int tiles_x, long long total, float* __restrict__ out) {
  extern __shared__ float win[];
  __shared__ Beam s_beam[kWarps][kSlots];  // a batch: warp w stages bin k + w
  __shared__ Beam s_more[kSlots];          // a bin's beams past its first kSlots
  __shared__ int s_live[kWarps], s_next[kWarps], s_more_live, s_more_next;
  constexpr int e = Bilinear ? 1 : 0;
  const int ww = kTileX + 2 * halo + e, wh = kTileY + 2 * halo + e;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* base0 = win + ty * kRows * ww + tx;
  const long long begin = blockIdx.x * total / gridDim.x;
  const long long end = (blockIdx.x + 1) * total / gridDim.x;
  int staged = -1;
  for (long long idx = begin; idx < end;) {
    const int tile = static_cast<int>(idx / n_theta);
    const int k0 = static_cast<int>(idx - static_cast<long long>(tile) * n_theta);
    const int count = static_cast<int>(min(min(static_cast<long long>(kWarps), end - idx),
                                           static_cast<long long>(n_theta - k0)));
    const int x0 = (tile % tiles_x) * kTileX, y0 = (tile / tiles_x) * kTileY;
    __syncthreads();  // every read of the last batch's beams and window is done
    if (tile != staged) {
      for (int c = tx; c < ww; c += kTileX) {
        const int col = wrap(x0 - halo + c, wp);
        int row = wrap(y0 - halo + ty, hp);
        for (int i = ty; i < wh; i += kWarps) {
          win[i * ww + c] = __ldg(field + static_cast<size_t>(row) * wp + col);
          row += kWarps;
          while (row >= hp) row -= hp;
        }
      }
      staged = tile;
    }
    if (ty < count) {  // a batch of bins, one a warp
      int next;
      const int live = stage_bin<Bilinear, FromPoints>(src, k0 + ty, nb, hp, wp, halo, ww, 0,
                                                       s_beam[ty], &next);
      if (tx == 0) {
        s_live[ty] = live;
        s_next[ty] = next;
      }
    }
    __syncthreads();
    const int x = x0 + tx, y = y0 + ty * kRows;
    for (int g = 0; g < count; ++g) {
      float acc_u[kRows], acc_v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_u[r] = acc_v[r] = 0.0f;
      accumulate<Bilinear>(s_beam[g], s_live[g], base0, ww, field, hp, wp, x, y, acc_u, acc_v);
      for (int next = s_next[g]; next < nb;) {  // the bin's beams past its first kSlots
        __syncthreads();  // the last chunk is read
        if (ty == 0) {
          int more_next;
          const int live = stage_bin<Bilinear, FromPoints>(src, k0 + g, nb, hp, wp, halo, ww,
                                                           next, s_more, &more_next);
          if (tx == 0) {
            s_more_live = live;
            s_more_next = more_next;
          }
        }
        __syncthreads();
        accumulate<Bilinear>(s_more, s_more_live, base0, ww, field, hp, wp, x, y, acc_u, acc_v);
        next = s_more_next;
      }
      if (x < wp) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (y + r < hp) {
            out[(static_cast<size_t>(k0 + g) * hp + y + r) * wp + x] =
                Bilinear ? __fadd_rn(acc_u[r], acc_v[r]) : acc_u[r];
          }
        }
      }
    }
    idx += count;
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

size_t window_bytes(int halo, int e) {
  return sizeof(float) * static_cast<size_t>(kTileX + 2 * halo + e) * (kTileY + 2 * halo + e);
}

template <bool Bilinear, bool FromPoints>
int launch(const float* field, int hp, int wp, const Source& src, int n_theta, int nb,
           int halo, float* out, cudaStream_t stream) {
  auto kernel = scan_lut_kernel<Bilinear, FromPoints>;
  static bool sized = false;  // the dynamic shared memory allowed, once
  if (!sized) {
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxWindowBytes)) {
      return static_cast<int>(err);
    }
    sized = true;
  }
  // the halo asked for (a negative one: as large as fits), cut to what
  // shared memory holds; beams beyond it are read through L2
  constexpr int e = Bilinear ? 1 : 0;
  int r = halo;
  if (r < 0 || window_bytes(r, e) > kMaxWindowBytes) {
    r = 0;
    while (window_bytes(r + 1, e) <= kMaxWindowBytes && (halo < 0 || r + 1 <= halo)) ++r;
  }
  const size_t smem = window_bytes(r, e);
  static size_t last_smem = 0;  // resident blocks an SM, for the last window size
  static int last_blocks = 0;
  if (smem != last_smem) {
    if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &last_blocks, kernel, kThreads, static_cast<int>(smem))) {
      return static_cast<int>(err);
    }
    last_smem = smem;
  }
  const int tiles_x = (wp + kTileX - 1) / kTileX;
  const long long total =
      static_cast<long long>(tiles_x) * ((hp + kTileY - 1) / kTileY) * n_theta;
  const long long resident =
      static_cast<long long>(num_sms()) * (last_blocks > 0 ? last_blocks : 1);
  const int grid = static_cast<int>(total < resident ? total : resident);
  kernel<<<grid, dim3(kTileX, kWarps), smem, stream>>>(field, hp, wp, src, n_theta, nb, r,
                                                       tiles_x, total, out);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* field, int hp, int wp, const Source& src, bool from_points,
             int n_theta, int nb, int bilinear, int halo, void* out, void* stream) {
  if (n_theta == 0 || hp == 0 || wp == 0) return 0;
  const auto f = static_cast<const float*>(field);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (from_points) {
    return bilinear ? launch<true, true>(f, hp, wp, src, n_theta, nb, halo, o, s)
                    : launch<false, true>(f, hp, wp, src, n_theta, nb, halo, o, s);
  }
  return bilinear ? launch<true, false>(f, hp, wp, src, n_theta, nb, halo, o, s)
                  : launch<false, false>(f, hp, wp, src, n_theta, nb, halo, o, s);
}

}  // namespace

// B9 over n_theta bins from tables: field float32 [hp, wp], shifts int32
// [n_theta, nb, 2], weights float32 [n_theta, nb, 3] (m, ax, ay), out
// float32 [n_theta, hp, wp]; bilinear non-zero samples bilinearly, else
// nearest; halo the window's margin in cells (negative: as large as shared
// memory holds).  Returns cudaGetLastError() of the launch.
extern "C" int beluga_scan_lut(const void* field, int hp, int wp, const void* shifts,
                               const void* weights, int n_theta, int nb, int bilinear,
                               int halo, void* out, void* stream) {
  Source src{static_cast<const int32_t*>(shifts), static_cast<const float*>(weights),
             nullptr, nullptr, nullptr, 0.0f};
  return dispatch(field, hp, wp, src, false, n_theta, nb, bilinear, halo, out, stream);
}

// B9 from the scan, its tables built in the prologue: points float32 [nb, 2],
// mask uint8 [nb], trig float32 [n_theta, 2] (cos, sin of the bins), res
// the cell size in metres as float32; otherwise as beluga_scan_lut.
extern "C" int beluga_scan_lut_points(const void* field, int hp, int wp, const void* points,
                                      const void* mask, const void* trig, float res,
                                      int n_theta, int nb, int bilinear, int halo, void* out,
                                      void* stream) {
  Source src{nullptr, nullptr, static_cast<const float*>(points),
             static_cast<const uint8_t*>(mask), static_cast<const float*>(trig), res};
  return dispatch(field, hp, wp, src, true, n_theta, nb, bilinear, halo, out, stream);
}

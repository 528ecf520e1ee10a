// Kernel E1: the SE2 estimate, every filter's weighted mean and covariance
// in one launch.
//
// Replaces no Pallas kernel: beluga_tpu/algorithms/estimation.py:estimate_se2
// leaves the weighted moments to XLA's reductions.  The port ran them as
// ~38 PyTorch operations and a [2, N] @ [N, 2] batched GEMM a call: 2.31
// device ms on an H100 at 4096 filters of 4096 particles, whose bytes need
// 0.100.
// Per filter f, what algorithms/estimation.py:estimate_se2_reference and
// se2_from_moments compute:
//
//   w_i    = i < active[f] ? expf(log_weight[f, i]) : 0     (the log entry)
//            mask[f, i] ? weight[f, i] : 0                   (the weight entry)
//   W      = sum w_i,  mean = sum w_i xy_i / W,  zbar = sum w_i z_i / W
//   cov_t  = sum w_i (xy_i - mean)(xy_i - mean)^T / W / max(1 - sum w_i^2 / W^2, 1e-9)
//   yaw    = zbar / |zbar|, variance -2 log |zbar|; where |zbar| < 1e-7 the
//            identity rotation and an infinite variance
//
// written as the mean's (x, y), its rotation's (cos, sin) and the [3, 3]
// covariance (cov_t, 0, 0, yaw variance).  W == 0 gives a zero mean and
// covariance, the identity rotation and an infinite yaw variance, as the
// plain version does.
//
// What bounds it on an H100: the bytes, 20 a particle (a float log-weight or
// weight, the (x, y) and (cos, sin) pairs; a mask byte more in the weight
// entry), 52 a filter out; the arithmetic is ~25 float operations a
// particle, far below the card's rate.  Design:
//  * each particle is read once: a block takes a tile of 1024 * kPairs
//    slots of one filter, a thread kPairs pairs of neighbouring slots, the
//    pair's log-weights as one 8-byte load and its (x, y) and (cos, sin) as
//    16-byte loads, neighbouring threads on neighbouring pairs (scalar loads
//    where a row is not aligned for them); slots past the live prefix are
//    not read;
//  * the weights and translations stay in registers: the first moments are
//    reduced (warp shuffles, then the warps in a fixed order), and the
//    centred second moments are taken from the registers about the tile's
//    mean, with the residual sum w (xy - mean) carried so the tile's mean
//    and covariance stay exact to float32 rounding far from the origin
//    (raw second moments minus mean^2 cancel there);
//  * a filter of one tile is one block, which writes the estimate; a longer
//    filter (or one of few filters, which would leave SMs idle) spans
//    blocks: each writes its tile's partial moments, and the block that
//    counts itself last (an integer atomic a filter, left 0 for the next
//    launch) combines them in a fixed order, in float64, the tiles' spread
//    about the filter's mean added to their centred sums.  No float atomic:
//    a call gives the same bits every run.
//  * the per-filter epilogue (normalisation, the 1 / (1 - sum w^2) correction,
//    the log and the degenerate yaw) is one thread's float64 arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPartial = 11;  // floats of a tile's partial moments

struct Rows {
  const float* w;         // log-weights (log entry) or weights, rows of w_stride
  const uint8_t* mask;    // weight entry: live slots (bool), or null for all
  const int32_t* active;  // log entry: each filter's live prefix, else null
  const float* xy;        // (x, y) pairs, rows of xy_stride floats
  const float* z;         // (cos, sin) pairs, rows of z_stride floats
  long long w_stride, mask_stride, xy_stride, z_stride;
  int n;                  // slots a filter
};

struct Out {
  float* cov;   // [filters, 3, 3]
  float* xy;    // [filters, 2]
  float* rot;   // [filters, 2]
};

// The estimate of filter f from its moments: W, sum w^2, the mean (x, y),
// the centred sums about it (xx, xy, yy) and sum w z.
__device__ void write_estimate(const Out& out, size_t f, double W, double W2, double mx,
                               double my, double sxx, double sxy, double syy, double zc,
                               double zs) {
  const double inv = 1.0 / fmax(W, 1e-38);
  const double corr = fmax(1.0 - W2 * inv * inv, 1e-9);
  const double scale = inv / corr;
  const double mean_x = W * mx * inv, mean_y = W * my * inv;
  const double c = zc * inv, s = zs * inv;
  const double norm = sqrt(c * c + s * s);
  const bool degenerate = norm < 1e-7;
  out.xy[2 * f] = static_cast<float>(mean_x);
  out.xy[2 * f + 1] = static_cast<float>(mean_y);
  out.rot[2 * f] = degenerate ? 1.0f : static_cast<float>(c / norm);
  out.rot[2 * f + 1] = degenerate ? 0.0f : static_cast<float>(s / norm);
  float* cov = out.cov + 9 * f;
  const float cxy = static_cast<float>(sxy * scale);
  cov[0] = static_cast<float>(sxx * scale);
  cov[1] = cxy;
  cov[2] = 0.0f;
  cov[3] = cxy;
  cov[4] = static_cast<float>(syy * scale);
  cov[5] = 0.0f;
  cov[6] = 0.0f;
  cov[7] = 0.0f;
  cov[8] = degenerate ? INFINITY : static_cast<float>(-2.0 * log(fmax(norm, 1e-38)));
}

// The combine of filter f's `chunks` tile partials (this launch's, read
// through L2) and its estimate, by the whole block.
__device__ void combine(const float* part, int chunks, const Out& out, size_t f,
                        double* shared) {
  double a[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // W, sum w^2, W mean (x, y), sum w z
  for (int b = threadIdx.x; b < chunks; b += kThreads) {
    const float* q = part + static_cast<size_t>(b) * kPartial;
    const double wb = __ldcg(q);
    if (wb > 0.0) {
      a[0] += wb;
      a[2] += wb * __ldcg(q + 2) + __ldcg(q + 4);  // W_b (m_b + c_b / W_b)
      a[3] += wb * __ldcg(q + 3) + __ldcg(q + 5);
    }
    a[1] += __ldcg(q + 1);
    a[4] += __ldcg(q + 9);
    a[5] += __ldcg(q + 10);
  }
  block_sum<kWarps>(a, shared);
  const double W = a[0];
  const double mx = W > 0.0 ? a[2] / W : 0.0, my = W > 0.0 ? a[3] / W : 0.0;
  double s[3] = {0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < chunks; b += kThreads) {
    const float* q = part + static_cast<size_t>(b) * kPartial;
    const double wb = __ldcg(q);
    if (wb > 0.0) {
      const double cx = __ldcg(q + 4), cy = __ldcg(q + 5);
      const double dx = __ldcg(q + 2) + cx / wb - mx, dy = __ldcg(q + 3) + cy / wb - my;
      s[0] += __ldcg(q + 6) - cx * cx / wb + wb * dx * dx;
      s[1] += __ldcg(q + 7) - cx * cy / wb + wb * dx * dy;
      s[2] += __ldcg(q + 8) - cy * cy / wb + wb * dy * dy;
    }
  }
  block_sum<kWarps>(s, shared);
  if (threadIdx.x == 0) write_estimate(out, f, W, a[1], mx, my, s[0], s[1], s[2], a[4], a[5]);
}

// Block b of filter b / chunks takes its tile (chunk b % chunks) of
// kThreads * kPairs slot pairs.  kLog: the log entry; kVec: every row is
// aligned for the 8- and 16-byte loads.  `partials` [filters * chunks *
// kPartial] and `counts` [filters] serve chunks > 1.
template <bool kLog, bool kVec, int kPairs>
__global__ void __launch_bounds__(kThreads, 2)
    estimate_kernel(Rows r, int chunks, float* __restrict__ partials,
                    unsigned int* __restrict__ counts, Out out) {
  __shared__ float fshared[kWarps * 6];
  __shared__ double dshared[kWarps * 6];
  __shared__ bool last;
  const size_t f = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - f * chunks);
  const float* wrow = r.w + f * r.w_stride;
  const float* xyrow = r.xy + f * r.xy_stride;
  const float* zrow = r.z + f * r.z_stride;
  // slots at or past `live` weigh 0 and are not read (the weight entry
  // reads them all: its mask is per slot)
  const int live = kLog ? max(0, min(__ldg(r.active + f), r.n)) : r.n;

  float w[2 * kPairs], x[2 * kPairs], y[2 * kPairs];
  float m1[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // W, sum w^2, sum w x, sum w y, sum w z
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = (chunk * kPairs + k) * kThreads + threadIdx.x;
    const int i = 2 * p;
    float v[2] = {0.0f, 0.0f};
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // x0, y0, x1, y1
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // cos0, sin0, cos1, sin1
    if (kVec && i + 1 < live) {
      const float2 vv = __ldg(reinterpret_cast<const float2*>(wrow) + p);
      a = __ldg(reinterpret_cast<const float4*>(xyrow) + p);
      b = __ldg(reinterpret_cast<const float4*>(zrow) + p);
      v[0] = vv.x;
      v[1] = vv.y;
    } else {
      if (i < live) {
        v[0] = __ldg(wrow + i);
        a.x = __ldg(xyrow + 2 * i);
        a.y = __ldg(xyrow + 2 * i + 1);
        b.x = __ldg(zrow + 2 * i);
        b.y = __ldg(zrow + 2 * i + 1);
      }
      if (i + 1 < live) {
        v[1] = __ldg(wrow + i + 1);
        a.z = __ldg(xyrow + 2 * i + 2);
        a.w = __ldg(xyrow + 2 * i + 3);
        b.z = __ldg(zrow + 2 * i + 2);
        b.w = __ldg(zrow + 2 * i + 3);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wi;
      if (kLog) {
        wi = i + h < live ? expf(v[h]) : 0.0f;
      } else {
        const bool in = i + h < live &&
                        (r.mask == nullptr || __ldg(r.mask + f * r.mask_stride + i + h) != 0);
        wi = in ? v[h] : 0.0f;
      }
      const float xi = h ? a.z : a.x, yi = h ? a.w : a.y;
      const float ci = h ? b.z : b.x, si = h ? b.w : b.y;
      w[2 * k + h] = wi;
      x[2 * k + h] = xi;
      y[2 * k + h] = yi;
      m1[0] += wi;
      m1[1] += wi * wi;
      m1[2] += wi * xi;
      m1[3] += wi * yi;
      m1[4] += wi * ci;
      m1[5] += wi * si;
    }
  }
  block_sum<kWarps>(m1, fshared);
  const float W = m1[0];
  const float mx = W > 0.0f ? m1[2] / W : 0.0f, my = W > 0.0f ? m1[3] / W : 0.0f;

  // the centred pass over the registers: sum w d (the tile mean's residual)
  // and sum w d d^T, d = xy - (mx, my)
  float m2[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 2 * kPairs; ++j) {
    const float dx = x[j] - mx, dy = y[j] - my;
    const float wdx = w[j] * dx, wdy = w[j] * dy;
    m2[0] += wdx;
    m2[1] += wdy;
    m2[2] += wdx * dx;
    m2[3] += wdx * dy;
    m2[4] += wdy * dy;
  }
  block_sum<kWarps>(m2, fshared);

  if (chunks == 1) {
    if (threadIdx.x == 0) {
      const double Wd = W;
      const double cx = m2[0], cy = m2[1];
      const double mxd = W > 0.0f ? mx + cx / Wd : 0.0, myd = W > 0.0f ? my + cy / Wd : 0.0;
      const double sxx = W > 0.0f ? m2[2] - cx * cx / Wd : 0.0;
      const double sxy = W > 0.0f ? m2[3] - cx * cy / Wd : 0.0;
      const double syy = W > 0.0f ? m2[4] - cy * cy / Wd : 0.0;
      write_estimate(out, f, Wd, m1[1], mxd, myd, sxx, sxy, syy, m1[4], m1[5]);
    }
    return;
  }

  float* part = partials + f * chunks * kPartial;
  if (threadIdx.x == 0) {
    float* q = part + static_cast<size_t>(chunk) * kPartial;
    q[0] = W;
    q[1] = m1[1];
    q[2] = mx;
    q[3] = my;
    q[4] = m2[0];
    q[5] = m2[1];
    q[6] = m2[2];
    q[7] = m2[3];
    q[8] = m2[4];
    q[9] = m1[4];
    q[10] = m1[5];
    __threadfence();  // the partial before the count
    last = atomicAdd(counts + f, 1u) == static_cast<unsigned int>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other blocks' partials after their counts
  combine(part, chunks, out, f, dshared);
  if (threadIdx.x == 0) counts[f] = 0;  // ready for the next launch on this stream
}

template <bool kLog, bool kVec>
void launch_pairs(int pairs, int grid, cudaStream_t s, const Rows& r, int chunks,
                  float* partials, unsigned int* counts, const Out& out) {
  if (pairs == 4) {
    estimate_kernel<kLog, kVec, 4><<<grid, kThreads, 0, s>>>(r, chunks, partials, counts, out);
  } else {
    estimate_kernel<kLog, kVec, 2><<<grid, kThreads, 0, s>>>(r, chunks, partials, counts, out);
  }
}

}  // namespace

// Threads a block: a tile is 2 * kThreads * pairs slots.
extern "C" int beluga_estimate_threads() { return kThreads; }

// The estimate of `filters` filters of n slots on `stream`, one launch of
// filters * chunks blocks of tiles of 2 * kThreads * pairs slots (pairs 2
// or 4; chunks = max(1, ceil(n / tile)), else cudaErrorInvalidValue).  The
// log entry gives `active` (int32 [filters]) and log-weights in `w`; the
// weight entry gives active null, weights in `w` and `mask` (bool) or null.
// Strides are in elements from one filter's row to the next (0 broadcasts);
// with `vec` every row of w is 8-byte and of xy and z 16-byte aligned.
// With chunks > 1, `partials` float[filters * chunks * 11] and `counts`
// uint32[filters], zero when first used and left zero by every launch.
// Returns cudaGetLastError() of the launch.
extern "C" int beluga_estimate_se2(const void* w, long long w_stride, const void* mask,
                                   long long mask_stride, const void* active, const void* xy,
                                   long long xy_stride, const void* z, long long z_stride,
                                   int n, int filters, int chunks, int pairs, int vec,
                                   void* partials, void* counts, void* cov, void* mean_xy,
                                   void* mean_rot, void* stream) {
  if (filters == 0) return 0;
  const long long tile = 2LL * kThreads * pairs;
  const long long want = n > 0 ? (n + tile - 1) / tile : 1;
  if ((pairs != 2 && pairs != 4) || chunks != want ||
      static_cast<long long>(filters) * chunks > 0x7fffffffLL ||
      (chunks > 1 && (partials == nullptr || counts == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows r{static_cast<const float*>(w), static_cast<const uint8_t*>(mask),
               static_cast<const int32_t*>(active), static_cast<const float*>(xy),
               static_cast<const float*>(z), w_stride, mask_stride, xy_stride, z_stride, n};
  const Out out{static_cast<float*>(cov), static_cast<float*>(mean_xy),
                static_cast<float*>(mean_rot)};
  const int grid = filters * chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  auto* cnt = static_cast<unsigned int*>(counts);
  const bool log_entry = active != nullptr;
  if (log_entry && vec) {
    launch_pairs<true, true>(pairs, grid, s, r, chunks, part, cnt, out);
  } else if (log_entry) {
    launch_pairs<true, false>(pairs, grid, s, r, chunks, part, cnt, out);
  } else if (vec) {
    launch_pairs<false, true>(pairs, grid, s, r, chunks, part, cnt, out);
  } else {
    launch_pairs<false, false>(pairs, grid, s, r, chunks, part, cnt, out);
  }
  return static_cast<int>(cudaGetLastError());
}

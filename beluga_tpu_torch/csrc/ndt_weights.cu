// The fused NDT stencil likelihood: kernel B10 redesigned for the card.
//
// Replaces beluga_tpu/ops/pallas_ndt.py:ndt_probe together with the
// PyTorch arithmetic around it (models/sensor/ndt.py, the probe path).  For
// filter f, particle i with pose (R, t) and each live measurement cell s
// (cell_mask[f, s]) with mean m and covariance S:
//
//   mean_w = R m + t, each row summed left to right, t added last
//   cov_w  = R S R^T
//   cell   = floor(mean_w / res)                   (int32, per axis)
//   for each stencil offset o: key = encode(cell + o) (maps/ndt.py's
//     packing); on an exact match against the map's sorted live keys,
//     e = mean_w - map_mean, T = cov_w + map_cov,
//     lik += d1 * exp(coef * e^T T^-1 e)            (coef = -d2 / 2)
//   out[f, i] = 1 + sum over live cells of max(lik, min_lik)
//
// The world mean and the cell key take the plain version's float32
// operations in its order (__fmul_rn / __fadd_rn, so that nvcc contracts
// nothing into an FMA, and an IEEE division by the resolution), so that a
// mean within an ulp of a cell border falls in the same cell.  In 2D the
// inverse is the plain version's closed form (|det| < 1e-12 -> 1e-12) in
// its operations; in 3D the adjugate of T + 1e-12 I, where the plain
// version takes the library's LU inverse.  A masked slot is never read, so
// a NaN there adds nothing.
//
// What bounds it on an H100: the operations.  Per (particle, live cell):
// the rotation of the mean (2D 6, 3D 15) and of the covariance (2D 16, 3D
// 90), D divisions and floors; per (particle, live cell, stencil offset):
// the key (~6 integer operations) and one compare, what an exact match
// needs, and per hit the error, T, the inverse and the quadratic form (2D
// ~25, 3D ~70) and the exp (counted as 10).  The bytes are the map once,
// the cells once and 4(D^2 + D) + 4 bytes a particle, far below.  The
// binary search below takes ceil(log2(m + 1)) dependent steps a probe
// instead of one compare: that is this design's cost, above the bound.
// The old design wrote a (4 + 4P + 1)-byte row per (particle, cell,
// offset) and read it back through ~30 PyTorch operations and a batched
// library inverse; here nothing between the poses and the weights leaves
// the SM.
//
// Design: a block of kWarps warps works on one filter (blockIdx.y).  Warp
// 0 compacts the filter's live slots, in slot order, into a shared list
// (ballot and popcount); the block stages the map's keys and rows in
// shared memory when they fit (else the same kernel searches them in
// global memory, through L2) and the first cache_cells live cells.  Each
// warp then takes per_warp particles; g lanes (the least power of two, at
// most 32, that covers the live cells) share a particle, so that 32 / g
// particles go through a warp at once; each lane adds its cells in slot
// order and a fixed __shfl_xor_sync tree adds the lanes: no float atomics,
// so a run repeats bit for bit.  One launch over the whole particle axis:
// the kernel has no intermediates to bound, so no chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxOffsets = 32;
constexpr int kTargetBlocks = 132 * 4;        // a few blocks on every SM
constexpr size_t kMapSmemLimit = 64 * 1024;   // a larger map is read through L2
constexpr size_t kCellCacheBytes = 32 * 1024;

struct Params {
  int m, n, c, k, per_warp, cache_cells;
  float res, min_lik, d1, coef;
  int off[kMaxOffsets * 3];
};

template <int D>
__device__ __forceinline__ uint32_t encode(const int* cell, const int* off) {
  // unsigned sums wrap as the plain version's int32 sums do; only the low
  // bits of each axis reach the key
  if constexpr (D == 2) {
    const uint32_t x = static_cast<uint32_t>(cell[0]) + static_cast<uint32_t>(off[0]) + 32768u;
    const uint32_t y = static_cast<uint32_t>(cell[1]) + static_cast<uint32_t>(off[1]) + 32768u;
    return (x << 16) | (y & 0xFFFFu);
  } else {
    const uint32_t x = static_cast<uint32_t>(cell[0]) + static_cast<uint32_t>(off[0]) + 512u;
    const uint32_t y = static_cast<uint32_t>(cell[1]) + static_cast<uint32_t>(off[1]) + 512u;
    const uint32_t z = static_cast<uint32_t>(cell[2]) + static_cast<uint32_t>(off[2]) + 512u;
    return ((x & 1023u) << 20) | ((y & 1023u) << 10) | (z & 1023u);
  }
}

// e^T (T + 1e-12 I)^-1 e by the adjugate: a^-1 = C^T / det, C the cofactors
__device__ __forceinline__ float quad_form_3x3(const float* t, const float* e) {
  float a[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) a[j] = t[j];
  a[0] += 1e-12f;
  a[4] += 1e-12f;
  a[8] += 1e-12f;
  const float c00 = a[4] * a[8] - a[5] * a[7];
  const float c01 = a[5] * a[6] - a[3] * a[8];
  const float c02 = a[3] * a[7] - a[4] * a[6];
  const float c10 = a[2] * a[7] - a[1] * a[8];
  const float c11 = a[0] * a[8] - a[2] * a[6];
  const float c12 = a[1] * a[6] - a[0] * a[7];
  const float c20 = a[1] * a[5] - a[2] * a[4];
  const float c21 = a[2] * a[3] - a[0] * a[5];
  const float c22 = a[0] * a[4] - a[1] * a[3];
  const float det = a[0] * c00 + a[1] * c01 + a[2] * c02;
  // sum_ij e_i (C^T)_ij e_j = sum_ij e_i C_ji e_j
  const float q = e[0] * (c00 * e[0] + c10 * e[1] + c20 * e[2]) +
                  e[1] * (c01 * e[0] + c11 * e[1] + c21 * e[2]) +
                  e[2] * (c02 * e[0] + c12 * e[1] + c22 * e[2]);
  return q / det;
}

// e^T T^-1 e
template <int D>
__device__ __forceinline__ float quad_form(const float* t, const float* e) {
  if constexpr (D == 2) {  // inv_2x2's operations: adj * (1 / det), then the two sums
    const float det = __fsub_rn(__fmul_rn(t[0], t[3]), __fmul_rn(t[1], t[2]));
    const float inv_det = __frcp_rn(fabsf(det) < 1e-12f ? 1e-12f : det);
    const float i00 = __fmul_rn(t[3], inv_det), i01 = __fmul_rn(-t[1], inv_det);
    const float i10 = __fmul_rn(-t[2], inv_det), i11 = __fmul_rn(t[0], inv_det);
    const float v0 = __fadd_rn(__fmul_rn(e[0], i00), __fmul_rn(e[1], i10));
    const float v1 = __fadd_rn(__fmul_rn(e[0], i01), __fmul_rn(e[1], i11));
    return __fadd_rn(__fmul_rn(v0, e[0]), __fmul_rn(v1, e[1]));
  } else {
    return quad_form_3x3(t, e);
  }
}

template <int D, bool kSharedMap>
__global__ void __launch_bounds__(kThreads)
    ndt_weights_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ values,
                       const float* __restrict__ rot, const float* __restrict__ trans,
                       const float* __restrict__ means, const float* __restrict__ covs,
                       const uint8_t* __restrict__ cell_mask, const Params p,
                       float* __restrict__ out) {
  constexpr int P = D + D * D;  // a map row and a measurement cell: mean, covariance
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_vals = reinterpret_cast<float*>(smem);          // [m][P] when kSharedMap
  float* s_cells = s_vals + (kSharedMap ? p.m * P : 0);    // [cache_cells][P]
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_cells + p.cache_cells * P);
  uint16_t* s_live = reinterpret_cast<uint16_t*>(s_keys + (kSharedMap ? p.m : 0));  // [c]
  __shared__ int s_count;
  __shared__ int s_off[kMaxOffsets * 3];

  const int f = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {  // the live slots in slot order
    const uint8_t* mask = cell_mask + static_cast<size_t>(f) * p.c;
    int count = 0;
    for (int base = 0; base < p.c; base += 32) {
      const int s = base + lane;
      const bool live = s < p.c && mask[s] != 0;
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
      if (live) s_live[count + __popc(ballot & ((1u << lane) - 1u))] = static_cast<uint16_t>(s);
      count += __popc(ballot);
    }
    if (lane == 0) s_count = count;
  }
  for (int j = threadIdx.x; j < p.k * D; j += blockDim.x) s_off[j] = p.off[j];
  if (kSharedMap) {
    for (int j = threadIdx.x; j < p.m; j += blockDim.x) s_keys[j] = keys[j];
    for (int j = threadIdx.x; j < p.m * P; j += blockDim.x) s_vals[j] = values[j];
  }
  __syncthreads();
  const int live = s_count;
  const float* f_means = means + static_cast<size_t>(f) * p.c * D;
  const float* f_covs = covs + static_cast<size_t>(f) * p.c * D * D;
  const int cached = min(live, p.cache_cells);
  for (int j = threadIdx.x; j < cached * P; j += blockDim.x) {
    const int cell = j / P, e = j - cell * P;
    const size_t s = s_live[cell];
    s_cells[j] = e < D ? f_means[s * D + e] : f_covs[s * D * D + (e - D)];
  }
  __syncthreads();

  const uint32_t* k_tab = kSharedMap ? s_keys : keys;
  const float* v_tab = kSharedMap ? s_vals : values;
  int g = 32;  // lanes a particle
  while (g > 1 && (g >> 1) >= live) g >>= 1;
  const int sub = lane / g, lane_in = lane - sub * g;
  const int first = (blockIdx.x * kWarps + warp) * p.per_warp;
  const int end = min(first + p.per_warp, p.n);
  for (int base = first; base < end; base += 32 / g) {
    const int i = base + sub;
    float acc = 0.0f;
    if (i < end) {
      const size_t pi = static_cast<size_t>(f) * p.n + i;
      float r[D * D], t[D];
#pragma unroll
      for (int j = 0; j < D * D; ++j) r[j] = __ldg(rot + pi * D * D + j);
#pragma unroll
      for (int j = 0; j < D; ++j) t[j] = __ldg(trans + pi * D + j);
      for (int j = lane_in; j < live; j += g) {
        float mu[D], sg[D * D];
        if (j < cached) {
#pragma unroll
          for (int e = 0; e < D; ++e) mu[e] = s_cells[j * P + e];
#pragma unroll
          for (int e = 0; e < D * D; ++e) sg[e] = s_cells[j * P + D + e];
        } else {
          const size_t s = s_live[j];
#pragma unroll
          for (int e = 0; e < D; ++e) mu[e] = __ldg(f_means + s * D + e);
#pragma unroll
          for (int e = 0; e < D * D; ++e) sg[e] = __ldg(f_covs + s * D * D + e);
        }
        float mw[D], cw[D * D], rs[D * D];
        int cell[D];
#pragma unroll
        for (int a = 0; a < D; ++a) {
          float v = __fmul_rn(r[a * D], mu[0]);
#pragma unroll
          for (int b = 1; b < D; ++b) v = __fadd_rn(v, __fmul_rn(r[a * D + b], mu[b]));
          mw[a] = __fadd_rn(v, t[a]);
          cell[a] = static_cast<int>(floorf(__fdiv_rn(mw[a], p.res)));
        }
#pragma unroll
        for (int a = 0; a < D; ++a) {  // R S, then (R S) R^T, as products then sums
#pragma unroll
          for (int b = 0; b < D; ++b) {
            float v = __fmul_rn(r[a * D], sg[b]);
#pragma unroll
            for (int q = 1; q < D; ++q) v = __fadd_rn(v, __fmul_rn(r[a * D + q], sg[q * D + b]));
            rs[a * D + b] = v;
          }
        }
#pragma unroll
        for (int a = 0; a < D; ++a) {
#pragma unroll
          for (int b = 0; b < D; ++b) {
            float v = __fmul_rn(rs[a * D], r[b * D]);
#pragma unroll
            for (int q = 1; q < D; ++q) v = __fadd_rn(v, __fmul_rn(rs[a * D + q], r[b * D + q]));
            cw[a * D + b] = v;
          }
        }
        float sum = 0.0f;
        for (int o = 0; o < p.k; ++o) {
          const uint32_t key = encode<D>(cell, s_off + o * D);
          int lo = 0, hi = p.m;
          while (lo < hi) {  // the first key >= key
            const int mid = (lo + hi) >> 1;
            if (k_tab[mid] < key) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          if (lo >= p.m || k_tab[lo] != key) continue;
          const float* row = v_tab + static_cast<size_t>(lo) * P;
          float e[D], tt[D * D];
#pragma unroll
          for (int a = 0; a < D; ++a) e[a] = __fsub_rn(mw[a], row[a]);
#pragma unroll
          for (int a = 0; a < D * D; ++a) tt[a] = __fadd_rn(cw[a], row[D + a]);
          sum += __fmul_rn(p.d1, expf(__fmul_rn(p.coef, quad_form<D>(tt, e))));
        }
        acc += sum < p.min_lik ? p.min_lik : sum;  // a NaN stays NaN, as in clamp_min
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (i < end && lane_in == 0) out[static_cast<size_t>(f) * p.n + i] = 1.0f + acc;
  }
}

template <int D, bool kSharedMap>
int launch(const void* keys, const void* values, const void* rot, const void* trans,
           const void* means, const void* covs, const void* mask, int filters, const Params& p,
           size_t smem, void* out, cudaStream_t stream) {
  const auto kernel = ndt_weights_kernel<D, kSharedMap>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_block = kWarps * p.per_warp;
  const dim3 grid((p.n + per_block - 1) / per_block, filters);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(values),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(means), static_cast<const float*>(covs),
      static_cast<const uint8_t*>(mask), p, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The weights of `filters` filters of n particles: keys uint32 [>= m]
// sorted (m live), values float32 [>= m][D + D*D]; rot float32 [filters,
// n, D, D], trans float32 [filters, n, D]; means float32 [filters, c, D],
// covs float32 [filters, c, D, D], mask uint8 [filters, c]; offsets int
// [k][D] on the host (k <= 32); coef = -d2 / 2.  Writes out float32
// [filters, n].  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for inputs the kernel does not take.
extern "C" int beluga_ndt_weights(const void* keys, int m, const void* values, const void* rot,
                                  const void* trans, const void* means, const void* covs,
                                  const void* mask, int filters, int n, int c, int d,
                                  const int* offsets, int k, float res, float min_lik, float d1,
                                  float coef, void* out, void* stream) {
  if (n == 0 || filters == 0) return 0;
  if ((d != 2 && d != 3) || k < 1 || k > kMaxOffsets || c < 0 || c > 32768 || filters > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.m = m;
  p.n = n;
  p.c = c;
  p.k = k;
  p.res = res;
  p.min_lik = min_lik;
  p.d1 = d1;
  p.coef = coef;
  for (int j = 0; j < k * d; ++j) p.off[j] = offsets[j];
  const long long total = static_cast<long long>(filters) * n;
  p.per_warp = 1;
  while (p.per_warp < 32 && total / (2LL * kWarps * p.per_warp) >= kTargetBlocks) {
    p.per_warp *= 2;
  }
  const size_t row = sizeof(float) * (d + d * d);
  p.cache_cells = static_cast<int>(kCellCacheBytes / row);
  if (p.cache_cells > c) p.cache_cells = c;
  const size_t map_bytes = (row + sizeof(uint32_t)) * static_cast<size_t>(m);
  const bool shared_map = map_bytes <= kMapSmemLimit;
  const size_t smem = row * p.cache_cells + (shared_map ? map_bytes : 0) +
                      sizeof(uint16_t) * static_cast<size_t>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) {
    return shared_map ? launch<2, true>(keys, values, rot, trans, means, covs, mask, filters, p,
                                        smem, out, s)
                      : launch<2, false>(keys, values, rot, trans, means, covs, mask, filters, p,
                                         smem, out, s);
  }
  return shared_map ? launch<3, true>(keys, values, rot, trans, means, covs, mask, filters, p,
                                      smem, out, s)
                    : launch<3, false>(keys, values, rot, trans, means, covs, mask, filters, p,
                                       smem, out, s);
}

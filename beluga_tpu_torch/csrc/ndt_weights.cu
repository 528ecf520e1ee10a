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
// finding the probe's row; per hit the error, T, the inverse and the
// quadratic form (2D ~25, 3D ~70) and the exp (counted as 10).  The bytes
// are the map once, the cells once and 4(D^2 + D) + 4 bytes a particle,
// far below.
//
// Finding a row.  A map whose live keys fit a box of at most 2^15 cells
// (every map the repo runs: 48 x 48 live cells for the 2D arena, 39 x 39 x
// 4 in 3D, each with a cell of padding on every side) comes with a dense
// cell -> row index over that box (maps/ndt.py:CellIndex), held here in
// shared memory as int16; a binary search of the sorted keys took
// ceil(log2(m + 1)) dependent loads a probe, each with a compare and a
// branch (81 a (particle, cell) at 287 keys, most of the old kernel's
// time).  The box lies in the key's wrapped coordinates (the low 16 bits
// of cell + 2^15 an axis in 2D, 10 of cell + 2^9 in 3D) and an axis'
// offset in it is taken modulo that width, so the index finds a row
// exactly when the search would, wrapped aliases included.  A cell whose
// whole stencil lies inside the box (an inner cell: almost every cell the
// scans see) reads each stencil cell at a fixed delta from its own place,
// one load a probe, unrolled for the standard stencils; any other cell
// checks each probe against the box.  The probes give a mask of hits,
// and a loop over its set bits, in stencil order, does the arithmetic of
// the hits alone, so that lanes whose particles hit at different offsets
// share the passes.  A map whose box is larger (a sparse city-scale map)
// has no index, and the kernel searches its keys as before: the map alone
// chooses the path.
//
// Design: a block of kWarps warps works on one filter (blockIdx.y).  The
// block compacts the filter's live slots, in slot order, into a shared
// list (a ballot a warp, the warps' counts in shared memory); stages the
// index, the map's rows (and, without an index, its keys) in shared
// memory when they fit (else the rows are read through L2), and the
// first cache_cells live cells.  g lanes share a particle: from the
// launch's shape the fewest that fill the card (a 4096 x 4096 fleet takes
// one, a node of 2000 particles 32), lowered in the block to the least
// power of two that covers its live cells.  At g = 1 a thread walks every
// live cell of its particle in slot order, and all lanes of a warp read
// the same cell (a broadcast), so no lane idles for want of a cell; at g
// > 1 each lane adds its cells in slot order and a fixed __shfl_xor_sync
// tree adds the lanes.  No float atomics, so a run repeats bit for bit.
// One launch over the whole particle axis: the kernel has no
// intermediates to bound, so no chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxOffsets = 32;
constexpr int kTargetBlocks = 132 * 4;        // a few blocks on every SM
constexpr long long kTargetThreads = 132 * 1024;  // lanes that keep every SM busy
constexpr int kMaxPasses = 8;                 // passes of a block over its particles
constexpr size_t kMapSmemLimit = 64 * 1024;   // a larger map is read through L2
constexpr size_t kCellCacheBytes = 32 * 1024;
constexpr int kMaxIndexCells = 1 << 15;       // maps/ndt.py:INDEX_MAX_CELLS

struct Params {
  int m, n, c, k, per_block, cache_cells, lanes, index_cells;
  float res, min_lik, d1, coef;
  uint32_t lo[3], size[3];  // the cell index's box (maps/ndt.py:CellIndex)
  // a cell whose box offset u satisfies u - reach < span on every axis has
  // every stencil cell inside the box, at its flat place plus delta[o]
  uint32_t reach[3], span[3];
  int off[kMaxOffsets * 3];
  int delta[kMaxOffsets];
};

// a map row or a cached measurement cell (mean, then covariance) from a
// row of P floats, 8-byte (2D) or 16-byte (3D) aligned
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* dst) {
  if constexpr (D == 2) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float2 v = reinterpret_cast<const float2*>(src)[j];
      dst[2 * j] = v.x;
      dst[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 v = reinterpret_cast<const float4*>(src)[j];
      dst[4 * j] = v.x;
      dst[4 * j + 1] = v.y;
      dst[4 * j + 2] = v.z;
      dst[4 * j + 3] = v.w;
    }
  }
}

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

// d1 * exp(coef * e^T T^-1 e) of a map row (its mean and covariance) for
// the world Gaussian (mw, cw): e = mw - mean, T = cw + covariance
template <int D>
__device__ __forceinline__ float hit_likelihood(const float* __restrict__ rw, const float* mw,
                                                const float* cw, const Params& p) {
  float r[D + D * D], e[D], tt[D * D];
  load_row<D>(rw, r);
#pragma unroll
  for (int a = 0; a < D; ++a) e[a] = __fsub_rn(mw[a], r[a]);
#pragma unroll
  for (int a = 0; a < D * D; ++a) tt[a] = __fadd_rn(cw[a], r[D + a]);
  return __fmul_rn(p.d1, expf(__fmul_rn(p.coef, quad_form<D>(tt, e))));
}

// The flat place in the index of the cell at stencil offset off from the
// cell at box offsets u, or -1 outside the box: each axis taken modulo the
// key's width, so that it is found exactly when its key is.
template <int D, uint32_t kAxisMask>
__device__ __forceinline__ int box_probe(const uint32_t* u, const int* off, const Params& p) {
  bool inside = true;
  uint32_t at = 0;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const uint32_t v = (u[a] + static_cast<uint32_t>(off[a])) & kAxisMask;
    inside = inside && v < p.size[a];
    at = at * p.size[a] + v;
  }
  return inside ? static_cast<int>(at) : -1;
}

// The filter's live slots, in slot order, into s_live; returns their
// count.  Every thread of the block takes part: each loads the mask bytes
// of up to 32 slots at once, then a ballot a warp and the warps' counts in
// s_warp place them.
__device__ __forceinline__ int compact_live(const uint8_t* __restrict__ mask, int c,
                                            uint16_t* s_live, int* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int count = 0;
  for (int base = 0; base < c; base += 32 * kThreads) {
    uint32_t bits = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int s = base + j * kThreads + threadIdx.x;
      if (s < c && mask[s] != 0) bits |= 1u << j;
    }
    const int chunks = min(32, (c - base + kThreads - 1) / kThreads);
    for (int j = 0; j < chunks; ++j) {
      const bool live = (bits >> j) & 1u;
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, live);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int before = count;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cw = s_warp[w];
        before += w < warp ? cw : 0;
        count += cw;
      }
      if (live) {
        s_live[before + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<uint16_t>(base + j * kThreads + threadIdx.x);
      }
      __syncthreads();  // s_warp is rewritten by the next chunk
    }
  }
  return count;
}

// kK: the stencil's size where it is the standard one of its dimension (9
// in 2D, 7 in 3D), so that the probes of an inner cell unroll; 0 for any
template <int D, bool kSharedMap, bool kIndexed, int kK>
__global__ void __launch_bounds__(kThreads)
    ndt_weights_kernel(const uint32_t* __restrict__ keys, const int16_t* __restrict__ index,
                       const float* __restrict__ values, const float* __restrict__ rot,
                       const float* __restrict__ trans, const float* __restrict__ means,
                       const float* __restrict__ covs, const uint8_t* __restrict__ cell_mask,
                       const Params p, float* __restrict__ out) {
  constexpr int P = D + D * D;  // a map row and a measurement cell: mean, covariance
  constexpr uint32_t kAxisMask = D == 2 ? 0xFFFFu : 1023u;
  constexpr uint32_t kBias = D == 2 ? 32768u : 512u;
  extern __shared__ __align__(16) unsigned char smem[];
  // [index_cells] int16 when kIndexed (a multiple of 8), then the rows
  // [m][P] when kSharedMap, the cached cells [cache_cells][P], the sorted
  // keys [m] when kSharedMap and not kIndexed, the live slots [c]
  int16_t* s_index = reinterpret_cast<int16_t*>(smem);
  float* s_vals = reinterpret_cast<float*>(s_index + (kIndexed ? p.index_cells : 0));
  float* s_cells = s_vals + (kSharedMap ? p.m * P : 0);
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_cells + p.cache_cells * P);
  uint16_t* s_live = reinterpret_cast<uint16_t*>(s_keys + (kSharedMap && !kIndexed ? p.m : 0));
  __shared__ int s_off[kMaxOffsets * 3];
  __shared__ int s_delta[kMaxOffsets];
  __shared__ int s_warp[kWarps];

  const int f = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = threadIdx.x; j < p.k * D; j += blockDim.x) s_off[j] = p.off[j];
  for (int j = threadIdx.x; j < p.k; j += blockDim.x) s_delta[j] = p.delta[j];
  if constexpr (kIndexed) {
    const int4* src = reinterpret_cast<const int4*>(index);
    int4* dst = reinterpret_cast<int4*>(s_index);
    for (int j = threadIdx.x; j < p.index_cells / 8; j += blockDim.x) dst[j] = src[j];
  }
  if constexpr (kSharedMap) {
    if constexpr (!kIndexed) {
      for (int j = threadIdx.x; j < p.m; j += blockDim.x) s_keys[j] = keys[j];
    }
    for (int j = threadIdx.x; j < p.m * P; j += blockDim.x) s_vals[j] = values[j];
  }
  const int live = compact_live(cell_mask + static_cast<size_t>(f) * p.c, p.c, s_live, s_warp);
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
  int dl[kK > 0 ? kK : 1];  // the stencil's deltas, in registers where it unrolls
#pragma unroll
  for (int o = 0; o < kK; ++o) dl[o] = s_delta[o];
  int g = p.lanes;  // lanes a particle: no more than the live cells need
  while (g > 1 && (g >> 1) >= live) g >>= 1;
  const int sub = lane / g, lane_in = lane - sub * g, held = 32 / g;
  const int first = blockIdx.x * p.per_block;
  const int end = min(first + p.per_block, p.n);
  for (int base = first + warp * held; base < end; base += kWarps * held) {
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
          float c[P];
          load_row<D>(s_cells + j * P, c);
#pragma unroll
          for (int e = 0; e < D; ++e) mu[e] = c[e];
#pragma unroll
          for (int e = 0; e < D * D; ++e) sg[e] = c[D + e];
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
        if constexpr (kIndexed) {
          // the cell's offsets in the box; inner: all its stencil cells inside
          uint32_t u[D];
          bool inner = true;
          uint32_t at = 0;
#pragma unroll
          for (int a = 0; a < D; ++a) {
            u[a] = (static_cast<uint32_t>(cell[a]) + kBias - p.lo[a]) & kAxisMask;
            inner = inner && u[a] - p.reach[a] < p.span[a];
            at = at * p.size[a] + u[a];
          }
          // bit o: stencil cell o holds a live row (one load each)
          uint32_t hits = 0;
          if (inner) {
            if constexpr (kK > 0) {
#pragma unroll
              for (int o = 0; o < kK; ++o) {
                hits |= static_cast<uint32_t>(s_index[at + dl[o]] >= 0) << o;
              }
            } else {
              for (int o = 0; o < p.k; ++o) {
                hits |= static_cast<uint32_t>(s_index[at + s_delta[o]] >= 0) << o;
              }
            }
          } else {
            for (int o = 0; o < p.k; ++o) {
              const int probe = box_probe<D, kAxisMask>(u, s_off + o * D, p);
              hits |= static_cast<uint32_t>(probe >= 0 && s_index[probe] >= 0) << o;
            }
          }
          while (hits != 0u) {  // the hits in stencil order
            const int o = __ffs(hits) - 1;
            hits &= hits - 1u;
            const int row =
                s_index[inner ? at + s_delta[o] : box_probe<D, kAxisMask>(u, s_off + o * D, p)];
            sum += hit_likelihood<D>(v_tab + static_cast<size_t>(row) * P, mw, cw, p);
          }
        } else {
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
            sum += hit_likelihood<D>(v_tab + static_cast<size_t>(lo) * P, mw, cw, p);
          }
        }
        acc += sum < p.min_lik ? p.min_lik : sum;  // a NaN stays NaN, as in clamp_min
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (i < end && lane_in == 0) out[static_cast<size_t>(f) * p.n + i] = 1.0f + acc;
  }
}

template <int D, bool kSharedMap, bool kIndexed, int kK>
int launch(const void* keys, const void* index, const void* values, const void* rot,
           const void* trans, const void* means, const void* covs, const void* mask,
           int filters, const Params& p, size_t smem, void* out, cudaStream_t stream) {
  const auto kernel = ndt_weights_kernel<D, kSharedMap, kIndexed, kK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.n + p.per_block - 1) / p.per_block, filters);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int16_t*>(index),
      static_cast<const float*>(values), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(means),
      static_cast<const float*>(covs), static_cast<const uint8_t*>(mask), p,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kSharedMap>
int launch_map(const void* keys, const void* index, const void* values, const void* rot,
               const void* trans, const void* means, const void* covs, const void* mask,
               int filters, const Params& p, size_t smem, void* out, cudaStream_t s) {
  constexpr int kStandard = D == 2 ? 9 : 7;  // models/sensor/ndt.py:KERNEL_2D, KERNEL_3D
  if (index == nullptr) {
    return launch<D, kSharedMap, false, 0>(keys, index, values, rot, trans, means, covs, mask,
                                           filters, p, smem, out, s);
  }
  if (p.k == kStandard) {
    return launch<D, kSharedMap, true, kStandard>(keys, index, values, rot, trans, means, covs,
                                                  mask, filters, p, smem, out, s);
  }
  return launch<D, kSharedMap, true, 0>(keys, index, values, rot, trans, means, covs, mask,
                                        filters, p, smem, out, s);
}

template <int D>
int launch_dim(bool shared_map, const void* keys, const void* index, const void* values,
               const void* rot, const void* trans, const void* means, const void* covs,
               const void* mask, int filters, const Params& p, size_t smem, void* out,
               cudaStream_t s) {
  return shared_map ? launch_map<D, true>(keys, index, values, rot, trans, means, covs, mask,
                                          filters, p, smem, out, s)
                    : launch_map<D, false>(keys, index, values, rot, trans, means, covs, mask,
                                           filters, p, smem, out, s);
}

}  // namespace

// The weights of `filters` filters of n particles: keys uint32 [>= m]
// sorted (m live), values float32 [>= m][D + D*D]; index int16
// [index_cells] 16-byte aligned, index_cells a multiple of 8, the map's
// cell index over the box lo[d], size[d] (box: 2d host values), or null
// to search the keys; rot float32 [filters, n, D, D], trans float32
// [filters, n, D]; means float32 [filters, c, D], covs float32 [filters,
// c, D, D], mask uint8 [filters, c]; offsets int [k][D] on the host (k <=
// 32); coef = -d2 / 2.  Writes out float32 [filters, n].  Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for inputs
// the kernel does not take.
extern "C" int beluga_ndt_weights(const void* keys, int m, const void* index, int index_cells,
                                  const unsigned* box, const void* values, const void* rot,
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
  const bool indexed = index != nullptr;
  p.index_cells = indexed ? index_cells : 0;
  for (int a = 0; a < 3; ++a) {
    p.lo[a] = indexed && a < d ? box[a] : 0;
    p.size[a] = indexed && a < d ? box[d + a] : 0;
  }
  for (int j = 0; j < kMaxOffsets; ++j) p.delta[j] = 0;
  for (int a = 0; a < 3; ++a) p.reach[a] = p.span[a] = 0;  // no cell is inner
  if (indexed) {
    long long cells = 1;
    for (int a = 0; a < d; ++a) cells *= p.size[a];
    if (index_cells % 8 != 0 || index_cells > kMaxIndexCells || cells > index_cells ||
        reinterpret_cast<uintptr_t>(index) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the stencil's reach below and above the cell on each axis; where it
    // fits the box, an inner cell's stencil cells lie at fixed deltas
    long long reach_lo[3] = {0, 0, 0}, reach_hi[3] = {0, 0, 0};
    for (int o = 0; o < k; ++o) {
      for (int a = 0; a < d; ++a) {
        const long long v = offsets[o * d + a];
        reach_lo[a] = v < -reach_lo[a] ? -v : reach_lo[a];
        reach_hi[a] = v > reach_hi[a] ? v : reach_hi[a];
      }
    }
    bool fits = true;
    for (int a = 0; a < d; ++a) fits = fits && reach_lo[a] + reach_hi[a] < p.size[a];
    if (fits) {
      for (int a = 0; a < d; ++a) {
        p.reach[a] = static_cast<uint32_t>(reach_lo[a]);
        p.span[a] = static_cast<uint32_t>(p.size[a] - reach_lo[a] - reach_hi[a]);
      }
      for (int o = 0; o < k; ++o) {
        long long delta = 0;
        for (int a = 0; a < d; ++a) delta = delta * p.size[a] + offsets[o * d + a];
        p.delta[o] = static_cast<int>(delta);
      }
    }
  }
  // lanes a particle from the launch's shape: the fewest that keep every SM
  // busy (a fleet takes one, a node of 2000 several); the block lowers it
  // to what its live cells need
  const long long total = static_cast<long long>(filters) * n;
  p.lanes = 1;
  while (p.lanes < 32 && total * p.lanes < kTargetThreads) p.lanes *= 2;
  const int held = kWarps * (32 / p.lanes);  // particles a block holds at once
  int passes = 1;
  while (passes < kMaxPasses && total / (2LL * held * passes) >= kTargetBlocks) passes *= 2;
  p.per_block = held * passes;
  const size_t row = sizeof(float) * (d + d * d);
  p.cache_cells = static_cast<int>(kCellCacheBytes / row);
  if (p.cache_cells > c) p.cache_cells = c;
  const size_t key_bytes = indexed ? 0 : sizeof(uint32_t) * static_cast<size_t>(m);
  const size_t map_bytes = row * static_cast<size_t>(m) + key_bytes;
  const bool shared_map = map_bytes <= kMapSmemLimit;
  const size_t smem = sizeof(int16_t) * p.index_cells + (shared_map ? map_bytes : 0) +
                      row * p.cache_cells + sizeof(uint16_t) * static_cast<size_t>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 2) {
    return launch_dim<2>(shared_map, keys, index, values, rot, trans, means, covs, mask, filters,
                         p, smem, out, s);
  }
  return launch_dim<3>(shared_map, keys, index, values, rot, trans, means, covs, mask, filters, p,
                       smem, out, s);
}

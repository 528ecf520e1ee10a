// Kernels B6 and B5: the windowed pose-LUT lookup, alone (B6) and fused with
// the differential-drive motion sample (B5).
//
// B6 replaces beluga_tpu/ops/pallas_winlut.py:winlut_lookup, for bf16 and
// int8 tables.  Per particle p with fractional window coordinates
// (xi, yi, t):
//
//   val_p = sum_x tx(x) * sum_j wt(j) * sum_y ty(y) * L[t_lo + j, x, y]
//   out_p = valid_p ? base + val_p : miss
//
// An int8 table (B6-int8) takes the reference's int8 path
// (pallas_winlut.py:109-142) exactly: the y tent is quantized to the integer
// q(y) = round_half_even(ty(y) * 127), each slab's y sum is the int32 dot
// sum_y L[j, x, y] * q(y), exact, then acc(x) = sum_j wt(j) * f32(dot),
// acc(x) * (scale * f32(1/127)), and last the x tent.  scale is a device
// float (the per-build quantization step).
//
// every tent weight is max(1 - |c - i|, 0), and only i = floor(c) and
// floor(c) + 1 can be non-zero, so each valid particle reads eight table
// entries.  Slots come in tiles of `tile`; a tile's theta slab starts at
// t_lo = clip(floor(min of its t in [0, K)), 0, K - tblk), and a particle is
// valid when 0 <= xi <= Wx-1, 0 <= yi <= Wy-1 and 0 <= floor(t) - t_lo <=
// tblk - 2.  Slots past n are padding (t = -1) and never enter the minimum.
//
// B6 has two more entries, which take the SE2 states and compute their
// window coordinates in the kernel (the chain of _coords in
// models/sensor/likelihood_field_winlut.py: world_to_field @ state in
// lie.py's order, the cell offsets, atan2, jnp.mod, the bin), with the
// divisions of the plain version as IEEE divisions, so that their cells
// and miss sets are the plain version's bit for bit: the states entry is
// the windowed lookup (windowed_scan_lut_weights) in one launch, the
// window's origin read from the LUT's device scalars; the coverage entry is
// the windowed filter's gate (windowed_coverage_tiled_from_center) in one
// launch: the origin about the cloud's centre (window_geometry's floor,
// clamp and heading quantisation, once a block), the coordinates and slab
// rule, the slots that B6 would score counted by ballot and one atomic a
// block, count * f32(1/n) written by the last block; for a fleet of
// filters (the winlut fleet's gate, one window for all), one counter and
// one share a filter, still one launch.  Both read 16 B a
// particle and keep each slot's coordinates in registers across the slab
// minimum.
//
// B5 replaces beluga_tpu/ops/pallas_fused_step.py:fused_propagate_winlut
// (kernel_prng=False).  Per particle it samples rot1/trans/rot2 from the
// normals z[3, N] and the per-update (mean, sd) pairs, moves the pose
// (th1 = th + rot1, x' = x + trans cos th1, y' = y + trans sin th1,
// th2 = th1 + rot2), maps it to window coordinates by the field-frame
// affine and t = (jnp.mod(th2 + T_ANG + pi, 2 pi) - pi) * inv_dth + t_bias,
// takes B6's slab and lookup, and writes (x', y', cos th2, sin th2,
// log(max(w, 1e-30))).  Its 18 scalars are a device array read here, since
// the window origin is a device value.  Padded lanes carry 1.0 in every
// input, as in the reference, and take part in the last tile's slab minimum.
//
// Contract: the reference's interpret-mode semantics (float32 tents).  On
// the TPU the y tent was rounded to bf16 before the matrix product
// (pallas_winlut.py:109-112); here every weight stays float32.  The sums
// nest as the reference's do: y innermost, then theta, then x, each written
// with the round-to-nearest intrinsics so that nvcc contracts nothing and
// the plain PyTorch version (same operations, same order) agrees bit for
// bit; the coordinate chain likewise, so that validity at a window edge is
// the plain version's.
//
// What bounds them on an H100: bytes.  B6 reads 12 B and writes 4 B per
// particle, B5 reads 24 B and writes 20 B, and both read the table (160 KB
// at the mega geometry 20x32x128, 2 MB at 64x128x128) once; the ~40 float32
// operations per particle (B5: ~120 with the motion sample) are below the
// byte time.  B6, simple first: one block per tile (min(tile, 1024)
// threads rounded up to whole warps, each walking tile / blockDim slots), a
// block-wide minimum by warp shuffles and shared memory, then eight table
// reads per valid particle straight from global memory (the table stays in
// L2).  A bf16 entry widens to float32 by a 16-bit shift, which is exact.
// The states and coverage entries add the chain (~40 operations with atan2f,
// fmodf and two IEEE divisions) and read 16 B in place of 12; the eight
// reads are 2-byte gathers of the table through L2, four to six 32-byte
// sectors a scored particle.  Staging each tile's box of the table (its slab
// rows x its x range x its y range, up to 24 KB) in shared memory before the
// reads measured 3.4x slower, and re-reading a slot's state after the slab
// minimum in place of keeping its coordinates in registers 12-17% slower
// (PERF.md, section 6).
// B5 crosses global memory once a particle: a persistent grid (as many
// blocks as fit on the card, each walking tiles blockIdx.x, + gridDim.x,
// ...) whose threads keep their kSlots = tile / blockDim slots' window
// coordinates and heading bins in registers across the block minimum and
// write each output once; the table goes into dynamic shared memory once
// per block when it fits (the mega's 160 KB, copied by cp.async during the
// first tile's motion sample; a larger one, such as B6's 2 MB, is read
// through L2 by the same kernel); the inputs of the block's next tile are
// loaded after the slab minimum, in flight during the lookups; sin and cos
// of a heading come from one sincosf.  On an H100 it stays ~1.7x its byte
// bound: a 1024-thread block an SM (64 registers) runs its phases in step,
// and the random table reads conflict in shared memory's banks (PERF.md,
// section 6).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kPi = 3.14159265358979f;     // float32(pi), as jnp.pi enters f32 math
constexpr float k2Pi = 6.28318530717959f;    // float32(2 pi)

// scalar layout of B5 (ops/pallas_fused_step.py:50-52)
enum {
  kR1Mu, kR1Sd, kTMu, kTSd, kR2Mu, kR2Sd, kWfC, kWfS, kWfX, kWfY,
  kInvRes, kOffX, kOffY, kTAng, kInvDth, kTBias, kMiss, kBase, kNumScalars
};

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ float tent(float c, float i) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, i))), 0.0f);
}

// The minimum of v over the block, returned to every thread; `warp_min`
// is kMaxThreads / 32 floats of shared memory, not read again until after
// the block's next barrier.
__device__ float block_min(float v, float* warp_min) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  const int warps = (blockDim.x + 31) >> 5;
  v = lane < warps ? warp_min[lane] : CUDART_INF_F;
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// A t value that can base a slab: inside [0, K); +inf otherwise.
__device__ __forceinline__ float slab_candidate(float t, int k) {
  return (t >= 0.0f && t < static_cast<float>(k)) ? t : CUDART_INF_F;
}

// t_lo = clip(floor(tile min), 0, K - tblk), as float.
__device__ __forceinline__ float slab_base(float tmin, int k, int tblk) {
  return fminf(fmaxf(floorf(tmin), 0.0f), static_cast<float>(k - tblk));
}

// Whether the kernel scores a slot: inside the window and inside its tile's
// slab (k0rel = floor(t) - t_lo), the plain versions' rule.
__device__ __forceinline__ bool in_slab(float xf, float yf, float k0rel, int wx, int wy,
                                        int tblk) {
  return xf >= 0.0f && xf <= static_cast<float>(wx - 1) && yf >= 0.0f &&
         yf <= static_cast<float>(wy - 1) && k0rel >= 0.0f &&
         k0rel <= static_cast<float>(tblk - 2);
}

// jnp.mod(a, 2 pi) in float32: fmod, plus the divisor where the remainder
// is negative (fmod keeps the dividend's sign)
__device__ __forceinline__ float wrap_2pi(float a) {
  const float r = fmodf(a, k2Pi);
  return r < 0.0f ? __fadd_rn(r, k2Pi) : r;
}

// One bf16 table entry as float32, from shared memory (kShared) or through
// the read-only path.
template <bool kShared>
__device__ __forceinline__ float table_at(const uint16_t* p) {
  return bf16_to_float(kShared ? *p : __ldg(p));
}

// base + trilinear lookup, or miss outside the window or the tile's slab
// (bf16 table; `inv_step` is unused).
template <bool kShared = false>
__device__ float trilinear(const uint16_t* __restrict__ vals, int wx, int wy, int tblk,
                           float t_lo, float xf, float yf, float t, float miss, float base,
                           float /*inv_step*/ = 0.0f) {
  const float k0rel = __fsub_rn(floorf(t), t_lo);
  if (!in_slab(xf, yf, k0rel, wx, wy, tblk)) return miss;
  const float u = __fsub_rn(t, t_lo);
  const float x0f = floorf(xf), y0f = floorf(yf);
  const int ix = static_cast<int>(x0f), iy = static_cast<int>(y0f);
  const int jt = static_cast<int>(t_lo) + static_cast<int>(k0rel);
  // the upper neighbour past the last row has weight 0: read the last row
  const int ix1 = min(ix + 1, wx - 1), iy1 = min(iy + 1, wy - 1);
  const float tx0 = tent(xf, x0f), tx1 = tent(xf, x0f + 1.0f);
  const float ty0 = tent(yf, y0f), ty1 = tent(yf, y0f + 1.0f);
  const float tt0 = tent(u, k0rel), tt1 = tent(u, k0rel + 1.0f);
  float byx[2];
  for (int dx = 0; dx < 2; ++dx) {
    const int x = dx ? ix1 : ix;
    float byj[2];
    for (int dj = 0; dj < 2; ++dj) {
      const uint16_t* row = vals + (static_cast<size_t>(jt + dj) * wx + x) * wy;
      byj[dj] = __fadd_rn(__fmul_rn(ty0, table_at<kShared>(row + iy)),
                          __fmul_rn(ty1, table_at<kShared>(row + iy1)));
    }
    byx[dx] = __fadd_rn(__fmul_rn(tt0, byj[0]), __fmul_rn(tt1, byj[1]));
  }
  return __fadd_rn(base, __fadd_rn(__fmul_rn(tx0, byx[0]), __fmul_rn(tx1, byx[1])));
}

// The same lookup from an int8 table: integer y dots with the quantized y
// tent, `step` = scale * f32(1/127) applied to each x row's theta sum.
__device__ float trilinear(const int8_t* __restrict__ vals, int wx, int wy, int tblk,
                           float t_lo, float xf, float yf, float t, float miss, float base,
                           float step) {
  const float k0rel = __fsub_rn(floorf(t), t_lo);
  if (!in_slab(xf, yf, k0rel, wx, wy, tblk)) return miss;
  const float u = __fsub_rn(t, t_lo);
  const float x0f = floorf(xf), y0f = floorf(yf);
  const int ix = static_cast<int>(x0f), iy = static_cast<int>(y0f);
  const int jt = static_cast<int>(t_lo) + static_cast<int>(k0rel);
  const int ix1 = min(ix + 1, wx - 1), iy1 = min(iy + 1, wy - 1);
  const float tx0 = tent(xf, x0f), tx1 = tent(xf, x0f + 1.0f);
  const int q0 = __float2int_rn(__fmul_rn(tent(yf, y0f), 127.0f));
  const int q1 = __float2int_rn(__fmul_rn(tent(yf, y0f + 1.0f), 127.0f));
  const float tt0 = tent(u, k0rel), tt1 = tent(u, k0rel + 1.0f);
  float byx[2];
  for (int dx = 0; dx < 2; ++dx) {
    const int x = dx ? ix1 : ix;
    float byj[2];
    for (int dj = 0; dj < 2; ++dj) {
      const int8_t* row = vals + (static_cast<size_t>(jt + dj) * wx + x) * wy;
      byj[dj] = static_cast<float>(static_cast<int>(__ldg(row + iy)) * q0 +
                                   static_cast<int>(__ldg(row + iy1)) * q1);
    }
    byx[dx] = __fmul_rn(__fadd_rn(__fmul_rn(tt0, byj[0]), __fmul_rn(tt1, byj[1])), step);
  }
  return __fadd_rn(base, __fadd_rn(__fmul_rn(tx0, byx[0]), __fmul_rn(tx1, byx[1])));
}

template <typename T>
__global__ void winlut_kernel(const T* __restrict__ vals, int k, int wx, int wy,
                              int tblk, const float* __restrict__ xi,
                              const float* __restrict__ yi, const float* __restrict__ t,
                              int n, int tile, const float* __restrict__ miss_ptr, float base,
                              const float* __restrict__ scale_ptr, float inv127,
                              float* __restrict__ out) {
  __shared__ float warp_min[kMaxThreads / 32];
  const size_t first = static_cast<size_t>(blockIdx.x) * tile;
  float tmin = CUDART_INF_F;
  for (int s = threadIdx.x; s < tile; s += blockDim.x) {
    const size_t i = first + s;
    if (i < static_cast<size_t>(n)) tmin = fminf(tmin, slab_candidate(t[i], k));
  }
  const float t_lo = slab_base(block_min(tmin, warp_min), k, tblk);
  const float miss = *miss_ptr;
  const float step = scale_ptr ? __fmul_rn(*scale_ptr, inv127) : 0.0f;
  for (int s = threadIdx.x; s < tile; s += blockDim.x) {
    const size_t i = first + s;
    if (i >= static_cast<size_t>(n)) break;
    out[i] = trilinear(vals, wx, wy, tblk, t_lo, xi[i], yi[i], t[i], miss, base, step);
  }
}

struct Moved {
  float x, y, c, s, t;
};

// The motion sample and the fractional heading bin of one particle.
__device__ __forceinline__ Moved propagate(const float* sc, float x, float y, float th,
                                           float z0, float z1, float z2) {
  const float rot1 = __fadd_rn(sc[kR1Mu], __fmul_rn(sc[kR1Sd], z0));
  const float trans = __fadd_rn(sc[kTMu], __fmul_rn(sc[kTSd], z1));
  const float rot2 = __fadd_rn(sc[kR2Mu], __fmul_rn(sc[kR2Sd], z2));
  const float th1 = __fadd_rn(th, rot1);
  const float th2 = __fadd_rn(th1, rot2);
  Moved m;
  float s1, c1;
  sincosf(th1, &s1, &c1);
  m.x = __fadd_rn(x, __fmul_rn(trans, c1));
  m.y = __fadd_rn(y, __fmul_rn(trans, s1));
  sincosf(th2, &m.s, &m.c);
  const float r = wrap_2pi(__fadd_rn(__fadd_rn(th2, sc[kTAng]), kPi));
  m.t = __fadd_rn(__fmul_rn(__fsub_rn(r, kPi), sc[kInvDth]), sc[kTBias]);
  return m;
}

// Field-frame affine to fractional window cells.
__device__ __forceinline__ void window_xy(const float* sc, float x, float y, float* xf,
                                          float* yf) {
  const float fx = __fadd_rn(__fsub_rn(__fmul_rn(sc[kWfC], x), __fmul_rn(sc[kWfS], y)), sc[kWfX]);
  const float fy = __fadd_rn(__fadd_rn(__fmul_rn(sc[kWfS], x), __fmul_rn(sc[kWfC], y)), sc[kWfY]);
  *xf = __fadd_rn(__fmul_rn(fx, sc[kInvRes]), sc[kOffX]);
  *yf = __fadd_rn(__fmul_rn(fy, sc[kInvRes]), sc[kOffY]);
}

// The inputs of slot j of tile `tile_id` of this thread: x, y, theta and
// the three normals; padded lanes (past n) read 1.0, as the reference pads.
template <int kSlots>
__device__ __forceinline__ void load_slot(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          const float* __restrict__ th,
                                          const float* __restrict__ z, int n, int tile,
                                          int tile_id, int j, float (&in)[6][kSlots]) {
  const int s = j * blockDim.x + threadIdx.x;
  const size_t i = static_cast<size_t>(tile_id) * tile + s;
  const bool live = s < tile && i < static_cast<size_t>(n);
  in[0][j] = live ? __ldg(x + i) : 1.0f;
  in[1][j] = live ? __ldg(y + i) : 1.0f;
  in[2][j] = live ? __ldg(th + i) : 1.0f;
  in[3][j] = live ? __ldg(z + i) : 1.0f;
  in[4][j] = live ? __ldg(z + n + i) : 1.0f;
  in[5][j] = live ? __ldg(z + 2 * static_cast<size_t>(n) + i) : 1.0f;
}

// Starts copying the table into shared memory without staging it in
// registers (cp.async, 16 bytes a thread a step, or 2 where `vals` is not
// 16-byte aligned); cp_async_wait() before reading it.
__device__ __forceinline__ void copy_table_async(uint16_t* dst, const uint16_t* vals,
                                                 int entries) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(vals) & 15) == 0) {
    for (int v = threadIdx.x; v < entries / 8; v += blockDim.x) {
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + 8 * v));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(vals + 8 * v));
    }
    done = entries / 8 * 8;
  }
  for (int e = done + threadIdx.x; e < entries; e += blockDim.x) dst[e] = __ldg(vals + e);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// B5: a persistent block walks tiles blockIdx.x, + gridDim.x, ...; each of
// its threads holds kSlots slots of a tile (slot j * blockDim + threadIdx).
template <int kSlots, bool kSharedTable>
__global__ void __launch_bounds__(kMaxThreads, 1) fused_step_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ th,
    const float* __restrict__ z, int n, const uint16_t* __restrict__ vals, int k, int wx,
    int wy, int tblk, int tile, int tiles, const float* __restrict__ scalars,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ co,
    float* __restrict__ so, float* __restrict__ lw) {
  extern __shared__ uint4 table_smem[];
  __shared__ float sc[kNumScalars];
  __shared__ float warp_min[2][kMaxThreads / 32];  // by the tile's parity
  int tile_id = blockIdx.x;
  float in[6][kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) load_slot<kSlots>(x, y, th, z, n, tile, tile_id, j, in);
  const uint16_t* table = vals;
  if (kSharedTable) {  // in flight during the first tile's motion sample
    table = reinterpret_cast<const uint16_t*>(table_smem);
    copy_table_async(reinterpret_cast<uint16_t*>(table_smem), vals, k * wx * wy);
  }
  if (threadIdx.x < kNumScalars) sc[threadIdx.x] = scalars[threadIdx.x];
  __syncthreads();
  for (int parity = 0; tile_id < tiles; tile_id += gridDim.x, parity ^= 1) {
    const size_t first = static_cast<size_t>(tile_id) * tile;
    const int next = tile_id + gridDim.x;
    float xf[kSlots], yf[kSlots], tf[kSlots];
    float tmin = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = j * blockDim.x + threadIdx.x;
      const size_t i = first + s;
      // padded lanes carry 1.0 everywhere and take part in the minimum
      const Moved m = propagate(sc, in[0][j], in[1][j], in[2][j], in[3][j], in[4][j], in[5][j]);
      if (s < tile) tmin = fminf(tmin, slab_candidate(m.t, k));
      if (s < tile && i < static_cast<size_t>(n)) {
        xo[i] = m.x;
        yo[i] = m.y;
        co[i] = m.c;
        so[i] = m.s;
      }
      window_xy(sc, m.x, m.y, &xf[j], &yf[j]);
      tf[j] = m.t;
    }
    if (kSharedTable) cp_async_wait();  // the table, before the barrier below
    const float t_lo = slab_base(block_min(tmin, warp_min[parity]), k, tblk);
    if (next < tiles) {  // in flight during the lookups
#pragma unroll
      for (int j = 0; j < kSlots; ++j) load_slot<kSlots>(x, y, th, z, n, tile, next, j, in);
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int s = j * blockDim.x + threadIdx.x;
      const size_t i = first + s;
      if (s < tile && i < static_cast<size_t>(n)) {
        const float w = trilinear<kSharedTable>(table, wx, wy, tblk, t_lo, xf[j], yf[j], tf[j],
                                                sc[kMiss], sc[kBase]);
        lw[i] = logf(fmaxf(w, 1e-30f));
      }
    }
  }
}

// whole warps (block_min shuffles over full warps), at most kMaxThreads
int threads_for(int tile) {
  const int warps = (tile + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

// Dynamic shared memory B5 gives a table (of the 227 KB a block may hold,
// less its static arrays); a larger table is read through L2.
constexpr int kMaxTableSmem = 225 * 1024;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  }
  return count;
}

template <int kSlots, bool kSharedTable>
int launch_fused_step(const float* x, const float* y, const float* th, const float* z, int n,
                      const uint16_t* vals, int k, int wx, int wy, int tblk, int tile,
                      const float* scalars, float* xo, float* yo, float* co, float* so,
                      float* lw, cudaStream_t stream) {
  auto kernel = fused_step_kernel<kSlots, kSharedTable>;
  const int threads = threads_for(tile);
  const size_t smem = kSharedTable ? static_cast<size_t>(k) * wx * wy * 2 : 0;
  static bool configured = false;  // per instantiation
  if (kSharedTable && !configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxTableSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  static int cached_threads = 0, cached_per_sm = 0;
  static size_t cached_smem = 0;
  if (threads != cached_threads || smem != cached_smem) {
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached_threads = threads;
    cached_smem = smem;
    cached_per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int tiles = (n + tile - 1) / tile;
  const int grid = tiles < sm_count() * cached_per_sm ? tiles : sm_count() * cached_per_sm;
  kernel<<<grid, threads, smem, stream>>>(x, y, th, z, n, vals, k, wx, wy, tblk, tile, tiles,
                                          scalars, xo, yo, co, so, lw);
  return static_cast<int>(cudaGetLastError());
}

// -- B6's states entry and coverage entry -------------------------------------

// The frame of the window coordinates (_coords in
// models/sensor/likelihood_field_winlut.py): world_to_field's (x, y, cos,
// sin), the resolution, the cell offsets f32(pad - x0) and f32(pad - y0),
// the heading of the window's centre (theta0 + f32((K / 2) dth)), the bin
// width and f32(K / 2).
struct Frame {
  float wx, wy, wc, ws, res, offx, offy, center, dth, half;
};

// What both entries take besides their own: the states (xy and rot [n, 2],
// read as float2 where both are 8-byte aligned), world_to_field's xy and
// rot [2] on the device, and the host floats of the frame.
struct StatesIn {
  const float* xy;
  const float* rot;
  int n, tile, paired;
  const float* field_xy;
  const float* field_rot;
  float res, half_span, dth, half;
  int pad;
};

__device__ __forceinline__ float2 load_pair(const float* p, size_t i, int paired) {
  return paired ? __ldg(reinterpret_cast<const float2*>(p) + i)
                : make_float2(__ldg(p + 2 * i), __ldg(p + 2 * i + 1));
}

// Window coordinates of one state: world_to_field @ state in lie.py's
// order, then _coords' chain.  The kernel divides where the plain version
// divides by a device tensor (__fdiv_rn), so its cells, and so its miss
// set, are the plain version's.
__device__ __forceinline__ void window_coords(const Frame& w, float2 xy, float2 rot, float* xi,
                                              float* yi, float* t) {
  const float tx = __fadd_rn(w.wx, __fsub_rn(__fmul_rn(w.wc, xy.x), __fmul_rn(w.ws, xy.y)));
  const float ty = __fadd_rn(w.wy, __fadd_rn(__fmul_rn(w.ws, xy.x), __fmul_rn(w.wc, xy.y)));
  const float c = __fsub_rn(__fmul_rn(w.wc, rot.x), __fmul_rn(w.ws, rot.y));
  const float s = __fadd_rn(__fmul_rn(w.ws, rot.x), __fmul_rn(w.wc, rot.y));
  *xi = __fadd_rn(__fsub_rn(__fdiv_rn(tx, w.res), 0.5f), w.offx);
  *yi = __fadd_rn(__fsub_rn(__fdiv_rn(ty, w.res), 0.5f), w.offy);
  const float rel = __fsub_rn(wrap_2pi(__fadd_rn(__fsub_rn(atan2f(s, c), w.center), kPi)), kPi);
  *t = __fadd_rn(__fdiv_rn(rel, w.dth), w.half);
}

__device__ __forceinline__ Frame frame_of(const StatesIn& in, long long x0, long long y0,
                                          float theta0) {
  Frame w;
  w.wx = __ldg(in.field_xy);
  w.wy = __ldg(in.field_xy + 1);
  w.wc = __ldg(in.field_rot);
  w.ws = __ldg(in.field_rot + 1);
  w.res = in.res;
  w.offx = __ll2float_rn(in.pad - x0);
  w.offy = __ll2float_rn(in.pad - y0);
  w.center = __fadd_rn(theta0, in.half_span);
  w.dth = in.dth;
  w.half = in.half;
  return w;
}

// torch.clamp(v, lo, hi) of an int64: min(max(v, lo), hi)
__device__ __forceinline__ long long clamp_origin(long long v, long long lo, long long hi) {
  v = v > lo ? v : lo;
  return v < hi ? v : hi;
}

// window_geometry's origin for a cloud centre (cx, cy, ct), then the frame:
// world_to_field @ SE2(cx, cy, ct) in lie.py's order, the cell floor(x /
// res) through int32 plus the pad, the origin clamped to [pad, wp - win_x -
// pad] (y likewise), theta0 = (floor(theta / dth) - K / 2) dth.
__device__ Frame centre_frame(const StatesIn& in, const float* centre_x,
                              const float* centre_y, const float* centre_theta, int win_x,
                              int win_y, int wp, int hp) {
  const Frame f = frame_of(in, in.pad, in.pad, 0.0f);  // world_to_field and the floats
  const float cx = __ldg(centre_x), cy = __ldg(centre_y), ct = __ldg(centre_theta);
  const float cc = cosf(ct), cs = sinf(ct);
  const float tx = __fadd_rn(f.wx, __fsub_rn(__fmul_rn(f.wc, cx), __fmul_rn(f.ws, cy)));
  const float ty = __fadd_rn(f.wy, __fadd_rn(__fmul_rn(f.ws, cx), __fmul_rn(f.wc, cy)));
  const float c = __fsub_rn(__fmul_rn(f.wc, cc), __fmul_rn(f.ws, cs));
  const float s = __fadd_rn(__fmul_rn(f.ws, cc), __fmul_rn(f.wc, cs));
  const long long ix = static_cast<long long>(__float2int_rz(floorf(__fdiv_rn(tx, in.res)))) + in.pad;
  const long long iy = static_cast<long long>(__float2int_rz(floorf(__fdiv_rn(ty, in.res)))) + in.pad;
  const long long x0 = clamp_origin(ix - win_x / 2, in.pad, wp - win_x - in.pad);
  const long long y0 = clamp_origin(iy - win_y / 2, in.pad, hp - win_y - in.pad);
  const float theta0 =
      __fmul_rn(__fsub_rn(floorf(__fdiv_rn(atan2f(s, c), in.dth)), in.half), in.dth);
  return frame_of(in, x0, y0, theta0);
}

// Slot j of this thread in the block's tile: live, and its coordinates.
// The tile is blockIdx.x of the n states that start at state `base` (a
// filter's first state in the coverage entry's fleet form; 0 otherwise).
template <int kSlots>
__device__ __forceinline__ float tile_coords(const Frame& w, const StatesIn& in, int k,
                                             size_t base, float (&xf)[kSlots],
                                             float (&yf)[kSlots], float (&tf)[kSlots]) {
  const size_t first = static_cast<size_t>(blockIdx.x) * in.tile;
  float tmin = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = j * blockDim.x + threadIdx.x;
    const size_t i = first + s;
    xf[j] = yf[j] = tf[j] = -1.0f;
    if (s < in.tile && i < static_cast<size_t>(in.n)) {
      window_coords(w, load_pair(in.xy, base + i, in.paired),
                    load_pair(in.rot, base + i, in.paired), &xf[j], &yf[j], &tf[j]);
      tmin = fminf(tmin, slab_candidate(tf[j], k));
    }
  }
  return tmin;
}

template <typename T>
struct LookupArgs {
  StatesIn in;
  const T* vals;
  int k, wx, wy, tblk;
  const long long* x0;
  const long long* y0;
  const float* theta0;
  const float* miss;
  float base;
  const float* scale;
  float inv127;
  float* out;
};

// B6 from the states: each thread keeps its kSlots slots' coordinates in
// registers across the tile's slab minimum, then reads the table through
// L2 (staging a tile's box of the table in shared memory measured slower).
template <typename T, int kSlots>
__global__ void __launch_bounds__(kMaxThreads) winlut_states_kernel(LookupArgs<T> a) {
  __shared__ float warp_min[kMaxThreads / 32];
  const Frame w = frame_of(a.in, __ldg(a.x0), __ldg(a.y0), __ldg(a.theta0));
  float xf[kSlots], yf[kSlots], tf[kSlots];
  const float tmin = tile_coords<kSlots>(w, a.in, a.k, 0, xf, yf, tf);
  const float t_lo = slab_base(block_min(tmin, warp_min), a.k, a.tblk);
  const float miss = __ldg(a.miss);
  const float step = a.scale ? __fmul_rn(__ldg(a.scale), a.inv127) : 0.0f;
  const size_t first = static_cast<size_t>(blockIdx.x) * a.in.tile;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = j * blockDim.x + threadIdx.x;
    const size_t i = first + s;
    if (s < a.in.tile && i < static_cast<size_t>(a.in.n)) {
      a.out[i] = trilinear(a.vals, a.wx, a.wy, a.tblk, t_lo, xf[j], yf[j], tf[j], miss, a.base,
                           step);
    }
  }
}

struct CoverageArgs {
  StatesIn in;
  const float* centre_x;
  const float* centre_y;
  const float* centre_theta;
  int k, wx, wy, tblk, wp, hp;
  float inv_n;
  // [filters + 1]: each filter's count, then the blocks done; zero between
  // calls
  int* scratch;
  float* out;  // [filters]
};

// The kernel-exact coverage: the slots that B6 would score with a window
// built about the centre, counted a warp at a time by ballot, a block's
// count added by one atomic to its filter's counter (blockIdx.y is the
// filter, blockIdx.x the tile within it, so that no tile straddles two
// filters); the last block to finish writes each filter's count * inv_n
// and sets the scratch back to zero.  One filter is the grid of one row.
template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads) winlut_coverage_kernel(CoverageArgs a) {
  __shared__ float warp_min[kMaxThreads / 32];
  __shared__ int warp_count[kMaxThreads / 32];
  __shared__ Frame frame;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    frame = centre_frame(a.in, a.centre_x, a.centre_y, a.centre_theta, a.wx, a.wy, a.wp, a.hp);
  }
  __syncthreads();
  const Frame w = frame;
  float xf[kSlots], yf[kSlots], tf[kSlots];
  const size_t base = static_cast<size_t>(blockIdx.y) * a.in.n;
  const float tmin = tile_coords<kSlots>(w, a.in, a.k, base, xf, yf, tf);
  const float t_lo = slab_base(block_min(tmin, warp_min), a.k, a.tblk);
  const size_t first = static_cast<size_t>(blockIdx.x) * a.in.tile;
  int count = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = j * blockDim.x + threadIdx.x;
    const bool live = s < a.in.tile && first + s < static_cast<size_t>(a.in.n);
    const bool ok = live && in_slab(xf[j], yf[j], __fsub_rn(floorf(tf[j]), t_lo), a.wx, a.wy,
                                    a.tblk);
    count += __popc(__ballot_sync(0xffffffffu, ok));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int v = 0; v < static_cast<int>((blockDim.x + 31) >> 5); ++v) total += warp_count[v];
    atomicAdd(a.scratch + blockIdx.y, total);
    __threadfence();
    last = atomicAdd(a.scratch + gridDim.y, 1) ==
           static_cast<int>(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (last) {
    for (int f = threadIdx.x; f < static_cast<int>(gridDim.y); f += blockDim.x) {
      const int all = atomicExch(a.scratch + f, 0);
      a.out[f] = __fmul_rn(static_cast<float>(all), a.inv_n);
    }
    if (threadIdx.x == 0) atomicExch(a.scratch + gridDim.y, 0);
  }
}

// Slots a thread for a tile: 1, 2, 4 or 8 (a tile of at most 8192); 0 past.
int slots_for(int tile) {
  const int slots = (tile + threads_for(tile) - 1) / threads_for(tile);
  return slots == 1 ? 1 : slots == 2 ? 2 : slots <= 4 ? 4 : slots <= 8 ? 8 : 0;
}

template <typename T>
int launch_states(const LookupArgs<T>& a, cudaStream_t stream) {
  const int blocks = (a.in.n + a.in.tile - 1) / a.in.tile;
  const int threads = threads_for(a.in.tile);
  switch (slots_for(a.in.tile)) {
    case 1: winlut_states_kernel<T, 1><<<blocks, threads, 0, stream>>>(a); break;
    case 2: winlut_states_kernel<T, 2><<<blocks, threads, 0, stream>>>(a); break;
    case 4: winlut_states_kernel<T, 4><<<blocks, threads, 0, stream>>>(a); break;
    case 8: winlut_states_kernel<T, 8><<<blocks, threads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

StatesIn states_in(const void* xy, const void* rot, int n, int tile, const void* field_xy,
                   const void* field_rot, float res, int pad, float half_span, float dth,
                   float half) {
  StatesIn in;
  in.xy = static_cast<const float*>(xy);
  in.rot = static_cast<const float*>(rot);
  in.n = n;
  in.tile = tile;
  in.paired = reinterpret_cast<uintptr_t>(xy) % 8 == 0 && reinterpret_cast<uintptr_t>(rot) % 8 == 0;
  in.field_xy = static_cast<const float*>(field_xy);
  in.field_rot = static_cast<const float*>(field_rot);
  in.res = res;
  in.half_span = half_span;
  in.dth = dth;
  in.half = half;
  in.pad = pad;
  return in;
}

template <typename T>
int winlut_lookup_states(const void* vals, int k, int wx, int wy, int tblk, const void* xy,
                         const void* rot, int n, int tile, const void* field_xy,
                         const void* field_rot, float res, int pad, const void* x0,
                         const void* y0, const void* theta0, float half_span, float dth,
                         float half, const void* miss, float base, const void* scale,
                         float inv127, void* out, void* stream) {
  if (n == 0) return 0;
  LookupArgs<T> a;
  a.in = states_in(xy, rot, n, tile, field_xy, field_rot, res, pad, half_span, dth, half);
  a.vals = static_cast<const T*>(vals);
  a.k = k;
  a.wx = wx;
  a.wy = wy;
  a.tblk = tblk;
  a.x0 = static_cast<const long long*>(x0);
  a.y0 = static_cast<const long long*>(y0);
  a.theta0 = static_cast<const float*>(theta0);
  a.miss = static_cast<const float*>(miss);
  a.base = base;
  a.scale = static_cast<const float*>(scale);
  a.inv127 = inv127;
  a.out = static_cast<float*>(out);
  return launch_states(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// B6 over n particles in tiles of `tile` slots; `vals` is the bf16 table
// [k, wx, wy] as raw bits, `miss` a float on the device.  Returns
// cudaGetLastError() of the launch.
extern "C" int beluga_winlut_lookup(const void* vals, int k, int wx, int wy, int tblk,
                                    const void* xi, const void* yi, const void* t, int n,
                                    int tile, const void* miss, float base, void* out,
                                    void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + tile - 1) / tile;
  winlut_kernel<uint16_t><<<blocks, threads_for(tile), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(vals), k, wx, wy, tblk, static_cast<const float*>(xi),
      static_cast<const float*>(yi), static_cast<const float*>(t), n, tile,
      static_cast<const float*>(miss), base, nullptr, 0.0f, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B6-int8: the same over an int8 table [k, wx, wy]; `scale` a float on the
// device, `inv127` the float32 value of 1/127.
extern "C" int beluga_winlut_lookup_int8(const void* vals, int k, int wx, int wy, int tblk,
                                         const void* xi, const void* yi, const void* t, int n,
                                         int tile, const void* miss, float base,
                                         const void* scale, float inv127, void* out,
                                         void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + tile - 1) / tile;
  winlut_kernel<int8_t><<<blocks, threads_for(tile), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(vals), k, wx, wy, tblk, static_cast<const float*>(xi),
      static_cast<const float*>(yi), static_cast<const float*>(t), n, tile,
      static_cast<const float*>(miss), base, static_cast<const float*>(scale), inv127,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B5 over n particles: z is [3, n]; `scalars` the 18 device floats of
// pack_scalars; outputs x', y', cos', sin', log-likelihood, each [n].
// `tile` at most 8192 (eight slots a thread of 1024).
extern "C" int beluga_fused_step(const void* x, const void* y, const void* th, const void* z,
                                 int n, const void* vals, int k, int wx, int wy, int tblk,
                                 int tile, const void* scalars, void* xo, void* yo, void* co,
                                 void* so, void* lw, void* stream) {
  if (n == 0) return 0;
  const int threads = threads_for(tile);
  const int slots = (tile + threads - 1) / threads;
  if (slots > 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = static_cast<size_t>(k) * wx * wy * 2 <= kMaxTableSmem;
  const auto* args_x = static_cast<const float*>(x);
  const auto* args_y = static_cast<const float*>(y);
  const auto* args_th = static_cast<const float*>(th);
  const auto* args_z = static_cast<const float*>(z);
  const auto* table = static_cast<const uint16_t*>(vals);
  const auto* sc = static_cast<const float*>(scalars);
  auto* o0 = static_cast<float*>(xo);
  auto* o1 = static_cast<float*>(yo);
  auto* o2 = static_cast<float*>(co);
  auto* o3 = static_cast<float*>(so);
  auto* o4 = static_cast<float*>(lw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BELUGA_FUSED_STEP(SLOTS, SHARED)                                                     \
  return launch_fused_step<SLOTS, SHARED>(args_x, args_y, args_th, args_z, n, table, k, wx,  \
                                          wy, tblk, tile, sc, o0, o1, o2, o3, o4, s)
  if (shared) {
    if (slots == 1) BELUGA_FUSED_STEP(1, true);
    if (slots == 2) BELUGA_FUSED_STEP(2, true);
    if (slots <= 4) BELUGA_FUSED_STEP(4, true);
    BELUGA_FUSED_STEP(8, true);
  }
  if (slots == 1) BELUGA_FUSED_STEP(1, false);
  if (slots == 2) BELUGA_FUSED_STEP(2, false);
  if (slots <= 4) BELUGA_FUSED_STEP(4, false);
  BELUGA_FUSED_STEP(8, false);
#undef BELUGA_FUSED_STEP
}

// B6's states entry: the lookup of world_to_field @ states (xy and rot
// [n, 2]) in the window of a LUT whose origin x0, y0 (int64) and theta0
// (float) lie on the device; `half_span` is f32((K / 2) dth) and `half`
// f32(K / 2).  bf16 table (`scale` null) or int8 (`scale` a device float).
// Returns cudaGetLastError() of the launch.
extern "C" int beluga_winlut_lookup_states(
    const void* vals, int int8, int k, int wx, int wy, int tblk, const void* xy,
    const void* rot, int n, int tile, const void* field_xy, const void* field_rot, float res,
    int pad, const void* x0, const void* y0, const void* theta0, float half_span, float dth,
    float half, const void* miss, float base, const void* scale, float inv127, void* out,
    void* stream) {
  if (int8) {
    return winlut_lookup_states<int8_t>(vals, k, wx, wy, tblk, xy, rot, n, tile, field_xy,
                                        field_rot, res, pad, x0, y0, theta0, half_span, dth,
                                        half, miss, base, scale, inv127, out, stream);
  }
  return winlut_lookup_states<uint16_t>(vals, k, wx, wy, tblk, xy, rot, n, tile, field_xy,
                                        field_rot, res, pad, x0, y0, theta0, half_span, dth,
                                        half, miss, base, nullptr, 0.0f, out, stream);
}

// B6's coverage entry: for each of `filters` filters of n states (xy and
// rot [filters, n, 2]), the share that B6 would score in one window of K x
// win_x x win_y built about the centre (three device floats), as count *
// inv_n into out[filter] (device floats).  `scratch` is filters + 1 device
// int32 that are zero before the call and are left zero after it.
extern "C" int beluga_winlut_coverage_states(
    int k, int win_x, int win_y, int tblk, const void* xy, const void* rot, int filters, int n,
    int tile, const void* field_xy, const void* field_rot, float res, int pad, int wp, int hp,
    const void* centre_x, const void* centre_y, const void* centre_theta, float half_span,
    float dth, float half, float inv_n, void* scratch, void* out, void* stream) {
  if (n == 0 || filters == 0) return 0;
  CoverageArgs a;
  a.in = states_in(xy, rot, n, tile, field_xy, field_rot, res, pad, half_span, dth, half);
  a.centre_x = static_cast<const float*>(centre_x);
  a.centre_y = static_cast<const float*>(centre_y);
  a.centre_theta = static_cast<const float*>(centre_theta);
  a.k = k;
  a.wx = win_x;
  a.wy = win_y;
  a.tblk = tblk;
  a.wp = wp;
  a.hp = hp;
  a.inv_n = inv_n;
  a.scratch = static_cast<int*>(scratch);
  a.out = static_cast<float*>(out);
  const dim3 blocks((n + tile - 1) / tile, filters);
  const int threads = threads_for(tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots_for(tile)) {
    case 1: winlut_coverage_kernel<1><<<blocks, threads, 0, s>>>(a); break;
    case 2: winlut_coverage_kernel<2><<<blocks, threads, 0, s>>>(a); break;
    case 4: winlut_coverage_kernel<4><<<blocks, threads, 0, s>>>(a); break;
    case 8: winlut_coverage_kernel<8><<<blocks, threads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel B2: the whole resample_take, from the weights to the donor rows.
//
// Replaces beluga_tpu/ops/pallas_resample.py:resample_take, its CDF build
// (:405-412: cumsum, divide by the total, cummax) and its search and donor
// copy (the pallas_call at :495; its small, blocked, huge and pipelined
// variants are schedules for the TPU's VMEM).  Input, for each of `batch`
// filters: weights f32[N], positions f32[M] and the particle state as
// planes f32[D, N].  Two stages, each callable alone:
//
// 1. The monotone CDF (beluga_cdf): cdf[k] = m[k] / T, where s is a float32
//    inclusive prefix sum of the weights, m[k] = max of s[j] over j <= k
//    with w[j] > 0 (0 before the first live slot) and T = m[N-1] (at least
//    1e-38).  Taking the running maximum over live slots only makes every
//    zero-weight slot's interval empty by construction: m[k] == m[k-1]
//    exactly, whatever order the sum was taken in.  The maximum is exact in
//    any order, and rounding is monotone, so max(s)/T == max(s/T) and
//    fl(o + max l) == max fl(o + l): the maximum can be taken on local
//    prefixes and offset afterwards.  The last live slot's entry is T/T = 1
//    exactly.  The sum is reduce-then-scan over tiles of kTile weights:
//    cdf_partials_kernel writes each tile's sum A and the largest local
//    prefix M of its live slots; cdf_scan_kernel has every block scan all
//    the partials with the same code (so every block derives the same tile
//    offsets O and carries), then scans its tile again and writes the CDF.
//    A filter that fits one tile (the node's 2000, the fleet's 4096) takes
//    one launch, its scan in shared memory.  A thread owns kItems
//    consecutive weights and sums them in order; the threads' totals are
//    scanned by warp shuffles, then across warps.  Every sum is taken in
//    this fixed order, so equal inputs give equal bits on every launch.
//    Without `normalize` the kernel writes m itself, the running sum that
//    the sorted positions (the spacings of ops/resample.py) and the
//    sharded CDF (parallel/collectives.py) divide themselves.
// 2. The search and donor copy (beluga_resample_take): for each position u
//    the donor is the first k with cdf[k] > u (searchsorted side='right'),
//    so a zero-weight slot is never chosen; row q of out f32[M, D] gets a
//    bit-exact copy of the donor's D values; a position at or above
//    cdf[N-1] (the padding value 1.5, or any position when every weight is
//    zero) gets a zero row.  A block takes kChunk positions and brackets
//    their donors with two 32-ary warp searches (its smallest and largest
//    position, ~log32(N) dependent reads each); when the bracket holds at
//    most kWindow CDF entries (sorted positions: systematic, stratified and
//    sorted multinomial) it stages them in shared memory and each thread
//    searches there; otherwise (unsorted positions over a long CDF) each
//    thread searches the bracket in global memory.  Either way the answer
//    is the same first index.
//
// What bounds it on an H100: the bytes.  The whole function must read the
// N weights, the M positions and D*N state values and write M*D values;
// the CDF (4N written, read back by the search) and the partials (8 bytes
// a tile) stay mostly in the 50 MB L2 at N = 2^21.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- stage 1: the monotone CDF ----------------------------------------------

constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kScanThreads * kItems;  // weights a block scans

struct ScanShared {
  float warp_sum[kScanWarps];
  float warp_max[kScanWarps];
  float warp_off[kScanWarps];
  float warp_max_before[kScanWarps];
  float block_sum;
  float block_max;
};

struct Scanned {
  float sum_before;  // exclusive prefix sum of x, in the block's fixed order
  float max_before;  // exclusive prefix maximum of y (0 where empty)
  float sum;         // the block's sum of x
  float max;         // the block's maximum of y
};

// Block-wide exclusive prefix sum of x and prefix maximum of y, in a fixed
// order (Kogge-Stone over each warp's lanes, then over the warps' totals):
// every block computes bit-equal results from equal inputs.  Every thread
// of the block must call it; results are read before the next call.
__device__ Scanned block_scan(float x, float y, ScanShared* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float sx = x, my = y;
  for (int d = 1; d < 32; d <<= 1) {
    const float ox = __shfl_up_sync(kFull, sx, d);
    const float oy = __shfl_up_sync(kFull, my, d);
    if (lane >= d) {
      sx = __fadd_rn(ox, sx);
      my = fmaxf(oy, my);
    }
  }
  float ex = __shfl_up_sync(kFull, sx, 1);
  float ey = __shfl_up_sync(kFull, my, 1);
  if (lane == 0) ex = ey = 0.0f;
  if (lane == 31) {
    sh->warp_sum[warp] = sx;
    sh->warp_max[warp] = my;
  }
  __syncthreads();
  if (warp == 0) {
    float ws = lane < kScanWarps ? sh->warp_sum[lane] : 0.0f;
    float wm = lane < kScanWarps ? sh->warp_max[lane] : 0.0f;
    for (int d = 1; d < 32; d <<= 1) {
      const float os = __shfl_up_sync(kFull, ws, d);
      const float om = __shfl_up_sync(kFull, wm, d);
      if (lane >= d) {
        ws = __fadd_rn(os, ws);
        wm = fmaxf(om, wm);
      }
    }
    float es = __shfl_up_sync(kFull, ws, 1);
    float em = __shfl_up_sync(kFull, wm, 1);
    if (lane == 0) es = em = 0.0f;
    if (lane < kScanWarps) {
      sh->warp_off[lane] = es;
      sh->warp_max_before[lane] = em;
    }
    if (lane == kScanWarps - 1) {
      sh->block_sum = ws;
      sh->block_max = wm;
    }
  }
  __syncthreads();
  return {__fadd_rn(sh->warp_off[warp], ex), fmaxf(sh->warp_max_before[warp], ey),
          sh->block_sum, sh->block_max};
}

// The weights of this thread (0 past `count`): kItems consecutive floats
// from w[at].
__device__ __forceinline__ void load_items(const float* __restrict__ w, int count, int at,
                                           float (&v)[kItems]) {
  if (at + kItems <= count && (reinterpret_cast<uintptr_t>(w + at) & 15) == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(w + at));
    const float4 b = __ldg(reinterpret_cast<const float4*>(w + at + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = at + i < count ? __ldg(w + at + i) : 0.0f;
}

// The tile's local scan, the same code in both kernels: each weight's local
// prefix is l_i = fl(P + r_i), r the thread's running sum, P the thread's
// exclusive offset.  Per thread, `live` is fl(P + r of its last live slot),
// the largest local prefix of its live slots (0 if none), since l grows
// with i; the scan of `live` gives the largest of the threads before it
// and the tile's largest, M.
struct TileScan {
  float p;            // the thread's offset P
  float live_before;  // the largest live local prefix of the threads before
  float sum;          // the tile's sum A
  float live_max;     // the tile's largest live local prefix M
};

__device__ TileScan tile_scan(const float (&v)[kItems], float (&r)[kItems], ScanShared* sh) {
  float last_live = 0.0f;
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = i == 0 ? v[0] : __fadd_rn(run, v[i]);
    r[i] = run;
    if (v[i] > 0.0f) last_live = run;
  }
  // the offsets first; each thread's live maximum needs its offset
  const Scanned sums = block_scan(run, 0.0f, sh);
  const float live = last_live > 0.0f ? __fadd_rn(sums.sum_before, last_live) : 0.0f;
  const Scanned lives = block_scan(0.0f, live, sh);
  return {sums.sum_before, lives.max_before, sums.sum, lives.max};
}

// Pass 1 for N > kTile: per (tile, filter) the tile's sum A and its largest
// live local prefix M, as float2 partials[filter][tile].
__global__ void __launch_bounds__(kScanThreads) cdf_partials_kernel(
    const float* __restrict__ w, int n, int tiles, float2* __restrict__ partials) {
  __shared__ ScanShared sh;
  const size_t f = blockIdx.y;
  const int start = blockIdx.x * kTile;
  float v[kItems], r[kItems];
  load_items(w + f * n + start, n - start, threadIdx.x * kItems, v);
  const TileScan t = tile_scan(v, r, &sh);
  if (threadIdx.x == 0) partials[f * tiles + blockIdx.x] = make_float2(t.sum, t.live_max);
}

struct Carry {
  float offset;  // O_b, this tile's offset
  float before;  // C_b = max over live tiles j < b of fl(O_j + M_j) (0 if none)
  float total;   // T, the same over every live tile
};

// Tile b's offset, carry and the filter's total from the partials.  Every
// block runs this same code on the same partials, so every block derives
// the same O_j: a thread sums a run of `per` partials in order, the runs'
// totals are block-scanned, and each thread walks its run again.
__device__ Carry scan_partials(const float2* __restrict__ partials, int tiles, int b,
                               ScanShared* sh) {
  __shared__ float tile_offset;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int hi = min(tiles, lo + per);
  float sum = 0.0f;
  for (int j = lo; j < hi; ++j) sum = __fadd_rn(sum, __ldg(partials + j).x);
  float off = block_scan(sum, 0.0f, sh).sum_before;
  float before = 0.0f, every = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const float2 p = __ldg(partials + j);
    if (j == b) tile_offset = off;
    if (p.y > 0.0f) {
      const float top = __fadd_rn(off, p.y);
      every = fmaxf(every, top);
      if (j < b) before = fmaxf(before, top);
    }
    off = __fadd_rn(off, p.x);
  }
  const float carry = block_scan(0.0f, before, sh).max;
  const float total = block_scan(0.0f, every, sh).max;  // its syncs publish tile_offset
  return {tile_offset, carry, total};
}

// Pass 2 (the only pass when tiles == 1): the CDF of one tile of one filter.
__global__ void __launch_bounds__(kScanThreads) cdf_scan_kernel(
    const float* __restrict__ w, int n, int tiles, const float2* __restrict__ partials,
    bool normalize, float* __restrict__ cdf) {
  __shared__ ScanShared sh;
  const size_t f = blockIdx.y;
  const int start = blockIdx.x * kTile;
  const int at = threadIdx.x * kItems;
  float v[kItems], r[kItems];
  load_items(w + f * n + start, n - start, at, v);
  Carry c = {0.0f, 0.0f, 0.0f};
  if (tiles > 1) c = scan_partials(partials + f * tiles, tiles, blockIdx.x, &sh);
  const TileScan t = tile_scan(v, r, &sh);
  if (tiles == 1) c.total = t.live_max;
  const float denom = fmaxf(c.total, 1e-38f);
  float run = t.live_before;  // the largest live local prefix so far
  float q[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (v[i] > 0.0f) run = fmaxf(run, __fadd_rn(t.p, r[i]));
    const float m = run > 0.0f ? fmaxf(c.before, __fadd_rn(c.offset, run)) : c.before;
    q[i] = normalize ? __fdiv_rn(m, denom) : m;
  }
  float* out = cdf + f * n + start + at;
  if (at + kItems <= n - start && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    reinterpret_cast<float4*>(out)[0] = make_float4(q[0], q[1], q[2], q[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(q[4], q[5], q[6], q[7]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (at + i < n - start) out[i] = q[i];
  }
}

// -- stage 2: search and donor copy -----------------------------------------

constexpr int kSearchThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kSearchThreads * kPerThread;  // positions a block
constexpr int kWindow = 4096;                        // CDF entries staged

// First k in [lo, hi) with cdf[k] > u, else hi, by the whole warp: each
// round 32 lanes probe 32 evenly spaced entries and keep the span between
// the last probe at or below u and the first above it.
__device__ int warp_search(const float* __restrict__ cdf, int lo, int hi, float u) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int probe = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned above = __ballot_sync(kFull, __ldg(cdf + probe) > u);
    if (above == 0) return hi;  // lane 31 probed hi - 1
    const int f = __ffs(above) - 1;
    const int next_lo = f == 0 ? lo : min(lo + f * step - 1, hi - 1) + 1;
    hi = min(lo + (f + 1) * step - 1, hi - 1);  // cdf[hi] > u: the answer is at most hi
    lo = next_lo;
  }
  const int k = lo + lane;
  const unsigned above = __ballot_sync(kFull, k < hi && __ldg(cdf + k) > u);
  return above ? lo + __ffs(above) - 1 : hi;
}

// First k in [0, len) with c[k] > u, else len (c in global or shared memory).
template <bool kGlobal>
__device__ __forceinline__ int binary_search(const float* c, int len, float u) {
  int lo = 0;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = lo + half;
    const float cm = kGlobal ? __ldg(c + mid) : c[mid];
    const bool right = !(cm > u);
    lo = right ? mid + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo;
}

__global__ void __launch_bounds__(kSearchThreads) resample_take_kernel(
    const float* __restrict__ cdf, int n, const float* __restrict__ positions, int m,
    const float* __restrict__ values, int d, float* __restrict__ out) {
  __shared__ float window[kWindow];
  __shared__ float red_min[kSearchThreads / 32], red_max[kSearchThreads / 32];
  __shared__ int bracket[2];
  const size_t f = blockIdx.y;
  cdf += f * n;
  values += f * d * n;
  out += f * d * m;
  positions += f * m;
  const int first = blockIdx.x * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float u[kPerThread];
  float umin = CUDART_INF_F, umax = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = first + j * kSearchThreads + threadIdx.x;
    u[j] = q < m ? __ldg(positions + q) : 0.0f;
    if (q < m) {
      umin = fminf(umin, u[j]);
      umax = fmaxf(umax, u[j]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    umin = fminf(umin, __shfl_xor_sync(kFull, umin, off));
    umax = fmaxf(umax, __shfl_xor_sync(kFull, umax, off));
  }
  if (lane == 0) {
    red_min[warp] = umin;
    red_max[warp] = umax;
  }
  __syncthreads();
  umin = red_min[0];
  umax = red_max[0];
  for (int w = 1; w < kSearchThreads / 32; ++w) {
    umin = fminf(umin, red_min[w]);
    umax = fmaxf(umax, red_max[w]);
  }
  // every donor of this block lies in [lo, hi]
  if (warp < 2) {
    const int k = warp_search(cdf, 0, n, warp == 0 ? umin : umax);
    if (lane == 0) bracket[warp] = k;
  }
  __syncthreads();
  int lo = bracket[0], len = bracket[1] - bracket[0];
  if (len < 0) {  // a CDF that is not monotone: search all of it
    lo = 0;
    len = n;
  }
  const bool staged = len <= kWindow;
  if (staged) {
    for (int k = threadIdx.x; k < len; k += kSearchThreads) window[k] = __ldg(cdf + lo + k);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = first + j * kSearchThreads + threadIdx.x;
    if (q >= m) break;
    int k;
    if (!(u[j] >= umin && u[j] <= umax)) {
      k = binary_search<true>(cdf, n, u[j]);  // NaN: outside every bracket
    } else {
      k = lo + (staged ? binary_search<false>(window, len, u[j])
                       : binary_search<true>(cdf + lo, len, u[j]));
    }
    float* row = out + static_cast<size_t>(q) * d;
    if (d == 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k < n) {
        v.x = __ldg(values + k);
        v.y = __ldg(values + static_cast<size_t>(n) + k);
        v.z = __ldg(values + 2 * static_cast<size_t>(n) + k);
        v.w = __ldg(values + 3 * static_cast<size_t>(n) + k);
      }
      *reinterpret_cast<float4*>(row) = v;
      continue;
    }
    for (int c = 0; c < d; ++c) {
      row[c] = k < n ? __ldg(values + static_cast<size_t>(c) * n + k) : 0.0f;
    }
  }
}

}  // namespace

// The CDF tile size: a filter of more weights needs `batch * tiles` float2
// partials of scratch.
extern "C" int beluga_cdf_tile() { return kTile; }

// The monotone CDF of `batch` filters of n weights into cdf (with
// `normalize` 0, the running maximum m before the division); `partials`
// (float2[batch][tiles], tiles = ceil(n / kTile)) is scratch, unused when
// tiles == 1.  One launch, or two beyond one tile.  Returns
// cudaGetLastError() after the launches.
extern "C" int beluga_cdf(const void* w, int n, int batch, void* partials, int normalize,
                          void* cdf, void* stream) {
  if (n == 0 || batch == 0) return 0;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles > 1) {
    cdf_partials_kernel<<<grid, kScanThreads, 0, s>>>(static_cast<const float*>(w), n, tiles,
                                                      static_cast<float2*>(partials));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cdf_scan_kernel<<<grid, kScanThreads, 0, s>>>(static_cast<const float*>(w), n, tiles,
                                                static_cast<const float2*>(partials),
                                                normalize != 0, static_cast<float*>(cdf));
  return static_cast<int>(cudaGetLastError());
}

// The search and donor copy on `stream` over `batch` filters; returns
// cudaGetLastError() of the launch.  `out` must be 16-byte aligned when
// d == 4 (PyTorch allocations are).
extern "C" int beluga_resample_take(const void* cdf, int n, const void* positions, int m,
                                    const void* values, int d, void* out, int batch,
                                    void* stream) {
  if (m == 0 || batch == 0) return 0;
  const dim3 grid((m + kChunk - 1) / kChunk, batch);
  resample_take_kernel<<<grid, kSearchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cdf), n, static_cast<const float*>(positions), m,
      static_cast<const float*>(values), d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Kernel S1: the theta sort of sorted_slots SE2 filters, each filter's sort
// key, its stable sort and the gather of its slots in one launch.
//
// Replaces no Pallas kernel: beluga_tpu/filters/amcl.py:se2_sort_key and
// beluga_tpu/core/particles.py:tree_sort_by leave the key's reductions, the
// sort and the gathers to XLA.  The port ran them as ~40 PyTorch operations
// a call (the key's nine reductions and ~20 elementwise passes, the mask's
// select, torch.sort, a take_along_dim a leaf): 3.04 device ms on an H100 at
// 4096 filters of 4096 slots, whose bytes need 0.200.
// Per filter f of n <= kMaxSlots slots, what filters/amcl.py:sort_slots
// computes on its plain path (se2_sort_key, the mask, tree_sort_by):
//
//   the means and population deviations of x, y and the heading chord
//   rc_i = hypot(cos_i - mean cos, sin_i - mean sin) over all n slots (dead
//   ones included);
//   stray_i = |x_i - mean x| / (sd x + 1e-6) > 3.5, or the same of y, or
//             (rc_i - mean rc) / (sd rc + 1e-6) > 3.5
//   key_i   = i < active[f] ? atan2(sin_i, cos_i) + 100 stray_i : inf
//
// and the slots' (x, y), (cos, sin) and log-weight written in the order of
// a stable ascending sort of the keys, as torch.sort(stable=True) orders
// them: -0 equal to +0, NaN keys last in slot order.
//
// What bounds it on an H100: the bytes, 20 a slot in (the (x, y) and
// (cos, sin) pairs, a log-weight) and 20 out, 4 a filter's live count; the
// sort's passes run in shared memory.  Design:
//  * one block a filter: its slots staged once in shared memory (20 bytes a
//    slot, 80 KB at 4096) with 16-byte loads where a row is aligned for
//    them (8- or 4-byte where not: the pooled injection cuts rows of n + 1
//    to n), neighbouring threads on neighbouring addresses;
//  * the statistics in float64 from shared memory, a pass for the means, one
//    for the centred squares and the chords (each kept in float, in the
//    space the keys' images take later) with their mean, one for the
//    chords' centred squares, each a block sum in a fixed order (no
//    atomics): two calls give the same bits, and the stray test is
//    float64's but for the chord's rounding to float (~1e-7 of its z);
//  * the keys' order-preserving 32-bit images and the slot indices sorted by
//    cub::BlockRadixSort, a least-significant-digit radix sort (stable: equal
//    keys keep their slots' order), ending striped so that thread t holds
//    ranks t, t + T, ...; the images share shared memory with the sort;
//  * each rank's slot gathered from the staged copy and stored coalesced.
//    Nothing between the load and the store goes through device memory.
// At 512 threads a block holds ~99 KB of shared memory: two blocks an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

#include "block_sum.cuh"

namespace {

constexpr int kItems = 8;  // slots a thread
constexpr int kMaxThreads = 512;
constexpr int kMaxSlots = kMaxThreads * kItems;

struct Args {
  const float* xy;        // (x, y) pairs, rows of xy_stride floats
  const float* z;         // (cos, sin) pairs, rows of z_stride floats
  const float* w;         // log-weights, rows of w_stride floats
  const int32_t* active;  // each filter's live prefix, active_stride apart
  long long xy_stride, z_stride, w_stride, active_stride;
  float* out_xy;          // [filters, n, 2], [filters, n, 2], [filters, n]
  float* out_z;
  float* out_w;
  float* out_key;         // [filters, n] or null
  int n;
};

// Copies `count` floats of `src` into shared `dst` (16-byte aligned): 16-,
// 8- or 4-byte loads as src's alignment allows.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int count) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  int done = 0;
  if ((at & 15) == 0) {
    const int v = count >> 2;
    for (int q = threadIdx.x; q < v; q += blockDim.x) {
      reinterpret_cast<float4*>(dst)[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
    }
    done = v << 2;
  } else if ((at & 7) == 0) {
    const int v = count >> 1;
    for (int q = threadIdx.x; q < v; q += blockDim.x) {
      reinterpret_cast<float2*>(dst)[q] = __ldg(reinterpret_cast<const float2*>(src) + q);
    }
    done = v << 1;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = __ldg(src + i);
}

// The key's order-preserving image: a < b as floats iff image(a) <
// image(b); -0 maps as +0 and every NaN to the largest image.
__device__ __forceinline__ uint32_t order_bits(float key) {
  if (key != key) return 0xffffffffu;
  uint32_t u = __float_as_uint(key);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Block f sorts filter f of n <= kThreads * kItems slots.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 2) sort_slots_kernel(Args a) {
  constexpr int kCap = kThreads * kItems;
  constexpr int kWarps = kThreads / 32;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, uint16_t>;
  __shared__ union alignas(16) {
    typename Sort::TempStorage sort;
    uint32_t bits[kCap];  // the keys' images, slot order
  } sh;
  __shared__ double red[kWarps * 4];
  extern __shared__ float4 staged[];  // (x, y) [n4], (cos, sin) [n4], log-weight [n4]

  const int n = a.n;
  const int n4 = (n + 3) & ~3;
  float* sxy = reinterpret_cast<float*>(staged);
  float* sz = sxy + 2 * n4;
  float* sw = sz + 2 * n4;
  const size_t f = blockIdx.x;
  stage(sxy, a.xy + f * a.xy_stride, 2 * n);
  stage(sz, a.z + f * a.z_stride, 2 * n);
  stage(sw, a.w + f * a.w_stride, n);
  const int live = max(0, min(__ldg(a.active + f * a.active_stride), n));
  __syncthreads();
  const float2* pxy = reinterpret_cast<const float2*>(sxy);
  const float2* pz = reinterpret_cast<const float2*>(sz);

  // the means of x, y, cos and sin
  double m[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = pxy[i], q = pz[i];
    m[0] += p.x;
    m[1] += p.y;
    m[2] += q.x;
    m[3] += q.y;
  }
  block_sum<kWarps>(m, red);
  const double inv_n = 1.0 / n;
  const double mx = m[0] * inv_n, my = m[1] * inv_n, mc = m[2] * inv_n, ms = m[3] * inv_n;

  // the centred squares of x and y, and the chords' mean; each chord kept
  // (in float) where the keys' images go later
  double v[3] = {0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float2 p = pxy[i], q = pz[i];
    const double dx = p.x - mx, dy = p.y - my;
    const float rc = static_cast<float>(hypot(q.x - mc, q.y - ms));
    sh.bits[i] = __float_as_uint(rc);
    v[0] += dx * dx;
    v[1] += dy * dy;
    v[2] += rc;
  }
  block_sum<kWarps>(v, red);
  const double mrc = v[2] * inv_n;

  // the chords' centred squares
  double u[1] = {0.0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double d = __uint_as_float(sh.bits[i]) - mrc;
    u[0] += d * d;
  }
  block_sum<kWarps>(u, red);
  const double ix = 1.0 / (sqrt(v[0] * inv_n) + 1e-6);
  const double iy = 1.0 / (sqrt(v[1] * inv_n) + 1e-6);
  const double it = 1.0 / (sqrt(u[0] * inv_n) + 1e-6);

  // the keys, striped (slot j * kThreads + t) as the chords were, their
  // images in slot order over the chords; past n the largest image, after
  // every key (NaN too: the sort is stable)
  float* key_row = a.out_key == nullptr ? nullptr : a.out_key + f * n;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    uint32_t bits = 0xffffffffu;
    if (i < n) {
      float key = INFINITY;
      if (i < live) {
        const float2 p = pxy[i], q = pz[i];
        const bool stray = fabs(p.x - mx) * ix > 3.5 || fabs(p.y - my) * iy > 3.5 ||
                           (__uint_as_float(sh.bits[i]) - mrc) * it > 3.5;
        key = atan2f(q.y, q.x) + (stray ? 100.0f : 0.0f);
      }
      if (key_row != nullptr) key_row[i] = key;
      bits = order_bits(key);
    }
    sh.bits[i] = bits;
  }
  __syncthreads();

  // blocked for the sort: thread t holds slots t * kItems + k
  uint32_t keys[kItems];
  uint16_t slots[kItems];
  const uint4* mine = reinterpret_cast<const uint4*>(sh.bits + threadIdx.x * kItems);
#pragma unroll
  for (int h = 0; h < kItems / 4; ++h) {
    const uint4 b = mine[h];
    keys[4 * h] = b.x;
    keys[4 * h + 1] = b.y;
    keys[4 * h + 2] = b.z;
    keys[4 * h + 3] = b.w;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) slots[k] = static_cast<uint16_t>(threadIdx.x * kItems + k);
  __syncthreads();  // the images' storage is the sort's
  Sort(sh.sort).SortBlockedToStriped(keys, slots);

  // rank k * kThreads + t takes slot slots[k]
  float2* oxy = reinterpret_cast<float2*>(a.out_xy) + f * n;
  float2* oz = reinterpret_cast<float2*>(a.out_z) + f * n;
  float* ow = a.out_w + f * n;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = k * kThreads + threadIdx.x;
    if (r < n) {
      const int s = slots[k];
      oxy[r] = pxy[s];
      oz[r] = pz[s];
      ow[r] = sw[s];
    }
  }
}

template <int kThreads>
int launch(const Args& a, int filters, cudaStream_t s) {
  // past 48 KB of static and dynamic shared memory together a block needs
  // the opt-in, whatever the dynamic part alone: set once, for the most
  // slots this instantiation takes
  constexpr int kMaxSmem = kThreads * kItems * 5 * sizeof(float);
  static bool configured = false;  // per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_slots_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const size_t smem = static_cast<size_t>((a.n + 3) & ~3) * 5 * sizeof(float);
  sort_slots_kernel<kThreads><<<filters, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Slots a filter the kernel takes at most.
extern "C" int beluga_sort_max_slots() { return kMaxSlots; }

// The theta sort of `filters` filters of n slots on `stream`, one launch of
// a block a filter (128, 256 or 512 threads as n needs; 1 <= n <=
// kMaxSlots, else cudaErrorInvalidValue).  xy and z hold (x, y) and
// (cos, sin) pairs, w log-weights, active int32 live counts; strides are in
// elements from one filter's row (or count) to the next.  out_xy, out_z,
// out_w are contiguous [filters, n, 2], [filters, n, 2], [filters, n];
// out_key, if not null, [filters, n] receives the keys in slot order.
// Returns cudaGetLastError() of the launch.
extern "C" int beluga_sort_slots_se2(const void* xy, long long xy_stride, const void* z,
                                     long long z_stride, const void* w, long long w_stride,
                                     const void* active, long long active_stride, int n,
                                     int filters, void* out_xy, void* out_z, void* out_w,
                                     void* out_key, void* stream) {
  if (filters == 0) return 0;
  if (n < 1 || n > kMaxSlots || filters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(xy), static_cast<const float*>(z),
               static_cast<const float*>(w), static_cast<const int32_t*>(active),
               xy_stride, z_stride, w_stride, active_stride,
               static_cast<float*>(out_xy), static_cast<float*>(out_z),
               static_cast<float*>(out_w), static_cast<float*>(out_key), n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 128 * kItems) return launch<128>(a, filters, s);
  if (n <= 256 * kItems) return launch<256>(a, filters, s);
  return launch<512>(a, filters, s);
}

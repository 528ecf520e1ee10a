// Kernel B7: the windowed range-LUT beam reweight.
//
// Replaces beluga_tpu/ops/pallas_beam_lut.py:beam_lut_windowed (with
// _beam_lut_call and its fleet form).  The range LUT holds, for every cell
// and each of K bearing bins, the cast range from the cell's centre; here it
// is bf16 [Hq, Wq, K], cell-major, zero-padded to the reference's padded
// dims.  Per particle p of filter f with cell (xi, yi) and heading theta:
//
//   covered = xi in [x0, x0 + 40) and yi in [y0, y0 + 128), the window of
//             p's (filter, 4096-slot tile, block) from `origins`
//   per unmasked beam b (measured range z_b, bearing beta_b):
//     ft = mod(theta + beta_b, 2 pi) / 2 pi * K,  k0 = floor(ft) mod K,
//     k1 = (k0 + 1) mod K,  a = ft - floor(ft)
//     r_k = covered ? float(LUT[yi, xi, k]) : lut_max_range
//     z_mean = (1 - a) r_k0 + a r_k1
//   out_p = sum_b pz_b^3 (the mixture of beam_mixture.cuh), beams in order.
//
// The window origins are the reference's (pallas_beam_lut.py:256-281): per
// (filter, tile, block) the truncated mean cell of the valid slots,
// clipped; window_origins_kernel computes them on the card, one block per
// (filter, tile, block): the integer sums are exact in any order, the mean
// is one float32 division, as the plain version's.  The reference's banded
// stage 2 only schedules the same two-row select and is not reproduced.  A
// masked beam adds nothing (a select, pallas_beam_lut.py:154-156).
// jnp.mod is fmod plus the divisor where the remainder is negative.  Every
// operation is a round-to-nearest intrinsic in the reference's order, so
// the plain PyTorch version gives the same bits and the selected ranges are
// the same bf16 entries.
//
// What bounds it on an H100: ~110 float32 operations per (particle, beam)
// (the bin, the blend, the mixture's exponentials and erfs) against 12 B in
// and 4 B out a particle and two 2-byte L2 reads per beam: operations.  The
// LUT (37.7 MB at 128 x 384^2) fits the 50 MB L2.  Design: one thread per
// (particle, unmasked beam) ray, so that a node's 2000 particles fill the
// card as a fleet's 262144 do.  A block of 256 threads holds P consecutive
// slots of one filter (P = 64, or 32, 16, 8 where fewer blocks would not
// fill the card); P divides 256, so the block lies in one (tile, block) of
// the reference and reads one window origin.  Warp 0 compacts the filter's
// unmasked beams in order into shared memory, a chunk of at most kChunk at
// a time; the block's threads take its P x live rays (the ray index and
// the bin's wrap stepped without an integer division), each writes its
// pz^3 into a shared slot, and one thread per particle adds the chunk's
// slots in beam order, so that the sum takes the plain version's __fadd_rn
// operations in its order.  mod(x, 2 pi) takes x itself, or x -+ 2 pi
// (exact by Sterbenz's lemma), where |x| < 2 * 2 pi, as fmodf would, and
// fmodf beyond.  The LUT is read through the read-only path; a filter axis
// on blockIdx.y.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_mixture.cuh"

namespace {

constexpr int kTile = 4096;   // pallas_reweight.py:_TILE
constexpr int kSplit = 3840;  // _BLOCKS = ((0, 3840), (3840, 256))
constexpr int kCwx = 40, kCwy = 128;
constexpr float k2Pi = 6.28318530717959f;  // float32(2 pi)
constexpr int kThreads = 256;
constexpr int kMaxParticles = 64;  // P, slots of one filter per block
constexpr int kChunk = 64;         // unmasked beams staged at a time
constexpr int kSlotStride = kChunk + 1;  // the pz^3 slots of one particle (no bank conflicts)

struct Lut {
  const uint16_t* __restrict__ values;  // bf16 bits [hq, wq, k]
  int hq, wq, k;
  float max_range;
};

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// fmodf(x, 2 pi), exact: x where |x| < 2 pi; x -+ 2 pi, exact, where
// 2 pi <= |x| < 4 pi (fmod keeps the sign of x at a zero result)
__device__ __forceinline__ float fmod_2pi(float x) {
  const float ax = fabsf(x);
  if (ax < k2Pi) return x;
  if (ax < 2.0f * k2Pi) {
    const float r = x > 0.0f ? __fsub_rn(x, k2Pi) : __fadd_rn(x, k2Pi);
    return r == 0.0f ? copysignf(0.0f, x) : r;
  }
  return fmodf(x, k2Pi);
}

// floor(v / 64) for any int
__device__ __forceinline__ int floor_div64(int v) { return v >= 0 ? v / 64 : -((63 - v) / 64); }

__global__ void __launch_bounds__(kThreads)
    window_origins_kernel(const int* __restrict__ xi, const int* __restrict__ yi, int n,
                          int tiles, int hq, int wq, int* __restrict__ origins) {
  const int f = blockIdx.y, tile = blockIdx.x >> 1, blk = blockIdx.x & 1;
  const int start = tile * kTile + (blk ? kSplit : 0);
  const int stop = min(start + (blk ? kTile - kSplit : kSplit), n);
  const size_t base = static_cast<size_t>(f) * n;
  long long sx = 0, sy = 0;
  for (int i = start + threadIdx.x; i < stop; i += kThreads) {
    sx += xi[base + i];
    sy += yi[base + i];
  }
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_down_sync(0xffffffffu, sx, o);
    sy += __shfl_down_sync(0xffffffffu, sy, o);
  }
  __shared__ long long s_sum[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_sum[0][warp] = sx;
    s_sum[1][warp] = sy;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sx = sy = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    sx += s_sum[0][w];
    sy += s_sum[1][w];
  }
  // the plain version: float32(sum) / float32(max(count, 1)), truncated
  const float count = static_cast<float>(max(stop - start, 1));
  const int cx = static_cast<int>(__fdiv_rn(__ll2float_rn(sx), count));
  const int cy = static_cast<int>(__fdiv_rn(__ll2float_rn(sy), count));
  const int x0 = min(max(cx - kCwx / 2, 0), wq - kCwx);
  const int y0 = 64 * min(max(floor_div64(cy - kCwy / 2 + 32), 0), (hq - kCwy) / 64);
  int* o = origins + ((static_cast<size_t>(f) * tiles + tile) * 2 + blk) * 2;
  o[0] = x0;
  o[1] = y0;
}

__global__ void __launch_bounds__(kThreads)
    beam_lut_kernel(Lut lut, const float* __restrict__ theta, const int* __restrict__ xi,
                    const int* __restrict__ yi, int n, const int* __restrict__ origins,
                    int tiles, int per_block, const float* __restrict__ z,
                    const float* __restrict__ bearing, const uint8_t* __restrict__ mask,
                    int nb, beam::Mixture mix, float* __restrict__ out) {
  __shared__ float s_z[kChunk], s_bearing[kChunk];
  __shared__ float s_theta[kMaxParticles];
  __shared__ int s_column[kMaxParticles];  // the LUT column's offset, -1 outside the window
  __shared__ float s_pz3[kMaxParticles * kSlotStride];
  __shared__ int s_live, s_next;
  const int f = blockIdx.y;
  const int i0 = blockIdx.x * per_block;
  const int q_own = threadIdx.x;  // the particle whose sum this thread keeps, if < per_block
  if (q_own < per_block && i0 + q_own < n) {
    const size_t p = static_cast<size_t>(f) * n + i0 + q_own;
    const int tile = i0 / kTile, blk = (i0 % kTile) < kSplit ? 0 : 1;
    const int* o = origins + ((static_cast<size_t>(f) * tiles + tile) * 2 + blk) * 2;
    const int x0 = o[0], y0 = o[1];
    const int cx = xi[p], cy = yi[p];
    const bool covered = cx >= x0 && cx < x0 + kCwx && cy >= y0 && cy < y0 + kCwy;
    s_column[q_own] = covered ? (cy * lut.wq + cx) * lut.k : -1;
    s_theta[q_own] = theta[p];
  }
  const float kf = static_cast<float>(lut.k);
  float acc = 0.0f;
  int next = 0;
  for (;;) {
    __syncthreads();  // the particles are staged; the last chunk's slots are summed
    if (threadIdx.x < 32) {
      // warp 0 stages the next unmasked beams in beam order: a masked beam
      // adds nothing, so leaving it out changes no bit
      const int lane = threadIdx.x;
      int live = 0, b0 = next;
      while (b0 < nb && live <= kChunk - 32) {
        const int b = b0 + lane;
        const size_t kb = static_cast<size_t>(f) * nb + b;
        const bool on = b < nb && mask[kb] != 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, on);
        if (on) {
          const int i = live + __popc(ballot & ((1u << lane) - 1u));
          s_z[i] = z[kb];
          s_bearing[i] = bearing[kb];
        }
        live += __popc(ballot);
        b0 += 32;
      }
      if (lane == 0) {
        s_live = live;
        s_next = b0;
      }
    }
    __syncthreads();
    const int live = s_live;
    next = s_next;
    if (live == 0) break;  // no unmasked beam left
    // ray t = q * live + j: particle q, the chunk's beam j
    const int step_q = kThreads / live, step_j = kThreads - step_q * live;
    int q = threadIdx.x / live, j = threadIdx.x - q * live;
    for (int t = threadIdx.x; t < per_block * live; t += kThreads) {
      if (i0 + q < n) {
        const int column = s_column[q];
        float r = fmod_2pi(__fadd_rn(s_theta[q], s_bearing[j]));
        if (r < 0.0f) r = __fadd_rn(r, k2Pi);
        const float ft = __fmul_rn(__fdiv_rn(r, k2Pi), kf);
        const float fl = floorf(ft);
        int k0 = static_cast<int>(fl);
        if (k0 < 0 || k0 >= lut.k) {
          k0 %= lut.k;
          if (k0 < 0) k0 += lut.k;
        }
        const int k1 = k0 + 1 == lut.k ? 0 : k0 + 1;
        const float a = __fsub_rn(ft, fl);
        const uint16_t* entries = lut.values + column;
        const float r0 = column >= 0 ? bf16_to_float(__ldg(entries + k0)) : lut.max_range;
        const float r1 = column >= 0 ? bf16_to_float(__ldg(entries + k1)) : lut.max_range;
        const float z_mean = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, a), r0), __fmul_rn(a, r1));
        s_pz3[q * kSlotStride + j] = beam::pz3(mix, s_z[j], z_mean);
      }
      q += step_q;
      j += step_j;
      if (j >= live) {
        j -= live;
        ++q;
      }
    }
    __syncthreads();
    if (q_own < per_block) {  // the particle's sum, beam by beam in order
      const float* slots = s_pz3 + q_own * kSlotStride;
      for (int j = 0; j < live; ++j) acc = __fadd_rn(acc, slots[j]);
    }
    if (next >= nb) break;
  }
  if (q_own < per_block && i0 + q_own < n) out[static_cast<size_t>(f) * n + i0 + q_own] = acc;
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

void launch_origins(const void* xi, const void* yi, int n, int filters, int hq, int wq,
                    void* origins, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  window_origins_kernel<<<dim3(2 * tiles, filters), kThreads, 0, stream>>>(
      static_cast<const int*>(xi), static_cast<const int*>(yi), n, tiles, hq, wq,
      static_cast<int*>(origins));
}

}  // namespace

// The window origins of B7 for `filters` filters of n particles: xi/yi
// int32 [filters, n] cells; writes origins int32 [filters, tiles, 2, 2]
// ((x0, y0) per tile of 4096 slots and block).  Returns cudaGetLastError()
// of the launch.
extern "C" int beluga_beam_lut_origins(const void* xi, const void* yi, int n, int filters,
                                       int hq, int wq, void* origins, void* stream) {
  if (n == 0 || filters == 0) return 0;
  launch_origins(xi, yi, n, filters, hq, wq, origins, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// B7 over `filters` filters of n particles, two launches: the window
// origins into `origins` (int32 [filters, tiles, 2, 2], scratch), then the
// weights.  theta float32 [filters, n] (grid-local headings), xi/yi int32
// [filters, n] cells; z/bearing float32 [filters, nb], mask uint8
// [filters, nb]; values the bf16 LUT [hq, wq, k] as raw bits; mixture the
// nine floats of beam_mixture.cuh on the host.  Writes out float32
// [filters, n].  Returns cudaGetLastError() after the launches.
extern "C" int beluga_beam_lut(const void* values, int hq, int wq, int k, float max_range,
                               const void* theta, const void* xi, const void* yi, int n,
                               void* origins, const void* z, const void* bearing,
                               const void* mask, int nb, int filters, const float* mixture,
                               void* out, void* stream) {
  if (n == 0 || filters == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  launch_origins(xi, yi, n, filters, hq, wq, origins, s);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  const Lut lut{static_cast<const uint16_t*>(values), hq, wq, k, max_range};
  beam::Mixture mix;
  for (int j = 0; j < beam::kNumMixture; ++j) mix.v[j] = mixture[j];
  // P slots a block: the largest of 64, 32, 16, 8 that still gives two
  // blocks an SM
  int per_block = kMaxParticles;
  while (per_block > 8 &&
         static_cast<long long>(filters) * ((n + per_block - 1) / per_block) < 2LL * num_sms()) {
    per_block /= 2;
  }
  const dim3 grid((n + per_block - 1) / per_block, filters);
  beam_lut_kernel<<<grid, kThreads, 0, s>>>(
      lut, static_cast<const float*>(theta), static_cast<const int*>(xi),
      static_cast<const int*>(yi), n, static_cast<const int*>(origins), (n + kTile - 1) / kTile,
      per_block, static_cast<const float*>(z), static_cast<const float*>(bearing),
      static_cast<const uint8_t*>(mask), nb, mix, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

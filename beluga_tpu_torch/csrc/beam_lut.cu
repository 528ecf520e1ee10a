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
// The window origins are the reference's (per tile and block the
// truncated mean cell of the valid slots, clipped), computed by the
// wrapper; the reference's banded stage 2 only schedules the same two-row
// select and is not reproduced.  A masked beam adds nothing (a select,
// pallas_beam_lut.py:154-156).  jnp.mod is fmod plus the divisor where the
// remainder is negative.  Every operation is a round-to-nearest intrinsic
// in the reference's order, so the plain PyTorch version gives the same
// bits and the selected ranges are the same bf16 entries.
//
// What bounds it on an H100: ~70 float32 operations per (particle, beam)
// (the bin, the blend, the mixture's three exponentials and two erfs)
// against 12 B in and 4 B out a particle and two 2-byte L2 reads per beam:
// operations.  The LUT (37.7 MB at 128 x 384^2) fits the 50 MB L2.  Design,
// simple first: one thread per particle walks its beams in order, the
// filter's beams (z, bearing, mask) in shared memory, the two entries read
// from global memory through the read-only path; a filter axis on
// blockIdx.y.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_mixture.cuh"

namespace {

constexpr int kTile = 4096;   // pallas_reweight.py:_TILE
constexpr int kSplit = 3840;  // _BLOCKS = ((0, 3840), (3840, 256))
constexpr int kCwx = 40, kCwy = 128;
constexpr float k2Pi = 6.28318530717959f;  // float32(2 pi)

struct Lut {
  const uint16_t* __restrict__ values;  // bf16 bits [hq, wq, k]
  int hq, wq, k;
  float max_range;
};

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__global__ void beam_lut_kernel(Lut lut, const float* __restrict__ theta,
                                const int* __restrict__ xi, const int* __restrict__ yi, int n,
                                const int* __restrict__ origins, int tiles,
                                const float* __restrict__ z, const float* __restrict__ bearing,
                                const uint8_t* __restrict__ mask, int nb, beam::Mixture mix,
                                float* __restrict__ out) {
  extern __shared__ float beams[];  // [nb][3]: z, bearing, mask
  const int f = blockIdx.y;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const size_t k = static_cast<size_t>(f) * nb + b;
    beams[3 * b] = z[k];
    beams[3 * b + 1] = bearing[k];
    beams[3 * b + 2] = mask[k] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t p = static_cast<size_t>(f) * n + i;
  const int tile = i / kTile, blk = (i % kTile) < kSplit ? 0 : 1;
  const int* o = origins + ((static_cast<size_t>(f) * tiles + tile) * 2 + blk) * 2;
  const int x0 = o[0], y0 = o[1];
  const int cx = xi[p], cy = yi[p];
  const bool covered = cx >= x0 && cx < x0 + kCwx && cy >= y0 && cy < y0 + kCwy;
  const uint16_t* column =
      lut.values + (static_cast<size_t>(covered ? cy : 0) * lut.wq + (covered ? cx : 0)) * lut.k;
  const float th = theta[p];
  const float kf = static_cast<float>(lut.k);
  float acc = 0.0f;
  for (int b = 0; b < nb; ++b) {
    if (beams[3 * b + 2] == 0.0f) continue;  // masked: adds 0
    float r = fmodf(__fadd_rn(th, beams[3 * b + 1]), k2Pi);
    if (r < 0.0f) r = __fadd_rn(r, k2Pi);
    const float ft = __fmul_rn(__fdiv_rn(r, k2Pi), kf);
    const float fl = floorf(ft);
    int k0 = static_cast<int>(fl) % lut.k;
    if (k0 < 0) k0 += lut.k;
    const int k1 = (k0 + 1) % lut.k;
    const float a = __fsub_rn(ft, fl);
    const float r0 = covered ? bf16_to_float(__ldg(column + k0)) : lut.max_range;
    const float r1 = covered ? bf16_to_float(__ldg(column + k1)) : lut.max_range;
    const float z_mean = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, a), r0), __fmul_rn(a, r1));
    acc = __fadd_rn(acc, beam::pz3(mix, beams[3 * b], z_mean));
  }
  out[p] = acc;
}

}  // namespace

// B7 over `filters` filters of n particles: theta float32 [filters, n]
// (grid-local headings), xi/yi int32 [filters, n] cells; origins int32
// [filters, tiles, 2, 2] (x0, y0 per tile and block); z/bearing float32
// [filters, nb], mask uint8 [filters, nb]; values the bf16 LUT [hq, wq, k]
// as raw bits; mixture the nine floats of beam_mixture.cuh on the host.
// Writes out float32 [filters, n].  Returns cudaGetLastError() of the
// launch.
extern "C" int beluga_beam_lut(const void* values, int hq, int wq, int k, float max_range,
                               const void* theta, const void* xi, const void* yi, int n,
                               const void* origins, int tiles, const void* z,
                               const void* bearing, const void* mask, int nb, int filters,
                               const float* mixture, void* out, void* stream) {
  if (n == 0 || filters == 0) return 0;
  const Lut lut{static_cast<const uint16_t*>(values), hq, wq, k, max_range};
  beam::Mixture mix;
  for (int j = 0; j < beam::kNumMixture; ++j) mix.v[j] = mixture[j];
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads, filters);
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(nb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  beam_lut_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut, static_cast<const float*>(theta), static_cast<const int*>(xi),
      static_cast<const int*>(yi), n, static_cast<const int*>(origins), tiles,
      static_cast<const float*>(z), static_cast<const float*>(bearing),
      static_cast<const uint8_t*>(mask), nb, mix, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Kernel B9: the shared-scan correlation LUT, all heading bins of one scan.
//
// Replaces beluga_tpu/ops/pallas_scan_lut.py:scan_lut_correlate
// (_kernel_bilinear and _kernel_nearest).  For a padded pz^3 field F [hp, wp]
// and K heading bins, the wrapper (ops/cuda_scan_lut.py) turns each (bin k,
// beam b) into a cell shift (sy, sx) = (mod(-iy, hp), mod(-ix, wp)) and the
// weights (m, ax, ay), m the beam mask as 0/1.  pltpu.roll(a, s) reads
// a[(i - s) mod n], so the reference's rolled images read F at
// ((y - sy) mod hp, (x - sx) mod wp) = ((y + iy) mod hp, (x + ix) mod wp),
// and output cell (k, y, x) is, with the beams in order b = 0..B-1:
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
// What bounds it on an H100: float32 operations.  At the shared-scan
// filter's shape (K 128, F 280 x 384 after downsample 2, 60 beams, nearest)
// the 8.26e8 (cell, beam) multiply-adds are 1.65 GFLOP, 24.6 us at 67
// TFLOP/s, above the 55.1 MB output's 16.6 us at 3.35 TB/s.  Bilinear at full
// resolution (K 128, 552 x 640, 60 beams): 2.71e9 pairs x 7 operations, 283
// us, above the 181 MB output's 54 us.  Design, simple first: one thread per
// output cell, a 32 x 8 block over one heading bin (blockIdx.z), so a warp
// stores 32 consecutive x; the bin's per-beam shifts and weights staged in
// shared memory (every thread reads the same beam at once, a broadcast); F
// through the read-only path (430 KB or 1.4 MB, resident in the 50 MB L2);
// each thread loops over the unmasked beams only (warp 0 compacts them into
// shared memory in order; 26 of 60 at the shared-scan shape) with its sums in
// registers.  Staging a halo tile of F in shared memory is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

template <bool Bilinear>
__global__ void scan_lut_kernel(const float* __restrict__ field, int hp, int wp,
                                const int32_t* __restrict__ shifts,
                                const float* __restrict__ weights, int nb,
                                float* __restrict__ out) {
  extern __shared__ int32_t smem[];
  __shared__ int s_live;                                    // unmasked beams staged
  int32_t* s_sy = smem;                                     // [nb]
  int32_t* s_sx = s_sy + nb;                                // [nb]
  float* s_c0 = reinterpret_cast<float*>(s_sx + nb);        // [nb] m, or m * (1 - ay)
  float* s_c1 = s_c0 + nb;                                  // [nb] m * ay
  float* s_ax = s_c1 + nb;                                  // [nb]
  const size_t k = blockIdx.z;
  if (threadIdx.y == 0) {
    // warp 0 stages the bin's beams with m != 0, in beam order: a masked
    // beam adds +0 to both sums, so leaving it out changes no bit
    int live = 0;
    for (int b0 = 0; b0 < nb; b0 += kTileX) {
      const int b = b0 + threadIdx.x;
      const size_t kb = k * nb + b;
      const float m = b < nb ? weights[3 * kb] : 0.0f;
      const unsigned ballot = __ballot_sync(0xffffffffu, m != 0.0f);
      if (m != 0.0f) {
        const int i = live + __popc(ballot & ((1u << threadIdx.x) - 1u));
        const float ax = weights[3 * kb + 1], ay = weights[3 * kb + 2];
        s_sy[i] = shifts[2 * kb];
        s_sx[i] = shifts[2 * kb + 1];
        s_c0[i] = Bilinear ? __fmul_rn(m, __fsub_rn(1.0f, ay)) : m;
        s_c1[i] = __fmul_rn(m, ay);
        s_ax[i] = ax;
      }
      live += __popc(ballot);
    }
    if (threadIdx.x == 0) s_live = live;
  }
  __syncthreads();
  const int live = s_live;

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= wp || y >= hp) return;
  float acc_u = 0.0f, acc_v = 0.0f;
  for (int b = 0; b < live; ++b) {
    int ry = y - s_sy[b];
    if (ry < 0) ry += hp;
    int cx = x - s_sx[b];
    if (cx < 0) cx += wp;
    const float* row0 = field + static_cast<size_t>(ry) * wp;
    if (!Bilinear) {
      acc_u = __fadd_rn(acc_u, __fmul_rn(s_c0[b], __ldg(row0 + cx)));
      continue;
    }
    const int cx1 = cx + 1 == wp ? 0 : cx + 1;
    const int ry1 = ry + 1 == hp ? 0 : ry + 1;
    const float* row1 = field + static_cast<size_t>(ry1) * wp;
    const float ax = s_ax[b];
    const float a0 = __ldg(row0 + cx), a1 = __ldg(row0 + cx1);
    const float b0 = __ldg(row1 + cx), b1 = __ldg(row1 + cx1);
    const float u0 = __fadd_rn(a0, __fmul_rn(ax, __fsub_rn(a1, a0)));
    const float u1 = __fadd_rn(b0, __fmul_rn(ax, __fsub_rn(b1, b0)));
    acc_u = __fadd_rn(acc_u, __fmul_rn(s_c0[b], u0));
    acc_v = __fadd_rn(acc_v, __fmul_rn(s_c1[b], u1));
  }
  out[(k * hp + y) * static_cast<size_t>(wp) + x] = Bilinear ? __fadd_rn(acc_u, acc_v) : acc_u;
}

template <bool Bilinear>
int launch(const void* field, int hp, int wp, const void* shifts, const void* weights,
           int n_theta, int nb, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nb) * (2 * sizeof(int32_t) + 3 * sizeof(float));
  if (smem > 48 * 1024) {
    if (cudaError_t err = cudaFuncSetAttribute(scan_lut_kernel<Bilinear>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem))) {
      return static_cast<int>(err);
    }
  }
  const dim3 block(kTileX, kTileY);
  const dim3 grid((wp + kTileX - 1) / kTileX, (hp + kTileY - 1) / kTileY, n_theta);
  scan_lut_kernel<Bilinear><<<grid, block, smem, stream>>>(
      static_cast<const float*>(field), hp, wp, static_cast<const int32_t*>(shifts),
      static_cast<const float*>(weights), nb, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B9 over n_theta bins: field float32 [hp, wp], shifts int32 [n_theta, nb, 2],
// weights float32 [n_theta, nb, 3] (m, ax, ay), out float32 [n_theta, hp, wp];
// bilinear non-zero samples bilinearly, else nearest.  Returns
// cudaGetLastError() of the launch.
extern "C" int beluga_scan_lut(const void* field, int hp, int wp, const void* shifts,
                               const void* weights, int n_theta, int nb, int bilinear,
                               void* out, void* stream) {
  if (n_theta == 0 || hp == 0 || wp == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return bilinear ? launch<true>(field, hp, wp, shifts, weights, n_theta, nb, out, s)
                  : launch<false>(field, hp, wp, shifts, weights, n_theta, nb, out, s);
}

// Kernel B8: the sphere-traced beam model.
//
// Replaces beluga_tpu/ops/pallas_beam.py:sphere_trace_beam_weights.  Per
// particle p and unmasked beam b, the ray starts at the centre of the
// particle's cell, px = floor(tx / res) + 0.5 (in cells), and marches along
// the beam's world direction over the map's distance table D (uint8, the
// floor of the Euclidean distance in cells to the nearest non-free cell,
// 0 off the map):
//
//   each step reads D at floor(p + dist * dir); inside the map with D == 0
//   the ray hits at z_cells = dist; it stops on a hit, on leaving the map,
//   or once dist > max_range / res; otherwise it jumps max(D - 1, 1) cells;
//   at most march_steps steps.
//
// z_mean = min(hit ? z_cells * res : max_range, max_range), then the beam
// mixture of beam_mixture.cuh, and out_p = sum_b pz_b^3 over the beams in
// order.  Stopping at the first stop is exact (the reference's `done`
// freezes its carry).  A masked beam adds nothing, without being traced:
// the reference adds bm * pz^3 (pallas_beam.py:177), so a masked beam that
// carries a NaN point makes its weight NaN; here it is a select, as in
// kernel B7 and the exact path.  The scalars are the reference's vector
// (res, beam_max_range, z_hit, z_short, z_max, z_rand, sigma_hit,
// lambda_short) with the mixture's scalar products taken once on the host.
//
// What bounds it on an H100: the dependent chain of table reads, one L2
// read per step (the table is 147 KB at 384^2 and 1 MB at 1024^2 and stays
// in L2), and ~60 float32 operations per beam for the mixture; the bytes
// (16 B in, 4 B out a particle) are far below either.  Design, simple
// first: one thread per particle walks its beams in order, the filter's
// beams (bx, by, z, mask) in shared memory, the table read through the
// read-only path; a filter axis on blockIdx.y.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_mixture.cuh"

namespace {

struct Trace {
  float res, max_cells;
  int march_steps;
  beam::Mixture mix;
};

__global__ void sphere_trace_kernel(const uint8_t* __restrict__ dist_cells, int h, int w,
                                    const float* __restrict__ tx, const float* __restrict__ ty,
                                    const float* __restrict__ cosv,
                                    const float* __restrict__ sinv, int n,
                                    const float* __restrict__ bearings,
                                    const float* __restrict__ ranges,
                                    const uint8_t* __restrict__ mask, int nb, Trace tr,
                                    float* __restrict__ out) {
  extern __shared__ float beams[];  // [nb][4]: bx, by, z, mask
  const int f = blockIdx.y;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const size_t k = static_cast<size_t>(f) * nb + b;
    beams[4 * b] = bearings[2 * k];
    beams[4 * b + 1] = bearings[2 * k + 1];
    beams[4 * b + 2] = ranges[k];
    beams[4 * b + 3] = mask[k] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t p = static_cast<size_t>(f) * n + i;
  const float res = tr.res;
  const float bmr = tr.mix.v[beam::kBmr];
  const float px = __fadd_rn(floorf(__fdiv_rn(tx[p], res)), 0.5f);
  const float py = __fadd_rn(floorf(__fdiv_rn(ty[p], res)), 0.5f);
  const float c = cosv[p], s = sinv[p];
  float acc = 0.0f;
  for (int b = 0; b < nb; ++b) {
    if (beams[4 * b + 3] == 0.0f) continue;  // masked: adds 0
    const float bx = beams[4 * b], by = beams[4 * b + 1];
    const float dx = __fsub_rn(__fmul_rn(bx, c), __fmul_rn(by, s));
    const float dy = __fadd_rn(__fmul_rn(bx, s), __fmul_rn(by, c));
    float dist = 0.0f, z_cells = 0.0f;
    bool hit = false;
    for (int step = 0; step < tr.march_steps; ++step) {
      const float fx = floorf(__fadd_rn(px, __fmul_rn(dist, dx)));
      const float fy = floorf(__fadd_rn(py, __fmul_rn(dist, dy)));
      // compared as floats: a NaN coordinate is outside
      const bool in = fx >= 0.0f && fx < static_cast<float>(w) && fy >= 0.0f &&
                      fy < static_cast<float>(h);
      if (!in) break;  // a miss
      const float d = static_cast<float>(
          __ldg(dist_cells + static_cast<size_t>(fy) * w + static_cast<size_t>(fx)));
      if (d == 0.0f) {
        z_cells = dist;
        hit = true;
        break;
      }
      if (dist > tr.max_cells) break;
      dist = __fadd_rn(dist, fmaxf(__fsub_rn(d, 1.0f), 1.0f));
    }
    const float z_mean = fminf(hit ? __fmul_rn(z_cells, res) : bmr, bmr);
    acc = __fadd_rn(acc, beam::pz3(tr.mix, beams[4 * b + 2], z_mean));
  }
  out[p] = acc;
}

}  // namespace

// B8 over `filters` filters of n particles: tx/ty/cos/sin float32
// [filters, n] (grid-local poses), bearings float32 [filters, nb, 2] unit
// vectors, ranges float32 [filters, nb], mask uint8 [filters, nb];
// dist_cells uint8 [h, w]; scalars on the host: res, max_cells and the nine
// mixture floats of beam_mixture.cuh.  Writes out float32 [filters, n].
// Returns cudaGetLastError() of the launch.
extern "C" int beluga_sphere_trace(const void* dist_cells, int h, int w, const void* tx,
                                   const void* ty, const void* cosv, const void* sinv, int n,
                                   const void* bearings, const void* ranges, const void* mask,
                                   int nb, int filters, float res, float max_cells,
                                   int march_steps, const float* mixture, void* out,
                                   void* stream) {
  if (n == 0 || filters == 0) return 0;
  Trace tr;
  tr.res = res;
  tr.max_cells = max_cells;
  tr.march_steps = march_steps;
  for (int k = 0; k < beam::kNumMixture; ++k) tr.mix.v[k] = mixture[k];
  const int threads = 128;
  const dim3 grid((n + threads - 1) / threads, filters);
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(nb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sphere_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sphere_trace_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dist_cells), h, w, static_cast<const float*>(tx),
      static_cast<const float*>(ty), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), n, static_cast<const float*>(bearings),
      static_cast<const float*>(ranges), static_cast<const uint8_t*>(mask), nb, tr,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

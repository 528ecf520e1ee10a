// Kernel B1: AMCL likelihood-field weights through the code table.
//
// Replaces beluga_tpu/ops/pallas_reweight.py:fused_reweight on its exact
// path (values3=None, log_space=False).  For every particle i:
//
//   x_b = px_b*cos_i - py_b*sin_i + tx_i,   y_b = px_b*sin_i + py_b*cos_i + ty_i
//   cell = (floor(x_b / res), floor(y_b / res))
//   pz_b = codebook[codes[cell]] inside the map, unknown_prob outside
//   w_i  = 1 + sum over unmasked b (in order b = 0..B-1) of pz_b^3
//
// What bounds it on an H100: per particle it reads 16 B (tx, ty, cos, sin)
// and writes 4 B, and the code table (H*W bytes, 147 KB for a 384x384 map)
// once: the bytes set the floor.  The 13 float32 operations per unmasked
// beam give a floor almost as high, and each beam's table read depends on
// its transform and division, so latency, not either floor, sets the time
// of this simple form.  Design: one thread per particle, the beam
// endpoints and the codebook in shared memory (every thread reads the same
// beam at the same time, a broadcast), the code table through the
// read-only path as uint8 (it stays in L2).
//
// Cell exactness: floor(x / res) must match the plain PyTorch version bit
// for bit.  nvcc would contract a*b - c*d + e into FMAs, which can move a
// point across a cell edge, so the transform, the division and the cube
// are written with the round-to-nearest intrinsics, which are never
// contracted.  The beam sum runs in order in float32; it differs from a
// parallel sum only in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void reweight_kernel(const uint8_t* __restrict__ codes, int h, int w,
                                const float* __restrict__ codebook, int k,
                                const float* __restrict__ tx, const float* __restrict__ ty,
                                const float* __restrict__ cs, const float* __restrict__ sn,
                                int n, const float* __restrict__ points,
                                const uint8_t* __restrict__ beam_mask, int nb, float res,
                                float unknown_prob, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_book = smem;           // [k]
  float* s_px = s_book + k;       // [nb]
  float* s_py = s_px + nb;        // [nb]
  float* s_on = s_py + nb;        // [nb], 1.0 for an unmasked beam
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_book[j] = codebook[j];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    s_px[b] = points[2 * b];
    s_py[b] = points[2 * b + 1];
    s_on[b] = beam_mask[b] ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c = cs[i], s = sn[i], x0 = tx[i], y0 = ty[i];
  const float fw = static_cast<float>(w), fh = static_cast<float>(h);
  float acc = 0.0f;
  for (int b = 0; b < nb; ++b) {
    if (s_on[b] == 0.0f) continue;
    const float px = s_px[b], py = s_py[b];
    const float x = __fadd_rn(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)), x0);
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)), y0);
    const float fx = floorf(__fdiv_rn(x, res));
    const float fy = floorf(__fdiv_rn(y, res));
    float pz = unknown_prob;
    if (fx >= 0.0f && fx < fw && fy >= 0.0f && fy < fh) {
      const int code = __ldg(codes + static_cast<int>(fy) * w + static_cast<int>(fx));
      pz = code < k ? s_book[code] : 0.0f;
    }
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(pz, pz), pz));
  }
  out[i] = __fadd_rn(1.0f, acc);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int beluga_reweight(const void* codes, int h, int w, const void* codebook, int k,
                               const void* tx, const void* ty, const void* cs, const void* sn,
                               int n, const void* points, const void* beam_mask, int nb,
                               float res, float unknown_prob, void* out, void* stream) {
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(k) + 3 * static_cast<size_t>(nb));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reweight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  reweight_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), h, w, static_cast<const float*>(codebook), k,
      static_cast<const float*>(tx), static_cast<const float*>(ty),
      static_cast<const float*>(cs), static_cast<const float*>(sn), n,
      static_cast<const float*>(points), static_cast<const uint8_t*>(beam_mask), nb, res,
      unknown_prob, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

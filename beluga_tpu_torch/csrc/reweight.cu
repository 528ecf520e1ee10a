// Kernels B1 and B4: AMCL likelihood-field weights, exact through the code
// table (B1) or through the bf16 value table of codebook16 mode (B4), each
// in two modes: the pz^3 sum of the likelihood-field model and, with
// log_space, the log-probability sum of nav2's likelihood_field_prob model.
//
// B1 replaces beluga_tpu/ops/pallas_reweight.py:fused_reweight on its exact
// path (values3=None, log_space False or True); B4 replaces the same
// function's values3= path (build_values3 makes its table, of bf16(pz^3) or,
// with log_space, of bf16(log pz)).  For every filter f and particle i:
//
//   x_b = px_b*cos_i - py_b*sin_i + tx_i,   y_b = px_b*sin_i + py_b*cos_i + ty_i
//   cell = (floor(x_b / res), floor(y_b / res))
//   pz = codebook[codes[cell]] inside the map, unknown_prob outside
//   B1: c_b = pz^3, or log(pz) in log space
//   B4: c_b = float(values3[cell]) inside the map; unknown^3, or log(unknown)
//       in log space, outside
//   w_i  = base + sum over f's unmasked beams b (in order b = 0..B-1) of c_b,
//          base 1 (the nav2 seed of 1 + sum pz^3), or 0 in log space
//
// Both take the cell through one device function, so B4's cells are B1's.
// B4 has none of the TPU path's windows, floor clamp or exact fallback: on
// this card every in-map query reads its own table entry, so it is the
// "bf16(pz^3)-table reference" everywhere: an entry may be off by 2^-8
// relative (bf16 keeps 8 significant bits), the weights by less.
//
// What bounds them on an H100: per particle they read 16 B (tx, ty, cos,
// sin) and write 4 B, and the table (H*W bytes for B1's codes, 2*H*W for
// B4's bf16 values; 147 KB / 295 KB for a 384x384 map) once: the bytes set
// the floor.  The ~13 float32 operations per unmasked beam give a floor
// almost as high, and each beam's table read depends on its transform and
// division, so latency, not either floor, sets the time of this simple
// form.  Design: one thread per particle, the filter in blockIdx.y, that
// filter's beam endpoints (and B1's codebook) in shared memory (every
// thread reads the same beam at the same time, a broadcast), the table
// through the read-only path (it stays in L2).  The log modes add one logf
// per unmasked beam (B1) or none (B4, whose table holds the log): the same
// bounds.
//
// Cell exactness: floor(x / res) must match the plain PyTorch version bit
// for bit.  nvcc would contract a*b - c*d + e into FMAs, which can move a
// point across a cell edge, so the transform, the division and the cube
// are written with the round-to-nearest intrinsics, which are never
// contracted.  logf is CUDA's accurate logf, the function PyTorch's log
// calls on the card, so a single-beam weight equals the plain version's.
// The beam sum runs in order in float32; it differs from a parallel sum
// only in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Row-major offset y*w + x of one beam endpoint's cell, or -1 off the map.
__device__ __forceinline__ int endpoint_cell(float px, float py, float c, float s, float x0,
                                             float y0, float res, int w, int h) {
  const float x = __fadd_rn(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)), x0);
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)), y0);
  const float fx = floorf(__fdiv_rn(x, res));
  const float fy = floorf(__fdiv_rn(y, res));
  if (fx >= 0.0f && fx < static_cast<float>(w) && fy >= 0.0f && fy < static_cast<float>(h)) {
    return static_cast<int>(fy) * w + static_cast<int>(fx);
  }
  return -1;
}

// Filter f's beams into shared memory: x, y and 1.0 for an unmasked beam.
__device__ __forceinline__ void load_beams(const float* __restrict__ points,
                                           const uint8_t* __restrict__ beam_mask, int nb,
                                           float* s_px, float* s_py, float* s_on) {
  const size_t f = blockIdx.y;
  points += f * 2 * nb;
  beam_mask += f * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    s_px[b] = points[2 * b];
    s_py[b] = points[2 * b + 1];
    s_on[b] = beam_mask[b] ? 1.0f : 0.0f;
  }
}

template <bool LogSpace>
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
  float* s_on = s_py + nb;        // [nb]
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_book[j] = codebook[j];
  load_beams(points, beam_mask, nb, s_px, s_py, s_on);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t p = static_cast<size_t>(blockIdx.y) * n + i;
  const float c = cs[p], s = sn[p], x0 = tx[p], y0 = ty[p];
  float acc = 0.0f;
  for (int b = 0; b < nb; ++b) {
    if (s_on[b] == 0.0f) continue;
    const int cell = endpoint_cell(s_px[b], s_py[b], c, s, x0, y0, res, w, h);
    float pz = unknown_prob;
    if (cell >= 0) {
      const int code = __ldg(codes + cell);
      pz = code < k ? s_book[code] : 0.0f;
    }
    acc = __fadd_rn(acc, LogSpace ? logf(pz) : __fmul_rn(__fmul_rn(pz, pz), pz));
  }
  out[p] = LogSpace ? acc : __fadd_rn(1.0f, acc);
}

template <bool LogSpace>
__global__ void reweight_values3_kernel(const uint16_t* __restrict__ values3, int h, int w,
                                        const float* __restrict__ tx,
                                        const float* __restrict__ ty,
                                        const float* __restrict__ cs,
                                        const float* __restrict__ sn, int n,
                                        const float* __restrict__ points,
                                        const uint8_t* __restrict__ beam_mask, int nb,
                                        float res, float unknown_prob,
                                        float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_px = smem;             // [nb]
  float* s_py = s_px + nb;        // [nb]
  float* s_on = s_py + nb;        // [nb]
  load_beams(points, beam_mask, nb, s_px, s_py, s_on);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t p = static_cast<size_t>(blockIdx.y) * n + i;
  const float c = cs[p], s = sn[p], x0 = tx[p], y0 = ty[p];
  const float unknown3 =
      LogSpace ? logf(unknown_prob) : __fmul_rn(__fmul_rn(unknown_prob, unknown_prob), unknown_prob);
  float acc = 0.0f;
  for (int b = 0; b < nb; ++b) {
    if (s_on[b] == 0.0f) continue;
    const int cell = endpoint_cell(s_px[b], s_py[b], c, s, x0, y0, res, w, h);
    // a bf16 is the high half of a float32: the widening is exact
    const float pz3 = cell >= 0 ? __uint_as_float(static_cast<uint32_t>(__ldg(values3 + cell)) << 16)
                                : unknown3;
    acc = __fadd_rn(acc, pz3);
  }
  out[p] = LogSpace ? acc : __fadd_rn(1.0f, acc);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <bool LogSpace>
int launch_reweight(const void* codes, int h, int w, const void* codebook, int k,
                    const void* tx, const void* ty, const void* cs, const void* sn, int n,
                    const void* points, const void* beam_mask, int nb, float res,
                    float unknown_prob, void* out, int batch, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(k) + 3 * static_cast<size_t>(nb));
  if (int err = set_smem(reinterpret_cast<const void*>(reweight_kernel<LogSpace>), smem)) {
    return err;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  reweight_kernel<LogSpace><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), h, w, static_cast<const float*>(codebook), k,
      static_cast<const float*>(tx), static_cast<const float*>(ty),
      static_cast<const float*>(cs), static_cast<const float*>(sn), n,
      static_cast<const float*>(points), static_cast<const uint8_t*>(beam_mask), nb, res,
      unknown_prob, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool LogSpace>
int launch_values3(const void* values3, int h, int w, const void* tx, const void* ty,
                   const void* cs, const void* sn, int n, const void* points,
                   const void* beam_mask, int nb, float res, float unknown_prob, void* out,
                   int batch, void* stream) {
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(nb);
  if (int err = set_smem(reinterpret_cast<const void*>(reweight_values3_kernel<LogSpace>),
                         smem)) {
    return err;
  }
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  reweight_values3_kernel<LogSpace><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(values3), h, w, static_cast<const float*>(tx),
      static_cast<const float*>(ty), static_cast<const float*>(cs),
      static_cast<const float*>(sn), n, static_cast<const float*>(points),
      static_cast<const uint8_t*>(beam_mask), nb, res, unknown_prob,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B1 over `batch` filters of n particles each, in log space when log_space
// is non-zero; launches on `stream` and returns cudaGetLastError() of the
// launch.
extern "C" int beluga_reweight(const void* codes, int h, int w, const void* codebook, int k,
                               const void* tx, const void* ty, const void* cs, const void* sn,
                               int n, const void* points, const void* beam_mask, int nb,
                               float res, float unknown_prob, void* out, int batch,
                               int log_space, void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (log_space) {
    return launch_reweight<true>(codes, h, w, codebook, k, tx, ty, cs, sn, n, points, beam_mask,
                                 nb, res, unknown_prob, out, batch, stream);
  }
  return launch_reweight<false>(codes, h, w, codebook, k, tx, ty, cs, sn, n, points, beam_mask,
                                nb, res, unknown_prob, out, batch, stream);
}

// B4 over `batch` filters: `values3` is the bf16 table [h, w] as raw bits.
extern "C" int beluga_reweight_values3(const void* values3, int h, int w, const void* tx,
                                       const void* ty, const void* cs, const void* sn, int n,
                                       const void* points, const void* beam_mask, int nb,
                                       float res, float unknown_prob, void* out, int batch,
                                       int log_space, void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (log_space) {
    return launch_values3<true>(values3, h, w, tx, ty, cs, sn, n, points, beam_mask, nb, res,
                                unknown_prob, out, batch, stream);
  }
  return launch_values3<false>(values3, h, w, tx, ty, cs, sn, n, points, beam_mask, nb, res,
                               unknown_prob, out, batch, stream);
}

// Kernel B2: resampling donor search and state copy.
//
// Replaces beluga_tpu/ops/pallas_resample.py:resample_take (its small,
// blocked, huge and pipelined variants are schedules for the TPU's VMEM;
// one kernel covers them here).  Input, for each of `batch` filters: a
// monotone CDF f32[N] (computed outside the kernel, as in JAX: cumsum,
// divide by the last entry, cummax, all per filter), positions f32[M], and
// the particle state as planes f32[D, N].  For every
// position q the donor is the first k with cdf[k] > u_q (searchsorted
// side='right'), so a zero-weight slot, whose interval is empty, is never
// chosen; row q of out f32[M, D] gets a bit-exact copy of the donor's D
// values.  A position at or above cdf[N-1] (the padding value 1.5, or any
// position when every weight is zero) selects nothing and gets a zero row.
//
// What bounds it on an H100: the bytes.  It must read M positions, the N
// CDF entries and D*N state values and write M*D values; the ~log2(N)
// search steps per position hit the same few CDF lines for neighbouring
// positions, which are sorted on the main path, so they stay in L1/L2.
// Design: one thread per position, the filter in blockIdx.y (a filter
// searches its own CDF only), a binary search over global memory through
// the read-only path, then D loads from the donor's column and one
// contiguous row store (a 16 B vector store when D == 4).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void resample_take_kernel(const float* __restrict__ cdf, int n,
                                     const float* __restrict__ positions, int m,
                                     const float* __restrict__ values, int d,
                                     float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  const size_t f = blockIdx.y;
  cdf += f * n;
  values += f * d * n;
  out += f * d * m;
  const float u = positions[f * m + q];
  // first k in [0, n] with cdf[k] > u
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = lo + half;
    const bool right = !(__ldg(cdf + mid) > u);
    lo = right ? mid + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  float* row = out + static_cast<size_t>(q) * d;
  if (d == 4) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lo < n) {
      v.x = __ldg(values + lo);
      v.y = __ldg(values + static_cast<size_t>(n) + lo);
      v.z = __ldg(values + 2 * static_cast<size_t>(n) + lo);
      v.w = __ldg(values + 3 * static_cast<size_t>(n) + lo);
    }
    *reinterpret_cast<float4*>(row) = v;
    return;
  }
  for (int j = 0; j < d; ++j) {
    row[j] = lo < n ? __ldg(values + static_cast<size_t>(j) * n + lo) : 0.0f;
  }
}

}  // namespace

// Launches on `stream` over `batch` filters; returns cudaGetLastError() of
// the launch.  `out` must be 16-byte aligned when d == 4 (PyTorch
// allocations are).
extern "C" int beluga_resample_take(const void* cdf, int n, const void* positions, int m,
                                    const void* values, int d, void* out, int batch,
                                    void* stream) {
  if (m == 0 || batch == 0) return 0;
  const dim3 grid((m + kThreads - 1) / kThreads, batch);
  resample_take_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cdf), n, static_cast<const float*>(positions), m,
      static_cast<const float*>(values), d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

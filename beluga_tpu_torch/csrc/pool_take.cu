// Kernel B3: row take from a small pool.
//
// Replaces beluga_tpu/ops/pallas_lookup.py:pallas_pool_take.  For every
// filter f and output slot i:
//
//   out[f, i, :] = pool[f, idx[f, i], :]   if 0 <= idx[f, i] < P
//                  0                       otherwise
//
// as bit-exact float32 copies.  The TPU kernel selects rows with a one-hot
// matrix product on the MXU (three bf16 planes summed back to float32),
// because a random row gather serializes there; an out-of-range index, like
// the reference's -1 padding, matches no one-hot row and gives a zero row.
//
// What bounds it on an H100: the bytes.  It must read n int32 indices and
// write n rows of C floats per filter; the pool (P <= 4096 rows of C <= 8
// floats, 32 KB at P = 4096, C = 2) is read through the read-only path and
// stays in L1/L2 after its first touch.  Design: one thread per output row,
// one vector store per row when the row allows it (a float2 for C = 2, the
// recovery pool's (x, y); float4s when C is a multiple of 4), a scalar loop
// otherwise.  The filter is blockIdx.y.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void pool_take_kernel(const float* __restrict__ pool, int p, int c,
                                 const int32_t* __restrict__ idx, int n, int vec,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t f = blockIdx.y;
  pool += f * static_cast<size_t>(p) * c;
  const int r = idx[f * n + i];
  const bool ok = r >= 0 && r < p;
  float* row = out + (f * n + i) * static_cast<size_t>(c);
  const float* src = pool + static_cast<size_t>(ok ? r : 0) * c;
  if (vec && c == 2) {
    float2 v = make_float2(0.0f, 0.0f);
    if (ok) v = __ldg(reinterpret_cast<const float2*>(src));
    *reinterpret_cast<float2*>(row) = v;
  } else if (vec && c % 4 == 0) {
    for (int j = 0; j < c; j += 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok) v = __ldg(reinterpret_cast<const float4*>(src + j));
      *reinterpret_cast<float4*>(row + j) = v;
    }
  } else {
    for (int j = 0; j < c; ++j) row[j] = ok ? __ldg(src + j) : 0.0f;
  }
}

}  // namespace

// Launches on `stream` over `batch` filters; returns cudaGetLastError() of
// the launch.  The vector path is taken only when both base pointers are
// 16-byte aligned (fresh PyTorch allocations are).
extern "C" int beluga_pool_take(const void* pool, int p, int c, const void* idx, int n,
                                int batch, void* out, void* stream) {
  if (n == 0 || batch == 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(pool) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  pool_take_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pool), p, c, static_cast<const int32_t*>(idx), n, vec,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

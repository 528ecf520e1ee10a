// Kernel B10: the NDT cell probe.
//
// Replaces beluga_tpu/ops/pallas_ndt.py:ndt_probe.  For every query q[i]
// (an encoded cell key, uint32) and the sorted keys of the map's live
// cells keys[0, m):
//
//   j        = the first index with keys[j] >= q[i]   (lower bound)
//   found[i] = j < m && keys[j] == q[i]
//   out[i,:] = found[i] ? values[j, 0:p] : 0          (p = D + D*D floats:
//                                                      the cell's mean, then
//                                                      its covariance)
//
// as bit-exact float32 copies.  The TPU kernel matches every query against
// every key at once (a [M, C] one-hot compare) and fetches the values with
// a matrix product of bf16 hi/lo planes, because a binary search and a row
// gather serialize there.  The contract kept here: an exact key match, the
// map's float32 values, zeros and found = 0 where nothing matches.  Keys
// are compared as unsigned 32-bit integers: 2D keys carry x + 32768 in
// their top 16 bits, so most live keys are >= 2^31.
//
// What bounds it on an H100: the bytes.  It must read one 4-byte query and
// write p floats and one flag per query (4 + 4p + 1 bytes), plus the table
// once.  Design: a grid-stride loop of one thread per query over a grid of
// at most kMaxBlocks blocks, so that each block stages the m keys in shared
// memory once (4m bytes: 1.1 KB for the 2D arena map, 4 KB for the 3D one)
// and amortizes that over many queries; a binary search of ceil(log2(m+1))
// steps in shared memory; then p loads of one table row through the
// read-only path (the table, m rows of 24 or 48 bytes, stays in L1/L2).
// Tables of more than kMaxSharedKeys keys are searched in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxSharedKeys = 12288;  // 48 KB of static shared memory

template <bool kShared>
__global__ void ndt_probe_kernel(const uint32_t* __restrict__ keys, int m,
                                 const float* __restrict__ values, int p,
                                 const uint32_t* __restrict__ queries, long long n,
                                 float* __restrict__ out, uint8_t* __restrict__ found) {
  __shared__ uint32_t s_keys[kShared ? kMaxSharedKeys : 1];
  if (kShared) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) s_keys[j] = keys[j];
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t q = queries[i];
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const uint32_t k = kShared ? s_keys[mid] : __ldg(keys + mid);
      if (k < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const bool hit = lo < m && (kShared ? s_keys[lo] : __ldg(keys + lo)) == q;
    float* row = out + i * p;
    const float* src = values + static_cast<size_t>(hit ? lo : 0) * p;
    for (int j = 0; j < p; ++j) row[j] = hit ? __ldg(src + j) : 0.0f;
    found[i] = hit ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.  `m` is
// the number of live (sorted) keys, `values` the row-major [>= m, p] table.
extern "C" int beluga_ndt_probe(const void* keys, int m, const void* values, int p,
                                const void* queries, long long n, void* out, void* found,
                                void* stream) {
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* v = static_cast<const float*>(values);
  const auto* q = static_cast<const uint32_t*>(queries);
  auto* o = static_cast<float*>(out);
  auto* f = static_cast<uint8_t*>(found);
  if (m <= kMaxSharedKeys) {
    ndt_probe_kernel<true><<<static_cast<int>(blocks), kThreads, 0, s>>>(k, m, v, p, q, n, o, f);
  } else {
    ndt_probe_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(k, m, v, p, q, n, o, f);
  }
  return static_cast<int>(cudaGetLastError());
}

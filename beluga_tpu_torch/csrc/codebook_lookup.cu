// Kernel B11: the code-table lookup of the 3D distance volume.
//
// Replaces beluga_tpu/ops/pallas_lookup.py:pallas_codebook_lookup.  For
// every query i, with codes the uint8 [h, w] table (the volume flattened to
// [H, D*W], column z*W + x, maps/voxel.py:make_distance_codes) and book the
// float32 codebook of k <= 256 entries:
//
//   c      = codes[clip(yi[i], 0, h-1), clip(xi[i], 0, w-1)]
//   out[i] = c < k ? book[c] : 0
//
// bit-exact: the value is a copy of a codebook entry.  The TPU kernel
// selects the row with a one-hot matrix product (int8 codes on the MXU),
// the column with a compare and the book entry with another, all in VMEM,
// because random gathers serialize there; here each is an ordinary load.
//
// What bounds it on an H100: the bytes.  It must read two int32 indices and
// write one float per query (12 bytes), plus the table and the book once.
// Design: the book (1 KB) always sits in shared memory; the code table too
// when it fits (the bench volume's 49 x 1029 = 50 KB, as dynamic shared
// memory above 48 KB), else it is read from global memory through the
// read-only path, where a table of a few MB stays in the 50 MB L2 (the
// 200 x 200 x 50 building floor: 2 MB).  A grid-stride loop of one thread
// per query over a grid of a few blocks per SM lets each block stage the
// table once and spend it on many queries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBookBytes = 256 * 4;
constexpr int kMaxSharedBytes = 200 * 1024;  // of the 227 KB a block may use

template <bool kShared>
__global__ void codebook_lookup_kernel(const uint8_t* __restrict__ codes, int h, int w,
                                       const float* __restrict__ book, int k,
                                       const int32_t* __restrict__ yi,
                                       const int32_t* __restrict__ xi, long long n,
                                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_book = reinterpret_cast<float*>(smem);
  uint8_t* s_codes = smem + kBookBytes;
  for (int j = threadIdx.x; j < 256; j += blockDim.x) s_book[j] = j < k ? book[j] : 0.0f;
  if (kShared) {
    const long long bytes = static_cast<long long>(h) * w;
    const long long vecs = bytes / 16;  // codes and s_codes are 16-byte aligned
    const uint4* src = reinterpret_cast<const uint4*>(codes);
    uint4* dst = reinterpret_cast<uint4*>(s_codes);
    for (long long j = threadIdx.x; j < vecs; j += blockDim.x) dst[j] = __ldg(src + j);
    for (long long j = vecs * 16 + threadIdx.x; j < bytes; j += blockDim.x) {
      s_codes[j] = codes[j];
    }
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int y = min(max(yi[i], 0), h - 1);
    const int x = min(max(xi[i], 0), w - 1);
    const long long cell = static_cast<long long>(y) * w + x;
    const int c = kShared ? s_codes[cell] : __ldg(codes + cell);
    out[i] = c < k ? s_book[c] : 0.0f;
  }
}

int g_blocks_per_launch = 0;

}  // namespace

// Launches on `stream`; returns the first CUDA error of the set-up or the
// launch.  `codes` must be 16-byte aligned.
extern "C" int beluga_codebook_lookup(const void* codes, int h, int w, const void* book, int k,
                                      const void* yi, const void* xi, long long n, void* out,
                                      void* stream) {
  if (n == 0) return 0;
  if (g_blocks_per_launch == 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_blocks_per_launch = 4 * sms;
  }
  const long long table = static_cast<long long>(h) * w;
  const bool shared = kBookBytes + table <= kMaxSharedBytes;
  const int smem = kBookBytes + (shared ? static_cast<int>((table + 15) / 16 * 16) : 0);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > g_blocks_per_launch) blocks = g_blocks_per_launch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* b = static_cast<const float*>(book);
  const auto* y = static_cast<const int32_t*>(yi);
  const auto* x = static_cast<const int32_t*>(xi);
  auto* o = static_cast<float*>(out);
  if (shared) {
    cudaError_t err = cudaFuncSetAttribute(codebook_lookup_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    codebook_lookup_kernel<true><<<static_cast<int>(blocks), kThreads, smem, s>>>(
        c, h, w, b, k, y, x, n, o);
  } else {
    codebook_lookup_kernel<false><<<static_cast<int>(blocks), kThreads, smem, s>>>(
        c, h, w, b, k, y, x, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

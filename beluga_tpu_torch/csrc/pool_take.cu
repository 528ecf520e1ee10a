// Kernel B3: row take from a small pool, and the whole pooled recovery draw.
//
// Replaces beluga_tpu/ops/pallas_lookup.py:pallas_pool_take.  The row entry
// (beluga_pool_take), for every filter f and output slot i:
//
//   out[f, i, :] = pool[f, idx[f, i], :]   if 0 <= idx[f, i] < P
//                  0                       otherwise
//
// as bit-exact float32 copies.  The TPU kernel selects rows with a one-hot
// matrix product on the MXU (three bf16 planes summed back to float32),
// because a random row gather serializes there; an out-of-range index, like
// the reference's -1 padding, matches no one-hot row and gives a zero row.
//
// The draw entry (beluga_pooled_free_cells) is the pooled recovery sampler's
// whole draw (beluga_tpu/core/random.py:97-134): the pool
// free_xy[cand[f, :]], then slot i takes pool row idx[f, i] as above, with
// rotation (cos theta, sin theta), written straight into the port's SE2
// layout (xy [.., n, 2] and the rotation [.., n, 2]).  A cand outside the
// rows of free_xy gives a zero pool row (it is never read).
//
// What bounds it on an H100: the bytes, filters * (24 n + 16 P) for the draw
// (an index, a heading, two float pairs a slot; a candidate and its row a
// pool entry) and filters * (n (4 + 4 C) + 4 P C) for the row take.
// Design (one kernel for both entries; the draw also writes the rotation):
// one thread a row, a block 256 rows of one filter (the grid is (chunks,
// filters)): the index, the pool entry through the read-only path (a
// filter's candidates, at most 4096 x 8 B, stay in L1; the rows they name
// in L2), one vector load and store a row where the row allows it (a float2
// for C = 2, float4s where C is a multiple of 4), a scalar loop otherwise,
// and for the draw sincosf and the rotation's pair, neighbouring threads on
// neighbouring rows.  Two designs of the draw measured slower (PERF.md,
// section 6): a filter's pool gathered into shared memory first, once a
// block, and four rows a thread with 16-byte loads and stores (faster only
// at the fleet's 64 pools).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPool = 4096;

// Where pool row j of filter f comes from: pool[f, j] for the row entry,
// free_xy[cand[f, j]] for the draw.
struct PoolSource {
  const float* rows;      // pool [filters, P, C] (row entry) or free_xy [rows_total, 2] (draw)
  long long rows_total;   // free_xy's rows (draw)
  const long long* cand;  // [filters, P] (draw)
  int p, c;
};

// Slot r's source row: pool row r, or null (a zero row) where r is outside
// [0, P) or, for the draw, its candidate outside free_xy's rows.
template <bool kDraw>
__device__ __forceinline__ const float* pool_row(const PoolSource& s, size_t f, int r) {
  if (static_cast<unsigned>(r) >= static_cast<unsigned>(s.p)) return nullptr;
  if (!kDraw) return s.rows + (f * s.p + r) * s.c;
  const long long k = __ldg(s.cand + f * s.p + r);
  return (k >= 0 && k < s.rows_total) ? s.rows + k * 2 : nullptr;
}

// Row blockIdx.x * kThreads + threadIdx.x of filter blockIdx.y; the draw
// (kDraw: rows of free_xy through cand, C = 2) also writes (cos theta,
// sin theta) to z.
template <bool kDraw>
__global__ void __launch_bounds__(kThreads) pool_take_kernel(
    PoolSource src, const int32_t* __restrict__ idx, const float* __restrict__ theta, int n,
    int vec, float* __restrict__ out, float2* __restrict__ z) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t f = blockIdx.y;
  const size_t slot = f * n + i;
  const int c = kDraw ? 2 : src.c;
  const float heading = kDraw ? __ldg(theta + slot) : 0.0f;  // in flight with the row's chain
  const float* row = pool_row<kDraw>(src, f, __ldg(idx + slot));
  float* dst = out + slot * c;
  if (vec && c == 2) {
    float2 v = make_float2(0.0f, 0.0f);
    if (row) v = __ldg(reinterpret_cast<const float2*>(row));
    *reinterpret_cast<float2*>(dst) = v;
  } else if (vec && c % 4 == 0) {
    for (int j = 0; j < c; j += 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row) v = __ldg(reinterpret_cast<const float4*>(row + j));
      *reinterpret_cast<float4*>(dst + j) = v;
    }
  } else {
    for (int j = 0; j < c; ++j) dst[j] = row ? __ldg(row + j) : 0.0f;
  }
  if (kDraw) {
    float s, co;
    sincosf(heading, &s, &co);
    z[slot] = make_float2(co, s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The vector path is taken only when both base pointers are 16-byte
// aligned (fresh PyTorch allocations are).
template <bool kDraw>
int launch(const PoolSource& src, const int32_t* idx, const float* theta, int n, int batch,
           float* out, float2* z, void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (src.p > kMaxPool) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(src.rows) && aligned16(out);
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  pool_take_kernel<kDraw><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, idx, theta, n, vec, out, z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The row entry: `out` [batch, n, c] from `pool` [batch, p, c] and `idx`
// [batch, n] int32, on `stream`; returns cudaGetLastError() of the launch.
extern "C" int beluga_pool_take(const void* pool, int p, int c, const void* idx, int n,
                                int batch, void* out, void* stream) {
  const PoolSource src{static_cast<const float*>(pool), 0, nullptr, p, c};
  return launch<false>(src, static_cast<const int32_t*>(idx), nullptr, n, batch,
                       static_cast<float*>(out), nullptr, stream);
}

// The draw entry: `xy` and `z` [batch, n, 2] from `free_xy` [rows, 2],
// `cand` [batch, p] int64, `idx` [batch, n] int32 and `theta` [batch, n];
// returns cudaGetLastError() of the launch.  `z` must be 8-byte aligned.
extern "C" int beluga_pooled_free_cells(const void* free_xy, long long rows, const void* cand,
                                        int p, const void* idx, const void* theta, int n,
                                        int batch, void* xy, void* z, void* stream) {
  const PoolSource src{static_cast<const float*>(free_xy), rows,
                       static_cast<const long long*>(cand), p, 2};
  return launch<true>(src, static_cast<const int32_t*>(idx), static_cast<const float*>(theta),
                      n, batch, static_cast<float*>(xy), static_cast<float2*>(z), stream);
}

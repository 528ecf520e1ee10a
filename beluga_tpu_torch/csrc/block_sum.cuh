// The block-wide sum of kernels E1 (estimate.cu) and S1 (sort_slots.cu):
// each of K values summed over a block of kWarps warps in a fixed order, so
// that a call gives the same bits every run and every thread the same bits.

#pragma once

// Sums each of the K values over the block; every thread gets the sums,
// the same bits in each (a butterfly within the warps, then the warps'
// sums added in warp order).  `shared` holds kWarps * K values.
template <int kWarps, int K, typename T>
__device__ __forceinline__ void block_sum(T (&v)[K], T* shared) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) shared[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T s = shared[k];
    for (int j = 1; j < kWarps; ++j) s += shared[j * K + k];
    v[k] = s;
  }
  __syncthreads();  // the next call may reuse `shared`
}

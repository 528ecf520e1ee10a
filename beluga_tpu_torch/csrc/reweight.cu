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
//   pz = codebook[codes[cell]] inside the map (0 for a code >= K),
//        unknown_prob outside
//   B1: c_b = pz^3, or log(pz) in log space
//   B4: c_b = float(values3[cell]) inside the map; unknown^3, or log(unknown)
//       in log space, outside
//   w_i  = base + sum over f's unmasked beams b of c_b,
//          base 1 (the nav2 seed of 1 + sum pz^3), or 0 in log space
//
// Two entries: the particle's field-frame transform (tx, ty, cos, sin)
// given, as the Pallas function takes it, or the particle states as they
// lie (xy [.., n, 2], rot [.., n, 2]) with world_to_field's four floats on
// the device, composed in the prologue in lie.py's order (SE2 @ SE2: xy +
// rot.act(xy'), then rot @ rot'), so that the update runs no PyTorch
// operation between the states and this kernel.
//
// B4 has none of the TPU path's windows, floor clamp or exact fallback: on
// this card every in-map query reads its own table entry, so it is the
// "bf16(pz^3)-table reference" everywhere: an entry may be off by 2^-8
// relative (bf16 keeps 8 significant bits), the weights by less.
//
// What bounds them on an H100: per particle they read 16 B and write 4 B,
// and the table (H*W bytes for B1's codes, 2*H*W for B4's bf16 values;
// 147 KB / 295 KB for a 384x384 map) once: the bytes set the floor.  The
// ~13 float32 operations per unmasked beam give a floor almost as high.
// What the simple form (one thread per particle, a 60-beam loop) met
// instead was latency and issue slots: 8 blocks on 132 SMs at the node's
// 2000 particles, a mask branch and two IEEE divisions per beam, a cube or
// logf per beam.  Design:
//   - G lanes per particle (a power of two, chosen per shape: the fewest
//     that give every SM 1024 threads, at most 16, at least 2 beams a
//     lane), each taking a strided subset of the unmasked beams, added by
//     a fixed __shfl_xor_sync tree: no atomics, so a launch repeats bit for
//     bit;
//   - the filter's unmasked beams compacted, in beam order, into shared
//     memory in the block's prologue (ballots): the beam loop has no mask
//     branch;
//   - B1's 256 decoded values (pz^3 or logf(pz), with the same intrinsics)
//     in shared memory, so the beam loop does no cube and no logf;
//   - the tables through the read-only path (L1 and L2).  B1's code table
//     in shared memory (a persistent grid of 1024-thread blocks, the copy
//     by cp.async, rows padded against bank conflicts) measured 13% slower
//     at 262144 particles (PERF.md, section 6) and is not kept;
//   - the cell as floor(x * RN(1/res)) by one F2I wherever both products
//     lie farther from an integer than 2^-21 of the map's extent in cells
//     (then they floor as the IEEE quotients do: the two differ by less
//     than 4 ulps), the IEEE divisions only near a cell edge.
//
// Cell exactness: floor(x / res) must match the plain PyTorch version bit
// for bit.  nvcc would contract a*b - c*d + e into FMAs, which can move a
// point across a cell edge, so the transforms, the division and the cube
// are written with the round-to-nearest intrinsics, which are never
// contracted.  logf is CUDA's accurate logf, the function PyTorch's log
// calls on the card, so a single-beam weight equals the plain version's.
// The beam sum runs in float32 in another order than the plain version's;
// it differs from it only in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCodes = 256;           // uint8 codes: B1's decoded values
constexpr int kMaxLanesLog2 = 4;      // at most 16 lanes a particle
constexpr int kMinBeamsPerLane = 2;
constexpr int kFillThreads = 1024;    // an SM's threads the lanes rule aims to fill
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kBeamsOffset = kCodes * sizeof(float) + 32 * sizeof(int);
constexpr float kEdgeTol = 4.76837158203125e-07f;  // 2^-21

struct Args {
  const void* table;  // uint8 codes [h, w] (B1) or bf16 bits [h, w] (B4)
  int h, w;
  const float* codebook;  // [k], B1
  int k;
  // transform entry: tx, ty, cos, sin [.., n]; states entry: xy [.., n, 2],
  // rot [.., n, 2], world_to_field's xy [2] and rot [2]
  const float* p0;
  const float* p1;
  const float* p2;
  const float* p3;
  int n;
  const float* points;       // [.., nb, 2]
  const uint8_t* beam_mask;  // [.., nb]
  int nb;
  float res, unknown_prob;
  float* out;
  int lanes_log2;  // G = 2^lanes_log2 lanes a particle
};

template <bool kLog>
__device__ __forceinline__ float decode(float pz) {
  return kLog ? logf(pz) : __fmul_rn(__fmul_rn(pz, pz), pz);
}

// Whether an endpoint lies on the map, and its cell (row, col), with col =
// floor(x / res) and row = floor(y / res) bit for bit.  q = RN(v *
// RN(1/res)) lies within 4 ulps (of q) of RN(v / res), so the two floor
// alike unless an integer lies that close to q.  `tol` is 2^-21 (8 ulps'
// worth) of the largest |q| whose floor can land on the map, so where both
// quotients lie farther than `tol` from an integer the floors agree, and
// an endpoint the fast path puts off the map is off it either way (the
// sign of q is that of v / res; past w + 1 both floor beyond the map).
// Near an edge, and for NaN or |q| >= 2^23, the IEEE divisions decide.
__device__ __forceinline__ bool endpoint_cell(float x, float y, float inv_res, float res,
                                              float tol, int w, int h, int* row, int* col) {
  const float qx = __fmul_rn(x, inv_res), qy = __fmul_rn(y, inv_res);
  if (fabsf(__fsub_rn(qx, rintf(qx))) > tol && fabsf(__fsub_rn(qy, rintf(qy))) > tol) {
    *col = __float2int_rd(qx);
    *row = __float2int_rd(qy);
    return static_cast<unsigned>(*col) < static_cast<unsigned>(w) &&
           static_cast<unsigned>(*row) < static_cast<unsigned>(h);
  }
  const float fx = floorf(__fdiv_rn(x, res)), fy = floorf(__fdiv_rn(y, res));
  *col = static_cast<int>(fx);
  *row = static_cast<int>(fy);
  return fx >= 0.0f && fx < static_cast<float>(w) && fy >= 0.0f && fy < static_cast<float>(h);
}

// Filter f's unmasked beams, in beam order, into s_beam (every warp's ballot
// then a prefix over the warps' counts); returns their number.
__device__ int compact_beams(const float* __restrict__ points,
                             const uint8_t* __restrict__ mask, int nb, float2* s_beam,
                             int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int total = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    const int b = base + threadIdx.x;
    const bool on = b < nb && mask[b];
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = total, chunk = 0;
    for (int v = 0; v < warps; ++v) {
      before += v < warp ? s_warp[v] : 0;
      chunk += s_warp[v];
    }
    if (on) {
      s_beam[before + __popc(ballot & ((1u << lane) - 1u))] =
          make_float2(points[2 * b], points[2 * b + 1]);
    }
    total += chunk;
    __syncthreads();
  }
  __syncthreads();  // with no beams, still publishes what the prologue wrote
  return total;
}

// Particle p's field-frame transform: read (transform entry), or composed
// from its state and world_to_field in lie.py's operation order.
// `field` is world_to_field's (x, y, cos, sin).
// The states' pairs are read as float2 where both arrays are 8-byte
// aligned (`paired`), else as two floats.
template <bool kStates>
__device__ __forceinline__ void particle_pose(const Args& a, float4 field, bool paired,
                                              size_t p, float* x0, float* y0, float* c,
                                              float* s) {
  if (kStates) {
    float2 xy, rot;
    if (paired) {
      xy = __ldg(reinterpret_cast<const float2*>(a.p0) + p);
      rot = __ldg(reinterpret_cast<const float2*>(a.p1) + p);
    } else {
      xy = make_float2(__ldg(a.p0 + 2 * p), __ldg(a.p0 + 2 * p + 1));
      rot = make_float2(__ldg(a.p1 + 2 * p), __ldg(a.p1 + 2 * p + 1));
    }
    const float sx = xy.x, sy = xy.y, sc = rot.x, ss = rot.y;
    const float wx = field.x, wy = field.y, wc = field.z, ws = field.w;
    *x0 = __fadd_rn(wx, __fsub_rn(__fmul_rn(wc, sx), __fmul_rn(ws, sy)));
    *y0 = __fadd_rn(wy, __fadd_rn(__fmul_rn(ws, sx), __fmul_rn(wc, sy)));
    *c = __fsub_rn(__fmul_rn(wc, sc), __fmul_rn(ws, ss));
    *s = __fadd_rn(__fmul_rn(ws, sc), __fmul_rn(wc, ss));
  } else {
    *x0 = __ldg(a.p0 + p);
    *y0 = __ldg(a.p1 + p);
    *c = __ldg(a.p2 + p);
    *s = __ldg(a.p3 + p);
  }
}

// Block (x, f) scores particles x * blockDim / G, ... of filter f, G lanes
// a particle.
template <bool kValues3, bool kLog, bool kStates>
__device__ __forceinline__ void reweight_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_val = reinterpret_cast<float*>(smem);                        // [kCodes]
  int* s_warp = reinterpret_cast<int*>(smem + kCodes * sizeof(float));  // [32]
  float2* s_beam = reinterpret_cast<float2*>(smem + kBeamsOffset);      // [nb]
  const size_t f = blockIdx.y;
  if (!kValues3) {
    for (int j = threadIdx.x; j < kCodes; j += blockDim.x) {
      s_val[j] = decode<kLog>(j < a.k ? a.codebook[j] : 0.0f);
    }
  }
  const int live = compact_beams(a.points + 2 * f * a.nb, a.beam_mask + f * a.nb, a.nb, s_beam,
                                 s_warp);
  const int lanes = 1 << a.lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int i = blockIdx.x * (blockDim.x >> a.lanes_log2) + (threadIdx.x >> a.lanes_log2);
  const bool valid = i < a.n;  // alike for a particle's lanes
  const size_t p = f * a.n + i;
  float acc = 0.0f;
  if (valid) {
    const float inv_res = __frcp_rn(a.res);
    const float tol = __fmul_rn(static_cast<float>((a.w > a.h ? a.w : a.h) + 1), kEdgeTol);
    const float off_map = decode<kLog>(a.unknown_prob);
    const float4 field = kStates ? make_float4(__ldg(a.p2), __ldg(a.p2 + 1), __ldg(a.p3),
                                               __ldg(a.p3 + 1))
                                 : make_float4(0.0f, 0.0f, 1.0f, 0.0f);
    const bool paired = ((reinterpret_cast<uintptr_t>(a.p0) | reinterpret_cast<uintptr_t>(a.p1)) &
                         7) == 0;
    float x0, y0, c, s;
    particle_pose<kStates>(a, field, paired, p, &x0, &y0, &c, &s);
#pragma unroll 4
    for (int j = lane; j < live; j += lanes) {
      const float2 pt = s_beam[j];
      const float x = __fadd_rn(__fsub_rn(__fmul_rn(pt.x, c), __fmul_rn(pt.y, s)), x0);
      const float y = __fadd_rn(__fadd_rn(__fmul_rn(pt.x, s), __fmul_rn(pt.y, c)), y0);
      int row, col;
      float v = off_map;
      if (endpoint_cell(x, y, inv_res, a.res, tol, a.w, a.h, &row, &col)) {
        const int cell = row * a.w + col;
        if (kValues3) {
          // a bf16 is the high half of a float32: the widening is exact
          v = __uint_as_float(
              static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(a.table) + cell)) << 16);
        } else {
          v = s_val[__ldg(static_cast<const uint8_t*>(a.table) + cell)];
        }
      }
      acc = __fadd_rn(acc, v);
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (valid && lane == 0) a.out[p] = kLog ? acc : __fadd_rn(1.0f, acc);
}

template <bool kLog, bool kStates>
__global__ void __launch_bounds__(kThreads) reweight_kernel(const Args a) {
  reweight_body<false, kLog, kStates>(a);
}

template <bool kLog, bool kStates>
__global__ void __launch_bounds__(kThreads) reweight_values3_kernel(const Args a) {
  reweight_body<true, kLog, kStates>(a);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  }
  return count > 0 ? count : 1;
}

// The fewest lanes a particle (a power of two) that give every SM
// kFillThreads threads, with at least kMinBeamsPerLane beams a lane.
int lanes_log2_for(long long particles, int nb) {
  const long long fill = static_cast<long long>(sm_count()) * kFillThreads;
  int g = 0;
  while (g < kMaxLanesLog2 && (particles << g) < fill && (2 << g) * kMinBeamsPerLane <= nb) ++g;
  return g;
}

using Kernel = void (*)(Args);

// Launches kKernel over `batch` filters of particle tiles, a block each.
template <Kernel kKernel>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = kBeamsOffset + 8 * static_cast<size_t>(a.nb);
  static bool configured = false;  // per kernel
  if (smem > 48 * 1024 && !configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int per_block = kThreads >> a.lanes_log2;
  const dim3 grid((a.n + per_block - 1) / per_block, batch);
  kKernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLog, bool kStates>
int dispatch(const Args& a, int batch, bool values3, cudaStream_t stream) {
  if (values3) return launch<reweight_values3_kernel<kLog, kStates>>(a, batch, stream);
  return launch<reweight_kernel<kLog, kStates>>(a, batch, stream);
}

}  // namespace

// B1 (values3 = 0: `table` the uint8 codes, `codebook` its K floats) or B4
// (values3 != 0: `table` the bf16 table [h, w] as raw bits) over `batch`
// filters of n particles each, in log space when log_space is non-zero.
// With states = 0, p0..p3 are tx, ty, cos, sin [batch, n]; with states !=
// 0, p0 and p1 the states' xy and rot [batch, n, 2] and p2 and p3
// world_to_field's xy and rot [2] on the device.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int beluga_reweight(const void* table, int values3, int h, int w,
                               const void* codebook, int k, const void* p0, const void* p1,
                               const void* p2, const void* p3, int states, int n,
                               const void* points, const void* beam_mask, int nb, float res,
                               float unknown_prob, void* out, int batch, int log_space,
                               void* stream) {
  if (n == 0 || batch == 0) return 0;
  Args a{};
  a.table = table;
  a.h = h;
  a.w = w;
  a.codebook = static_cast<const float*>(codebook);
  a.k = k;
  a.p0 = static_cast<const float*>(p0);
  a.p1 = static_cast<const float*>(p1);
  a.p2 = static_cast<const float*>(p2);
  a.p3 = static_cast<const float*>(p3);
  a.n = n;
  a.points = static_cast<const float*>(points);
  a.beam_mask = static_cast<const uint8_t*>(beam_mask);
  a.nb = nb;
  a.res = res;
  a.unknown_prob = unknown_prob;
  a.out = static_cast<float*>(out);
  a.lanes_log2 = lanes_log2_for(static_cast<long long>(n) * batch, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v3 = values3 != 0;
  if (log_space) {
    return states ? dispatch<true, true>(a, batch, v3, s) : dispatch<true, false>(a, batch, v3, s);
  }
  return states ? dispatch<false, true>(a, batch, v3, s) : dispatch<false, false>(a, batch, v3, s);
}
